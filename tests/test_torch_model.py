"""The port's model against ``repro.models.model.forward`` on the same
weights: the bridge is bit-exact, and prefill logits plus 8 teacher-forced
decode steps agree, for yi-9b (MHA at reduced width), a GQA variant of it at
head_dim 128, qwen-72b (QKV bias), and yi-9b with the plain GELU MLP.

Norm gammas and QKV biases are zero at init, which would leave the (1 +
gamma) scale and the bias adds untested, so they are overwritten with seeded
nonzero values on both sides first.

Tolerance: atol = rtol = 5e-2 on fp32 logits of magnitude ~1.  Both sides
run bf16 activations and round them at different places (the matmul
accumulation order, silu, the rope cast), and one bf16 ulp at |x| ~ 1 is
4e-3; a few ulps through two layers and the fp32 head land in the 1e-2
range.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401
from repro import compat
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import SamplingConfig as JSamplingConfig
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.runtime import kvcache
from repro.runtime.engine import Engine as JEngine
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.models import model as TM
from repro_torch.models.common import Dist
from repro_torch.runtime.engine import Engine

TOL = 5e-2
GQA = dict(n_heads=8, n_kv_heads=2, head_dim=128)
CONFIGS = {
    "yi-9b": ("yi-9b", {}),
    "yi-9b-gqa": ("yi-9b", GQA),
    "qwen-72b": ("qwen-72b", {}),
    # the plain (ungated) GELU MLP, which no registered dense arch uses
    "yi-9b-gelu": ("yi-9b", dict(gated_mlp=False, act="gelu")),
}


def make_configs(name):
    arch, over = CONFIGS[name]
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def jax_engine(cfg, max_len, use_pallas=False, weight_quant="none", **parallel_kw):
    """A JAX engine whose zero-initialised gammas and biases are replaced by
    seeded nonzero values.  Returns (engine, numpy param tree)."""
    eng = JEngine(cfg=cfg, parallel=JParallelConfig(tp=1, dp=1, remat=False,
                                                   use_pallas=use_pallas,
                                                   weight_quant=weight_quant, **parallel_kw),
                  sampling=JSamplingConfig(greedy=True, top_k=1),
                  mesh=make_local_mesh(1, 1), max_len=max_len)
    tree = jax.tree.map(np.asarray, eng.params)
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(k in name for k in ("norm", "'b_q'", "'b_k'", "'b_v'")):
            return (rng.standard_normal(leaf.shape) * 0.2).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    eng.params = jax.tree.map(jnp.asarray, tree)
    return eng, tree


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    jcfg, tcfg = make_configs(request.param)
    eng, tree = jax_engine(jcfg, max_len=32)
    return eng, tree, tcfg, bridge.params_from_jax(tree, tcfg, device="cpu")


def test_bridge_is_bit_exact(pair):
    _, tree, cfg, params = pair
    group = tree["groups"][0]["sub0"]
    leaves = {"norm1": group["norm1"], "norm2": group["norm2"], **group["mixer"], **group["ffn"]}
    if cfg.qkv_bias:
        assert {"b_q", "b_k", "b_v"} <= set(leaves)
    bits = lambda t: t.view(torch.int16).numpy()
    for name, leaf in leaves.items():
        for i in range(cfg.n_layers):
            np.testing.assert_array_equal(bits(params["layers"][i][name]),
                                          leaf[i].view(np.int16), err_msg=name)
    np.testing.assert_array_equal(bits(params["embed"]["table"]), tree["embed"]["table"].view(np.int16))
    np.testing.assert_array_equal(bits(params["lm_head"]), tree["lm_head"].view(np.int16))
    np.testing.assert_array_equal(bits(params["final_norm"]), tree["final_norm"].view(np.int16))
    assert np.abs(tree["final_norm"].astype(np.float32)).max() > 0   # perturbed


def test_prefill_and_decode_logits_match_jax(pair):
    eng, _, cfg, params = pair
    assert_logits_match(eng, cfg, params)


def assert_logits_match(eng, cfg, params, kv_quant=False, plen=12, max_len=32,
                        port=lambda call: call()):
    """Prefill logits of a ``plen``-token prompt and 8 teacher-forced decode
    steps of the JAX engine's forward and the port's, on the same weights,
    within TOL; the port's cache holds ``max_len`` positions (a ring of
    the window, where the config has one, as the JAX engine's);
    ``kv_quant``: the port's cache is the int8 one (the JAX engine's
    follows its own ParallelConfig).  ``port`` runs each port forward
    (given as a call), after the JAX one of the same step."""
    ctx = eng.ctx
    b, steps = 2, 8
    pspecs = JM.param_specs(ctx)
    cspec = kvcache.cache_pspecs(ctx, kv_seq_shard=False)
    sm = partial(compat.shard_map, mesh=eng.mesh, check_vma=False)

    def pre(p, t, c):
        logits, c, _ = JM.forward(p, t, ctx, caches=c, seq_sharded=True)
        return logits, c

    def dec(p, t, c, cur):
        logits, c, _ = JM.forward(p, t[:, None], ctx, caches=c, cur_pos=cur)
        return logits[:, -1], c

    jpre = jax.jit(sm(pre, in_specs=(pspecs, P("data", None), cspec),
                      out_specs=(P("data", None, None), cspec)))
    jdec = jax.jit(sm(dec, in_specs=(pspecs, P("data"), cspec, P()),
                      out_specs=(P("data", None), cspec)))

    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)
    jl, jc = jpre(eng.params, jnp.asarray(prompts), eng.init_caches(b))
    tc = TM.init_caches(cfg, b, max_len, device="cpu", kv_quant=kv_quant)
    with torch.inference_mode():
        tl = port(lambda: TM.forward(params, torch.from_numpy(prompts).long(), cfg, caches=tc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)     # teacher-forced
    for step in range(steps):
        cur = plen + step
        jl, jc = jdec(eng.params, jnp.asarray(tok), jc, jnp.int32(cur))
        with torch.inference_mode():
            tl = port(lambda: TM.forward(params, torch.from_numpy(tok).long()[:, None], cfg,
                                         caches=tc, cur_pos=cur))[:, -1]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


def test_unsupported_features_raise_naming_them():
    cfg = dataclasses.replace(get_config("yi-9b").reduced(), window=64, n_codebooks=2,
                              tie_embeddings=True)
    with pytest.raises(NotImplementedError,
                       match=r"window.*wq_cache at tp>1.*tied embeddings.*multi-codebook") as err:
        TM.check_supported(cfg, ParallelConfig(tp=2, dp=2, weight_quant="int4",
                                               overlap_decode=True), wq_cache="x")
    assert "overlap_decode" not in str(err.value)
    # the int8 KV cache is served; tensor parallelism is served for every
    # family (dense, MoE, MLA, RG-LRU, SSD with its tied head, the frontend
    # and the multi-codebook head), int8 KV and int4 weights included
    kvq = ParallelConfig(kv_quant=True, weight_quant="int4")
    for arch in ("yi-9b", "deepseek-moe-16b", "mixtral-8x7b", "minicpm3-4b",
                 "recurrentgemma-9b", "mamba2-1.3b", "internvl2-26b", "musicgen-medium"):
        for tp in (1, 2, 4, 8):
            TM.check_supported(get_config(arch), dataclasses.replace(kvq, tp=tp))
    for arch in ("minicpm3-4b", "mamba2-1.3b", "internvl2-26b", "musicgen-medium"):
        Engine(get_config(arch).reduced(), parallel=dataclasses.replace(kvq, tp=2),
               device="cpu", dist=Dist(2, 0))
    # dp>1 is served, and so is the control plane at tp>1 and dp>1; what the
    # port does not serve at tp>1 yet (the packed weight file) is still
    # named and refused
    TM.check_supported(get_config("mamba2-1.3b"), dataclasses.replace(kvq, tp=2, dp=2))
    for par in (dataclasses.replace(kvq, tp=2, dp=2, overload_degrade=True),
                dataclasses.replace(kvq, tp=2, overlap_decode=True)):
        Engine(get_config("mamba2-1.3b").reduced(), parallel=par, device="cpu",
               dist=Dist(2, 0, dp=par.dp))
    for par, kw, name in ((dataclasses.replace(kvq, tp=2), {"wq_cache": "x"}, "wq_cache at tp>1"),
                          (dataclasses.replace(kvq, tp=2, overlap_decode=True),
                           {"wq_cache": "x"}, "wq_cache at tp>1")):
        with pytest.raises(NotImplementedError, match=name):
            Engine(get_config("mamba2-1.3b").reduced(), parallel=par, device="cpu",
                   dist=Dist(2, 0), **kw)
    # int8 and int4 weights are served; any other mode is named and refused
    with pytest.raises(NotImplementedError, match="weight_quant=int2"):
        Engine(get_config("yi-9b").reduced(), parallel=ParallelConfig(weight_quant="int2"),
               device="cpu")
    for mode in ("none", "int8", "int4"):
        TM.check_supported(get_config("yi-9b"), ParallelConfig(weight_quant=mode))


def test_cuda_default_raises_without_a_card():
    """Entry points default to the card; with none they raise rather than
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(get_config("yi-9b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(get_config("yi-9b").reduced())


def test_generate_checks_the_cache_length():
    eng = Engine(get_config("yi-9b").reduced(), max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 10), np.int32), 7)
    assert eng.generate(np.zeros((2, 10), np.int32), 6).shape == (2, 6)


def test_bridge_takes_an_unscanned_single_layer():
    """A one-layer model's group is not stacked in the JAX tree (``stack_defs``
    only runs for n > 1); the bridge adds the layer axis itself."""
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), n_layers=1)
    tcfg = dataclasses.replace(get_config("yi-9b").reduced(), n_layers=1)
    eng, tree = jax_engine(jcfg, max_len=16)
    assert tree["groups"][0]["sub0"]["norm1"].ndim == 1
    params = bridge.params_from_jax(tree, tcfg, device="cpu")
    assert len(params["layers"]) == 1
    np.testing.assert_array_equal(params["layers"][0]["w_q"].view(torch.int16).numpy(),
                                  tree["groups"][0]["sub0"]["mixer"]["w_q"].view(np.int16))
    with torch.inference_mode():
        logits = TM.forward(params, torch.zeros(1, 5, dtype=torch.long), tcfg)
    assert logits.shape == (1, 5, tcfg.vocab_size) and torch.isfinite(logits).all()
