"""The modality prefix and the multi-codebook head (internvl2-26b,
musicgen-medium) against the JAX package on the same weights: the configs,
their capability records and the ``--list-archs`` matrix; what
``check_supported`` lifts and what it still refuses; the bridge bit for
bit (the projector's leaves, the (ncb, V, d) table and the (ncb, d, V)
head, bf16 and int4); the weight bytes a decode token sweeps; the
projector on seeded non-zero features; the 4-codebook embedding sum bit
for bit; the (b, s, 4, V) head in bf16 and int4; the per-codebook greedy
sampling; the full forward behind a prefix of non-zero features, a
prefill and 8 teacher-forced decode steps, for both archs, in bf16 and
int4; and in int4 the greedy streams of ``generate``, the wave and the
continuous schedulers (tests/test_torch_multimodal_serve.py's checks).

Configs: ``.reduced()`` (2 layers, d 256, 4 heads of 64, vocab 512, a
frontend of 8 positions of 64 features; musicgen-medium's 4 codebooks and
plain GELU FFN), the reference built as tests/test_torch_model.py builds
it (its norm gammas, the projector's included, drawn nonzero), on its
pure-JAX path.

Tolerances: the embedding sum and the sampled frames exactly; the
projector, the head and the logits 5e-2, the bf16 tolerance of the parity
contract (values of magnitude ~1, bf16 activations rounded after sums in
different orders).
"""
import dataclasses
from functools import partial
from pathlib import Path

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
from repro.core import embedding as jemb
from repro.core.capabilities import render_text as jrender_text
from repro.models import model as JM
from repro.models import multimodal as jmm
from repro.models.common import Dist as JDist
from repro.models.common import ShardPlan as JShardPlan
from repro.runtime import kvcache as jkvcache
from repro.runtime.sampling import sample_tokens as jsample_tokens
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core import capabilities
from repro_torch.core.embedding import embed_lookup
from repro_torch.core.wquant import QuantWeight
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models import multimodal
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.sampling import sample_tokens
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from test_torch_model import jax_engine
from test_torch_multimodal_serve import (check_continuous_scheduler, check_generate,
                                         check_wave_scheduler)

ARCHS = ("internvl2-26b", "musicgen-medium")
TOL, MAX_LEN = 5e-2, 48
DOCS = Path(__file__).resolve().parents[1] / "docs" / "arch_capabilities.txt"

_ENGINES = {}


def engines(arch, mode="none"):
    """(JAX engine, its numpy tree, port params on the CPU) on the same
    weights; built once per module, arch and weight mode."""
    if (arch, mode) not in _ENGINES:
        jeng, tree = jax_engine(jget_config(arch).reduced(), MAX_LEN, weight_quant=mode)
        cfg = get_config(arch).reduced()
        _ENGINES[arch, mode] = jeng, tree, bridge.params_from_jax(tree, cfg, device="cpu")
    return _ENGINES[arch, mode]


def bits(t) -> np.ndarray:
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# -- configs, capabilities, refusals ------------------------------------------


def test_configs_capabilities_and_list_archs_match_jax(capsys):
    for arch in ARCHS:
        for t, j in ((get_config(arch), jget_config(arch)),
                     (get_config(arch).reduced(), jget_config(arch).reduced())):
            for f in dataclasses.fields(t):        # the JAX config has fields of its own too
                tv, jv = getattr(t, f.name), getattr(j, f.name)
                if dataclasses.is_dataclass(tv):
                    tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
                assert tv == jv, (arch, f.name)
            assert t.param_count() == j.param_count()
    assert get_config("internvl2-26b").param_count() == 19_860_664_320
    assert get_config("musicgen-medium").reduced().frontend.prefix_len == 8
    caps = capabilities.ArchCapabilities.from_config(get_config("musicgen-medium"))
    assert caps.sampling == "per-codebook" and caps.blockers == {
        p: "frontend" for p in ("chunked", "spec", "paged", "disagg")}
    # every row of the JAX registry's matrix is an arch the port serves
    text = capabilities.render_text()
    assert text == jrender_text() == DOCS.read_text().rstrip("\n")
    assert serve.main(["--list-archs"]) == []
    assert capsys.readouterr().out == text + "\n"


def test_check_supported_serves_tp1_and_refuses_by_name():
    for arch in ARCHS:
        cfg = get_config(arch)
        for mode in ("none", "int8", "int4"):
            for tp in (1, 2, 4, 8):     # the prefix and the codebook head at every tp
                TM.check_supported(cfg, ParallelConfig(tp=tp, weight_quant=mode, kv_quant=True))
        with pytest.raises(NotImplementedError, match="wq_cache with a frontend"):
            TM.check_supported(cfg, ParallelConfig(weight_quant="int4"), wq_cache="x")
        with pytest.raises(NotImplementedError, match="wq_cache at tp>1"):
            TM.check_supported(cfg, ParallelConfig(tp=2, weight_quant="int4"), wq_cache="x")
    with pytest.raises(NotImplementedError, match="wq_cache with a frontend"):
        Engine(get_config("internvl2-26b").reduced(),
               parallel=ParallelConfig(weight_quant="int4"), wq_cache="unused", device="cpu")


def test_blocked_paths_raise_the_capability_error_and_the_prefix_counts():
    """Paged, chunked and spec decode stay refused with the registry's own
    words (the CLI's default chunk and --spec-k fall back, as the JAX
    CLI's do); submit and generate count the prefix against max_len."""
    words = "does not support {}: blocked by the modality-prefix frontend"
    eng = Engine(get_config("musicgen-medium").reduced(), sampling=SamplingConfig(top_k=1),
                 max_len=32, device="cpu")
    with pytest.raises(ValueError, match=words.format("paged KV")):
        serve.main(["--device", "cpu", "--arch", "musicgen-medium", "--scheduler", "paged"])
    with pytest.raises(ValueError, match=words.format("paged KV")):
        PagedContinuousScheduler(eng, n_slots=2)
    with pytest.raises(ValueError, match=words.format("chunked prefill")):
        ContinuousScheduler(eng, n_slots=2, prefill_chunk=16)
    with pytest.raises(ValueError, match=words.format("speculative decoding")):
        ContinuousScheduler(eng, n_slots=2, spec_k=2)
    sched = ContinuousScheduler(Engine(
        get_config("musicgen-medium").reduced(), max_len=32, device="cpu",
        parallel=ParallelConfig(prefill_chunk=256, spec_k=3)), n_slots=2)
    assert sched.chunk == 0 and sched.spec_k == 0
    prompt = np.zeros((12, 4), np.int32)
    with pytest.raises(ValueError, match="max_len"):     # 8 + 12 + 13 > 32 >= 12 + 13
        sched.submit(prompt, 13)
    sched.submit(prompt, 12)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompt[None], 13)
    assert eng.generate(prompt[None], 12).shape == (1, 12, 4)
    done = serve.main(["--device", "cpu", "--arch", "internvl2-26b", "--scheduler",
                       "continuous", "--spec-k", "2", "--requests", "2", "--max-new", "3",
                       "--top-k", "1"])
    assert [len(r.output) for r in done] == [3, 3]


# -- bridge and weight bytes --------------------------------------------------


@pytest.mark.parametrize("arch,mode", [("internvl2-26b", "none"), ("musicgen-medium", "none"),
                                       ("musicgen-medium", "int4")])
def test_bridge_is_bit_exact(arch, mode):
    _, tree, params = engines(arch, mode)
    for name, leaf in tree["frontend"].items():
        np.testing.assert_array_equal(bits(params["frontend"][name]), jbits(leaf), err_msg=name)
    assert np.abs(np.asarray(tree["frontend"]["norm"], np.float32)).max() > 0  # perturbed
    ncb = get_config(arch).n_codebooks
    assert params["embed"]["table"].shape == (ncb, 512, 256)
    np.testing.assert_array_equal(bits(params["embed"]["table"]), jbits(tree["embed"]["table"]))
    head, jhead = params["lm_head"], tree["lm_head"]
    if mode == "none":
        assert head.shape == (ncb, 256, 512)
        np.testing.assert_array_equal(bits(head), jbits(jhead))
    else:
        assert isinstance(head, QuantWeight) and head.q.shape[0] == ncb
        np.testing.assert_array_equal(bits(head.q), jbits(jhead.q))
        np.testing.assert_array_equal(bits(head.scale), jbits(jhead.scale))


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_decode_weight_bytes_equal_jax(mode):
    for arch in ARCHS:
        cfg = get_config(arch)
        ctx = JM.ModelCtx.make(jget_config(arch), JParallelConfig(tp=1, dp=1, weight_quant=mode))
        assert TM.decode_weight_bytes(cfg, ParallelConfig(weight_quant=mode)) == \
            JM.decode_weight_bytes(ctx), (arch, mode)


# -- the projector, the codebook sum, the head, the sampling ------------------


def test_project_features_matches_jax():
    for arch in ARCHS:
        jeng, tree, params = engines(arch)
        cfg = get_config(arch).reduced()
        feats = np.random.default_rng(7).standard_normal((3, 8, 64)).astype(np.float32)
        want = jax.jit(lambda p, f: jmm.project_features(p, f, jeng.cfg))(
            jeng.params["frontend"], jnp.asarray(feats))
        got = multimodal.project_features(params["frontend"], torch.from_numpy(feats), cfg)
        assert got.dtype == torch.bfloat16 and got.shape == (3, 8, 256)
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(want).max() > 0.5          # the features reach the output
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOL, rtol=TOL, err_msg=arch)


def test_codebook_embedding_sum_is_bit_equal():
    jeng, tree, params = engines("musicgen-medium")
    cfg = jeng.cfg
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 40, 4)).astype(np.int32)
    plan = JShardPlan.make(cfg, 1)
    want = jax.jit(lambda t, x: jemb.embed_lookup(t, x, cfg, plan, JDist()))(
        jeng.params["embed"], jnp.asarray(toks))
    got = embed_lookup(params["embed"], torch.from_numpy(toks).long())
    np.testing.assert_array_equal(bits(got), jbits(want))
    # a single-codebook token matrix reads codebook 0 alone
    np.testing.assert_array_equal(
        bits(embed_lookup(params["embed"], torch.from_numpy(toks[..., 0]).long())),
        bits(params["embed"]["table"][0][torch.from_numpy(toks[..., 0]).long()]))


@pytest.mark.parametrize("mode", ["none", "int4"])
def test_multi_codebook_head_matches_jax(mode):
    jeng, _, params = engines("musicgen-medium", mode)
    x = (np.random.default_rng(9).standard_normal((2, 5, 256))).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda p, h: JM.lm_head_local(p, h, jeng.ctx))(jeng.params, xb))
    got = TM.lm_head(params, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 5, 4, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_codebook_frames_sample_greedy_as_jax():
    """(b, ncb, V) logits -> (b, ncb) frames, the first index on a tie."""
    logits = np.random.default_rng(10).standard_normal((3, 4, 512)).astype(np.float32)
    logits[1, 2, [7, 300]] = logits[1, 2].max() + 1.0          # a planted tie
    cfg = jget_config("musicgen-medium").reduced()
    mesh = engines("musicgen-medium")[0].mesh
    sample = lambda x: jsample_tokens(x, jax.random.key(0), JSamplingConfig(greedy=True, top_k=1),
                                      JShardPlan.make(cfg, 1), JDist())
    want = jax.jit(compat.shard_map(sample, mesh=mesh, in_specs=(P("data", None, None),),
                                    out_specs=P("data", None), check_vma=False))(
        jnp.asarray(logits))
    got = sample_tokens(torch.from_numpy(logits), SamplingConfig(top_k=1), torch.Generator())
    assert got.shape == (3, 4) and got[1, 2] == 7
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stochastic = sample_tokens(torch.from_numpy(logits), SamplingConfig(top_k=40),
                               torch.Generator().manual_seed(0))
    assert stochastic.shape == (3, 4) and ((stochastic >= 0) & (stochastic < 512)).all()


# -- the full forward behind a prefix -----------------------------------------


@pytest.mark.parametrize("mode", ["none", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_prefix_matches_jax(arch, mode):
    """Prefill logits of 2 prompts of 12 tokens (frames) behind 8 positions
    of seeded non-zero features, then 8 decode steps teacher-forced on the
    reference's greedy tokens, into a cache of MAX_LEN; the port's prefill
    logits cover prefix + prompt."""
    jeng, _, params = engines(arch, mode)
    cfg, ctx = get_config(arch).reduced(), jeng.ctx
    ncb, b, plen = cfg.n_codebooks, 2, 12
    frame = () if ncb == 1 else (ncb,)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, cfg.vocab_size, (b, plen, *frame)).astype(np.int32)
    feats = rng.standard_normal((b, 8, 64)).astype(np.float32)
    tok_spec = P("data", *(None,) * (prompts.ndim - 1))
    out_spec = P("data", *(None,) * (3 if ncb > 1 else 2))
    cspec = jkvcache.cache_pspecs(ctx, kv_seq_shard=False)
    sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)
    jpre = jax.jit(sm(lambda p, t, f, c: JM.forward(p, t, ctx, features=f, caches=c,
                                                    seq_sharded=True)[:2],
                      in_specs=(JM.param_specs(ctx), tok_spec, P("data", None, None), cspec),
                      out_specs=(out_spec, cspec)))
    dec_in = P("data", *(None,) * (prompts.ndim - 2))
    jdec = jax.jit(sm(lambda p, t, c, cur: (lambda o: (o[0][:, -1], o[1]))(JM.forward(
        p, t[:, None], ctx, caches=c, cur_pos=cur)),
        in_specs=(JM.param_specs(ctx), dec_in, cspec, P()),
        out_specs=(P("data", *(None,) * (prompts.ndim - 1)), cspec)))
    jl, jc = jpre(jeng.params, jnp.asarray(prompts), jnp.asarray(feats), jeng.init_caches(b))
    tc = TM.init_caches(cfg, b, MAX_LEN, device="cpu")
    with torch.inference_mode():
        tl = TM.forward(params, torch.from_numpy(prompts).long(), cfg, caches=tc,
                        features=torch.from_numpy(feats))
    assert tl.shape == (b, 8 + plen, *frame, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for step in range(8):
        cur = 8 + plen + step
        jl, jc = jdec(jeng.params, jnp.asarray(tok), jc, jnp.int32(cur))
        with torch.inference_mode():
            tl = TM.forward(params, torch.from_numpy(tok).long()[:, None], cfg, caches=tc,
                            cur_pos=cur)[:, -1]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"decode step {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)


# -- int4 weights' streams (tests/test_torch_multimodal_serve.py's checks) ----


def int4_engines(arch):
    """(JAX engine, port engine) on this module's int4 weights."""
    jeng, _, params = engines(arch, "int4")
    cfg = get_config(arch).reduced()
    return jeng, Engine(cfg, parallel=ParallelConfig(weight_quant="int4"),
                        sampling=SamplingConfig(top_k=1), max_len=MAX_LEN, params=params,
                        device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_int4_generate_matches_jax(arch):
    check_generate(*int4_engines(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_int4_wave_scheduler_matches_jax(arch):
    check_wave_scheduler(*int4_engines(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_int4_continuous_scheduler_matches_jax(arch):
    check_continuous_scheduler(*int4_engines(arch))
