"""The mixture-of-experts FFN (deepseek-moe-16b) against the JAX package on
the same weights: the parameter tree and bridge (a dense layer 0, then MoE
layers with an fp32 router, expert blocks and shared experts), quantized
expert bytes, the routing's tie order, the capacity drops of one MoE
forward past 256 tokens, prefill and decode logits in bf16, int8/int4
weights and over the int8 KV cache.  Greedy streams through the
schedulers are held in tests/test_torch_moe_serve.py.

Config: ``deepseek-moe-16b.reduced()`` (2 layers: layer 0 dense, layer 1
MoE with 4 experts of 128, top 2, 128 of shared experts; d 256, 4 MHA
heads of 64, vocab 512), the reference built as tests/test_torch_model.py
builds it, on its pure-JAX path.

Tolerances: logits 5e-2; one MoE layer's output 5e-2 on the same bf16
input; the drop set and the tie order exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import wquant as jwquant
from repro.models import moe as jmoe
from repro.models.common import Dist as JDist
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.core import wquant
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import model as TM
from repro_torch.models import moe
from test_torch_mla import port_engine
from test_torch_model import assert_logits_match, jax_engine

ARCH, MAX_LEN, TOL = "deepseek-moe-16b", 64, 5e-2


def configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


_ENGINES = {}


def engines(mode="none", kv_quant=False, max_len=MAX_LEN):
    """(JAX engine, its numpy tree, port engine) on the same weights, built
    once per module and setting."""
    key = (mode, kv_quant, max_len)
    if key not in _ENGINES:
        jcfg, tcfg = configs()
        jeng, tree = jax_engine(jcfg, max_len, weight_quant=mode, kv_quant=kv_quant)
        teng = port_engine(tree, tcfg, weight_quant=mode, kv_quant=kv_quant)
        teng.max_len = max_len
        _ENGINES[key] = jeng, tree, teng
    return _ENGINES[key]


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)


def jax_drops(router, x, m) -> set:
    """The JAX package's dispatch bookkeeping (``moe_forward``) on x (T, d):
    its (token, expert) assignments past capacity."""
    top_e, _, _ = jmoe.route(jnp.asarray(router), x, m)
    flat_e = np.asarray(top_e).reshape(-1)
    T = x.shape[0]
    order = np.argsort(flat_e, kind="stable")
    counts = np.bincount(flat_e, minlength=m.n_experts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(T * m.top_k) - starts[flat_e[order]]
    lost = pos >= jmoe.capacity(m, T)
    return set(zip((order[lost] // m.top_k).tolist(), flat_e[order][lost].tolist()))


# ---------------------------------------------------------------------------
# Config, parameter tree, quantization
# ---------------------------------------------------------------------------


def test_supported_at_tp1_refused_at_tp2():
    cfg = get_config(ARCH)
    for mode in ("none", "int8", "int4"):
        for kvq in (False, True):
            for tp in (1, 2, 4, 8):   # expert-parallel at tp>1 (64 experts: 8 a rank at tp 8)
                TM.check_supported(cfg, ParallelConfig(tp=tp, weight_quant=mode, kv_quant=kvq))
    # refused at tp>1: a packed weight file (its layer groups), and experts
    # that do not split (moe_plan)
    with pytest.raises(NotImplementedError, match="wq_cache at tp>1"):
        TM.check_supported(cfg, ParallelConfig(tp=2, weight_quant="int4"), wq_cache="x.npz")
    with pytest.raises(ValueError, match="n_experts 6 not divisible by tp 4"):
        TM.check_supported(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=6)),
                           ParallelConfig(tp=4))
    # MoE over a sliding-window ring is served (the ring chunk writer); what
    # still stands there is the reference's refusal of the paged pool
    mixtral_like = dataclasses.replace(cfg, window=64, layer_pattern=("local_attn",))
    TM.check_supported(mixtral_like)
    with pytest.raises(ValueError, match="does not support paged KV: blocked by the "
                                         "sliding-window ring"):
        ArchCapabilities.from_config(mixtral_like).require("paged")
    assert ArchCapabilities.from_config(cfg).blockers == {}
    assert moe.capacity(cfg.moe, 256) == 256 and moe.capacity(cfg.moe, 257) == 31


def test_param_tree_and_bridge_follow_jax():
    """Layer 0 dense, layer 1 MoE: the fp32 router, the (E, d, f) expert
    blocks and the shared experts under ``shared``, bit for bit."""
    _, tree, teng = engines()
    cfg = teng.cfg
    assert TM.layer_families(cfg) == {"attn": [0], "attn+moe": [1]}
    ffn = tree["groups"][1]["sub0"]["ffn"]
    layer = teng.params["layers"][1]
    assert layer["router"].dtype == torch.float32
    np.testing.assert_array_equal(layer["router"].numpy(), ffn["router"])
    for name in ("w_up", "w_gate", "w_down"):
        np.testing.assert_array_equal(layer[name].view(torch.int16).numpy(),
                                      ffn[name].view(np.int16))
        np.testing.assert_array_equal(layer["shared"][name].view(torch.int16).numpy(),
                                      ffn["shared"][name].view(np.int16))
    assert set(teng.params["layers"][0]) == set(TM.layer_param_defs(cfg, "attn"))
    fresh = TM.init_params(cfg, seed=3, device="cpu")["layers"][1]
    assert fresh["w_down"].shape == (4, 128, 256) and fresh["router"].dtype == torch.float32
    assert fresh["shared"]["w_up"].shape == (256, 128)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_expert_bytes_equal_jax(mode):
    """Expert blocks quantize as einsum sites with per-expert scales, the
    shared experts and the dense layer as matmul sites, the router stays
    fp32; the port's quantizer gives the JAX QuantWeight's bytes, and the
    bridged quantized tree carries them as (L, E, K, N)."""
    _, tree, teng = engines()
    ffn = tree["groups"][1]["sub0"]["ffn"]
    for name in ("w_up", "w_down"):
        jq = jwquant.quantize(jnp.asarray(ffn[name]), mode, 128)
        tq = wquant.quantize(teng.params["layers"][1][name], mode, 128)
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q), err_msg=name)
        np.testing.assert_array_equal(tq.scale.view(torch.int16).numpy(),
                                      np.asarray(jq.scale).view(np.int16), err_msg=name)
    _, qtree, qeng = engines(mode)
    qlayer = qeng.params["layers"][1]
    assert isinstance(qlayer["w_up"], QuantWeight) and qlayer["w_up"].q.shape[0] == 4
    assert isinstance(qlayer["shared"]["w_down"], QuantWeight)
    assert isinstance(qeng.params["layers"][0]["w_down"], QuantWeight)
    assert qlayer["router"].dtype == torch.float32
    jw = qtree["groups"][1]["sub0"]["ffn"]["w_gate"]
    np.testing.assert_array_equal(qlayer["w_gate"].q.numpy(), np.asarray(jw.q))
    assert TM.wq_site("attn+moe", "w_up") == "einsum"
    assert TM.wq_site("attn+moe", "shared.w_up") == TM.wq_site("attn", "w_up") == "matmul"
    fresh = TM.init_params(teng.cfg, ParallelConfig(weight_quant=mode), device="cpu")
    assert fresh["layers"][1]["w_up"].q.shape[0] == 4     # a layer's view of (L, E, K, N)
    wb = TM.decode_weight_bytes(teng.cfg, ParallelConfig(weight_quant=mode))
    full = TM.decode_weight_bytes(get_config(ARCH), ParallelConfig(weight_quant=mode))
    assert 0 < wb["quantized_ref_einsum"] < wb["quantized"]
    assert full["quantized_ref_einsum"] > full["quantized"] / 2   # the experts dominate


# ---------------------------------------------------------------------------
# One MoE layer
# ---------------------------------------------------------------------------


def _moe_inputs(T, seed=0, skew=3.0):
    """x (T, d) bf16 leaning toward expert 0's router column, so that its
    queue passes capacity."""
    _, tree, teng = engines()
    ffn = tree["groups"][1]["sub0"]["ffn"]
    rng = np.random.default_rng(seed)
    lean = ffn["router"][:, 0] / np.linalg.norm(ffn["router"][:, 0])
    x = rng.standard_normal((T, teng.cfg.d_model)) + skew * lean
    return ffn, jnp.asarray(x, jnp.bfloat16), teng


def test_moe_forward_drops_match_jax(monkeypatch):
    """320 tokens: C = 200 of 640 assignments; expert 0's queue overflows.
    The port drops exactly the reference's (token, expert) pairs, and the
    layer's output is the reference's within 5e-2."""
    ffn, jx, teng = _moe_inputs(320)
    jcfg, tcfg = configs()
    want = jax_drops(ffn["router"], jx, jcfg.moe)
    assert len(want) > 0
    monkeypatch.setattr(moe, "LOG", [])
    with torch.inference_mode():
        out = moe.moe_forward(teng.params["layers"][1], _bf16(jx)[None], tcfg)[0]
    (rec,) = moe.LOG
    assert rec["T"] == 320 and rec["C"] == 200
    assert set(map(tuple, moe.dropped(rec).tolist())) == want
    jout, _ = jmoe.moe_forward({k: (jnp.asarray(v) if not isinstance(v, dict) else
                                    {kk: jnp.asarray(vv) for kk, vv in v.items()})
                                for k, v in ffn.items()}, jx[None], jcfg, JDist())
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout[0], np.float32),
                               atol=TOL, rtol=TOL)


def test_router_ties_rank_as_lax_top_k():
    """Three equal router columns: every token's top 2 are the tied experts
    with the lower indices, in index order, as lax.top_k ranks them."""
    ffn, jx, _ = _moe_inputs(40, seed=1, skew=0.0)
    router = ffn["router"].copy()
    router[:, 2] = router[:, 3] = router[:, 1]
    m = configs()[0].moe
    jtop, jg, _ = jmoe.route(jnp.asarray(router), jx, m)
    ttop, tg, _ = moe.route(torch.from_numpy(router), _bf16(jx), configs()[1].moe)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    tied = np.asarray(jtop)[(np.asarray(jtop) != 0).all(1)]
    assert len(tied) and (tied == [1, 2]).all()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)


# ---------------------------------------------------------------------------
# Logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,kv_quant", [("none", False), ("int8", False), ("int4", False),
                                           ("none", True)])
def test_prefill_and_decode_logits_match_jax(mode, kv_quant):
    jeng, _, teng = engines(mode, kv_quant)
    assert_logits_match(jeng, teng.cfg, teng.params, kv_quant=kv_quant)
