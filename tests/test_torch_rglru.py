"""The RG-LRU hybrid (recurrentgemma-9b) against the JAX package on the same
weights: the plain lru_scan and windowed flash prefill, the RG-LRU block,
the bridge over multi-group trees, prefill and decode logits across the
sliding-window ring's wrap, greedy wave and continuous tokens, and the
capability registry's refusals.

Configs: the 3-layer ``.reduced()`` (R, R, A: one unrolled period group)
and a 5-layer variant (R, R, A, R, R: the period group and two unrolled
singles, as at full width), both at window 64, head_dim 64, d 256; the
bridge also takes an 8-layer tree, whose period group is scanned (stacked).
The JAX side runs ``use_pallas=True``, so its prefill goes through the
Pallas lru_scan in interpret mode.  Norm gammas and the RG-LRU gate biases
are zero at init; they are overwritten with seeded values on both sides
first, so that the (1 + gamma) scale and the bias adds are tested.

Tolerances: the plain lru_scan 1e-5 with fp32 inputs and 5e-2 with bf16
ones, as tests/test_kernels.py holds the Pallas kernel; the RG-LRU block
5e-2 on bf16 activations of magnitude ~1 (one bf16 ulp at 1 is 4e-3).
Whole-model logits: 5e-2, or the JAX package's own spread where that is
larger.  The spread is how far the reference's logits move between two
compilations of the same program on the same input: XLA's default, which
allows excess precision (it skips some bf16 roundings, and the JAX engine
runs so), and one without it (every op rounds, as the program is
written).  Over three to five hybrid layers at 80 tokens it is 0.09-0.12,
above 5e-2, so 5e-2 would hold the port to a closer match than the
reference keeps with itself.  Greedy streams that part are certified at
their first differing step where the port's top-2 gap is below 1e-2, or
below the reference's spread at that position (the same two
compilations, teacher-forced along the JAX stream).
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
from repro.configs import get_config as jget_config
from repro.core.capabilities import ArchCapabilities as JArchCapabilities
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import rglru as jrglru
from repro.models.common import Dist
from repro.runtime import kvcache as jkvcache
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS, ParallelConfig, SamplingConfig, get_config
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import rglru as trglru
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                           WaveScheduler)
from test_torch_continuous import serve
from test_torch_model import jax_engine

TOL, TIE_GAP = 5e-2, 1e-2
MAX_LEN, PLEN = 96, 80        # a ring of 64 entries; prompts longer than the window
LAYERS = {"r3": 3, "r5": 5}


def configs(n_layers: int):
    return (dataclasses.replace(jget_config("recurrentgemma-9b").reduced(), n_layers=n_layers),
            dataclasses.replace(get_config("recurrentgemma-9b").reduced(), n_layers=n_layers))


def hybrid_engine(jcfg, max_len=MAX_LEN, **parallel_kw):
    """A JAX engine (Pallas on; ``parallel_kw`` for its ParallelConfig) with
    seeded nonzero norms and gate biases -> (engine, numpy tree)."""
    eng, tree = jax_engine(jcfg, max_len, use_pallas=True, **parallel_kw)
    rng = np.random.default_rng(5)

    def perturb(path, leaf):
        if any(k in jax.tree_util.keystr(path) for k in ("'gate_a_b'", "'gate_x_b'")):
            return (rng.standard_normal(leaf.shape) * 0.5).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    eng.params = jax.tree.map(jnp.asarray, tree)
    return eng, tree


@pytest.fixture(scope="module", params=list(LAYERS))
def pair(request):
    """(JAX engine, its numpy tree, port cfg, port engine on the same weights)."""
    jcfg, tcfg = configs(LAYERS[request.param])
    jeng, tree = hybrid_engine(jcfg)
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    return jeng, tree, tcfg, teng


def reference_logits(jeng, tokens: np.ndarray):
    """The JAX package's logits of ``tokens`` (b, s) without a cache, from
    its default compilation and from one without excess precision."""
    fwd = jax.jit(lambda p, t: JM.forward(p, t, jeng.ctx)[0])
    t = jnp.asarray(tokens, jnp.int32)
    exact = fwd.lower(jeng.params, t).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return np.asarray(fwd(jeng.params, t)), np.asarray(exact(jeng.params, t))


def tie_gap(jeng, seq: np.ndarray) -> float:
    """The largest top-2 gap certified as a near-tie after ``seq``: 1e-2, or
    the reference's own spread over the last position's logits."""
    default, exact = reference_logits(jeng, seq[None])
    return max(TIE_GAP, float(np.abs(default[0, -1] - exact[0, -1]).max()))


def port_gap(teng, seq: np.ndarray) -> float:
    with torch.inference_mode():
        logits = TM.forward(teng.params, torch.from_numpy(seq.astype(np.int64))[None], teng.cfg,
                            last_only=True)[0, -1].numpy()
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


# ---------------------------------------------------------------------------
# Kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,w", [(1, 8, 64), (2, 37, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_scan_plain_matches_jax(b, s, w, dtype):
    rng = np.random.default_rng(b * s + w)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, s, w))))
    bb = rng.standard_normal((b, s, w))
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(bb, dtype)
    ta, tb = (torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
              for x in (ja, jb))
    hs, hT = ops.lru_scan(ta, tb, torch.from_numpy(h0))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for want_hs, want_hT in (jops.lru_scan(ja, jb, jnp.asarray(h0)),
                             jref.lru_scan_ref(ja, jb, jnp.asarray(h0))):
        np.testing.assert_allclose(hs.numpy(), np.asarray(want_hs), atol=tol, rtol=tol)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_hT), atol=tol, rtol=tol)
    assert hs.dtype == hT.dtype == torch.float32


@pytest.mark.parametrize("window", [0, 5, 16, 64])
def test_windowed_flash_prefill_plain_matches_jax(window):
    """ref.flash_prefill_ref with a window against the JAX package's
    windowed prefill (``chunked_causal_attention``), pad rows included."""
    rng = np.random.default_rng(window)
    b, hq, hkv, s, hd = 2, 4, 1, 40, 64
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, hq, s, hd), (b, hkv, s, hd), (b, hkv, s, hd)))
    pos = np.arange(s, dtype=np.int32)
    want = jattn.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pos), jnp.asarray(pos), window, 0.125)
    q_pos = torch.from_numpy(np.tile(pos, (b, 1)))
    got = ref.flash_prefill_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                q_pos, 0.125, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    q_pos[1, -3:] = -1                                      # pad rows: exact zeros
    got = ops.flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            q_pos, 0.125, window=window)
    assert (got[1, :, -3:] == 0).all()


def test_kernel_checks_take_head_dim_256():
    """The wrappers' device checks take head_dim 256 in every attention
    kernel (every layout has the instance) and refuse a head_dim none has."""
    assert ops.HEAD_DIMS == (64, 128, 256)
    q = torch.zeros(1, 2, 4, 256)
    kv = torch.zeros(1, 1, 4, 256)
    q_pos = torch.zeros(1, 4, dtype=torch.int32)
    ops._check_stripe_cuda("flash_prefill", q, kv, kv, q_pos, None)
    ops._check_stripe_cuda("flash_verify", q, kv, kv, q_pos, None)
    q96, kv96 = q[..., :96].contiguous(), kv[..., :96].contiguous()
    with pytest.raises(ValueError, match="head_dim 96"):
        ops._check_stripe_cuda("flash_verify", q96, kv96, kv96, q_pos, None)
    # only flash_prefill takes a window: the split and paged layouts have none
    ops.flash_prefill(q, kv, kv, q_pos, 0.1, window=2)
    bt = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(TypeError, match="window"):
        ops.flash_verify(q, kv, kv, q_pos, 0.1, window=2)
    with pytest.raises(TypeError, match="window"):
        ops.paged_flash_prefill(q, kv, kv, bt, q_pos, 0.1, window=2)


# ---------------------------------------------------------------------------
# Configs, registry, ring addressing
# ---------------------------------------------------------------------------


def test_configs_and_registry_match_jax():
    """Every arch the port registers: the same config, ``reduced()`` and
    parameter count as the JAX package's, and the same capability record."""
    for arch in ALL_ARCHS:
        for t, j in ((get_config(arch), jget_config(arch)),
                     (get_config(arch).reduced(), jget_config(arch).reduced())):
            for f in dataclasses.fields(t):
                tv, jv = getattr(t, f.name), getattr(j, f.name)
                if dataclasses.is_dataclass(tv):
                    tv, jv = dataclasses.asdict(tv), dataclasses.asdict(jv)
                assert tv == jv, (arch, f.name)
            assert t.param_count() == j.param_count()
            assert dataclasses.asdict(ArchCapabilities.from_config(t)) == \
                dataclasses.asdict(JArchCapabilities.from_config(j)), arch
    assert get_config("recurrentgemma-9b").reduced().n_layers == 3
    assert get_config("recurrentgemma-9b").param_count() == 9_571_721_216


def test_slot_index_wraps_on_a_ring():
    pos = torch.tensor([-1, 0, 63, 64, 130])
    assert tattn.slot_index(pos, 64, ring=True).tolist() == [0, 0, 63, 0, 2]
    assert tattn.slot_index(pos, 64).tolist() == [0, 0, 63, 63, 63]
    assert tattn.cache_len_for(get_config("recurrentgemma-9b"), "local_attn", 2400, 4) == 2052
    assert tattn.cache_len_for(get_config("recurrentgemma-9b"), "attn", 2400) == 2400


def test_check_supported_admits_the_hybrid_and_names_what_it_refuses():
    cfg = get_config("recurrentgemma-9b")
    TM.check_supported(cfg)
    # weight quant and the int8 KV cache are served on the hybrid too
    for mode in ("int8", "int4"):
        TM.check_supported(cfg, ParallelConfig(weight_quant=mode, kv_quant=True))
    with pytest.raises(NotImplementedError, match="weight_quant=int2"):
        TM.check_supported(cfg, ParallelConfig(weight_quant="int2"))
    mixed = dataclasses.replace(cfg, layer_pattern=("attn", "local_attn"))
    with pytest.raises(NotImplementedError, match="attn and local_attn"):
        TM.check_supported(mixed)


# ---------------------------------------------------------------------------
# RG-LRU block, bridge, logits
# ---------------------------------------------------------------------------


def test_rglru_block_matches_jax(pair):
    """``rglru_forward`` on a right-padded prefill from a nonzero state:
    output, h and conv within TOL of JAX's (Pallas scan), and a stepwise
    decode from the same state gives the scan's outputs and final state."""
    jeng, tree, cfg, teng = pair
    jcfg = jeng.cfg
    mixer = tree["groups"][0]["sub0"]["mixer"]
    rng = np.random.default_rng(7)
    b, s, w = 3, 11, cfg.d_model
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    conv0 = rng.standard_normal((b, cfg.rglru.conv_width - 1, w)).astype(np.float32)
    lens = np.array([11, 7, 2])
    lmask = np.arange(s)[None, :] < lens[:, None]

    jx = jnp.asarray(x, jnp.bfloat16)
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0, jnp.bfloat16)}
    fwd = jax.jit(partial(jrglru.rglru_forward, cfg=jcfg, dist=Dist(tp=1, dp=1),
                          use_pallas=True))
    jout, jnew = fwd(jax.tree.map(jnp.asarray, mixer), jx, state=jstate,
                     length_mask=jnp.asarray(lmask))

    tp = bridge.params_from_jax(tree, cfg, device="cpu")["layers"][0]["mixer"]
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).bfloat16()
    tstate = {"h": torch.from_numpy(h0), "conv": torch.from_numpy(conv0).bfloat16()}
    with torch.inference_mode():
        tout, tnew = trglru.rglru_forward(tp, tx, cfg, state=tstate,
                                          length_mask=torch.from_numpy(lmask))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    np.testing.assert_allclose(tout.float().numpy(), f32(jout), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tnew["h"].numpy(), f32(jnew["h"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tnew["conv"].float().numpy(), f32(jnew["conv"]), atol=TOL, rtol=TOL)

    # stepwise decode == the scan (row 0: no padding)
    with torch.inference_mode():
        state = {"h": tstate["h"][:1], "conv": tstate["conv"][:1]}
        outs = []
        for t in range(s):
            o, state = trglru.rglru_forward(tp, tx[:1, t:t + 1], cfg, state=state)
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).float().numpy(), tout[:1].float().numpy(),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state["h"].numpy(), tnew["h"][:1].numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(state["conv"], tnew["conv"][:1])


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)).numpy()


def _np_bits(a):
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("n_layers", [5, 8])
def test_bridge_is_bit_exact_over_groups(n_layers):
    """5 layers: an unrolled period group and two unrolled singles; 8: a
    scanned (stacked) period group of two repeats and two singles.  Every
    leaf lands on its layer bit for bit, and the mixer's and the FFN's
    ``w_gate`` land apart."""
    jcfg, tcfg = configs(n_layers)
    _, tree = hybrid_engine(jcfg, max_len=32)
    params = bridge.params_from_jax(tree, tcfg, device="cpu")
    layer = 0
    for group in tree["groups"]:
        subs = [group[f"sub{j}"] for j in range(len(group))]
        n = np.asarray(subs[0]["norm1"]).shape[0] if np.asarray(subs[0]["norm1"]).ndim == 2 else 0
        for r in range(max(n, 1)):
            for sub in subs:
                mine = params["layers"][layer]
                pick = (lambda a: a[r]) if n else (lambda a: a)
                kind = tcfg.block_kind(layer)
                mixer = mine["mixer"] if kind == "rglru" else mine
                for name, a in sub["mixer"].items():
                    np.testing.assert_array_equal(_bits(mixer[name]), _np_bits(pick(a)))
                for name, a in sub["ffn"].items():
                    np.testing.assert_array_equal(_bits(mine[name]), _np_bits(pick(a)))
                for name in ("norm1", "norm2"):
                    np.testing.assert_array_equal(_bits(mine[name]), _np_bits(pick(sub[name])))
                if kind == "rglru":
                    assert mine["mixer"]["w_gate"].shape == (tcfg.d_model, tcfg.d_model)
                    assert mine["w_gate"].shape == (tcfg.d_model, tcfg.d_ff)
                    assert mine["mixer"]["Lambda"].dtype == torch.float32
                layer += 1
    assert layer == n_layers == len(params["layers"])
    assert len(tree["groups"]) == 3 and [len(g) for g in tree["groups"]] == [3, 1, 1]


def test_prefill_and_decode_logits_match_jax_across_the_wrap(pair):
    """80 prompt tokens into a ring of 64 (the prefill keeps the last 64),
    then 16 teacher-forced decode steps writing at position % 64: logits
    within TOL of the JAX package's at every step (or its own spread, see
    the module docstring), and the same ring positions and recurrent
    state.  At that limit a port whose decode writes K/V at a clamped
    index while its position rows wrap fails at the first decode step,
    and one whose prefill drops the window or widens it by one key fails
    at the prefill."""
    jeng, _, cfg, teng = pair
    ctx = jeng.ctx
    b, steps = 2, MAX_LEN - PLEN
    pspecs = JM.param_specs(ctx)
    cspec = jkvcache.cache_pspecs(ctx, kv_seq_shard=False)
    sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)

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
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, PLEN)).astype(np.int32)
    default, exact = reference_logits(jeng, prompts)
    tol = max(TOL, float(np.abs(default - exact).max()))
    assert tol < 0.2                                   # the reference's rounding, not drift
    jl, jc = jpre(jeng.params, jnp.asarray(prompts), jeng.init_caches(b))
    tc = teng.init_caches(b)
    assert tuple(tc["pos"].shape) == (cfg.window,)
    with torch.inference_mode():
        tl = TM.forward(teng.params, torch.from_numpy(prompts).long(), cfg, caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=TOL)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for step in range(steps):
        cur = PLEN + step
        jl, jc = jdec(jeng.params, jnp.asarray(tok), jc, jnp.int32(cur))
        with torch.inference_mode():
            tl = TM.forward(teng.params, torch.from_numpy(tok).long()[:, None], cfg,
                            caches=tc, cur_pos=cur)[:, -1]
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=TOL,
                                   err_msg=f"decode step {step}")
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    attn_sub = next(g["sub2"] for g in jc if "sub2" in g)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(attn_sub["pos"]))
    assert tc["pos"].max() == MAX_LEN - 1 and tc["pos"].min() == MAX_LEN - cfg.window
    rec = [(gi, k) for gi, g in enumerate(jc) for k in sorted(g) if "h" in g[k]]
    assert len(rec) == tc["h"].shape[0]
    for i, (gi, k) in enumerate(rec):
        np.testing.assert_allclose(tc["h"][i].numpy(), np.asarray(jc[gi][k]["h"]),
                                   atol=tol, rtol=TOL)


# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


def _wave_work(vocab):
    rng = np.random.default_rng(11)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32), int(m), None, 0)
            for n, m in ((80, 12), (71, 9), (77, 16), (66, 10))]


def _certify(jeng, teng, work, port, ref, pad_to=None):
    """Per request: the JAX stream, or a first difference at a near-tie
    (``tie_gap``) of the port's logits, teacher-forced along the JAX
    stream; ``pad_to(rid)`` gives the right-padded prompt length a wave ran
    the request at.  At least one request keeps the JAX stream.  The
    certificate, not a count, is the guard: a wrong ring row or state moves
    logits by O(1), far above any certified gap, and near-ties are common
    here (the wave's prompts put the first token of two requests of four
    at top-2 gaps of 3.4e-3 and 8.1e-3)."""
    assert sorted(port) == sorted(ref) == list(range(len(work)))
    flips = 0
    for rid, (prompt, *_) in enumerate(work):
        a, b = port[rid].output, ref[rid].output
        assert a.dtype == np.int32 and ((a >= 0) & (a < teng.cfg.vocab_size)).all()
        if np.array_equal(a, b):
            assert port[rid].finish_reason == ref[rid].finish_reason
            continue
        n = min(len(a), len(b))
        t = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
        plen = len(prompt) if pad_to is None else pad_to(rid)
        seq = np.zeros(plen + t, np.int32)
        seq[:len(prompt)] = prompt
        seq[plen:] = b[:t]
        gap, limit = port_gap(teng, seq), tie_gap(jeng, seq)
        assert gap < limit, f"request {rid} parts at step {t}: top-2 gap {gap} >= {limit}"
        flips += 1
    assert flips < len(work)


def test_wave_tokens_match_jax(pair):
    """Prompts of 66-80 tokens (longer than the 64-token window) in waves of
    two, up to 16 new tokens: the ring wraps in prefill and decode."""
    jeng, _, cfg, teng = pair
    work = _wave_work(cfg.vocab_size)
    port, ref = serve(WaveScheduler(teng, 2), work), serve(JWaveScheduler(jeng, batch_size=2), work)
    wave_len = lambda rid: max(len(p) for p, *_ in work[rid - rid % 2: rid - rid % 2 + 2])
    _certify(jeng, teng, work, port, ref, pad_to=wave_len)
    for rid, (_, m, *_) in enumerate(work):
        assert len(port[rid].output) == m


def _mixed_lengths(vocab):
    """tests/test_continuous.py's mixed-prompt-length workload."""
    rng = np.random.default_rng(1)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32), m, None, 0)
            for n, m in ((5, 6), (9, 3), (4, 8))]


def _past_window(vocab):
    """Prompts of 54-60 tokens with budgets of 12-16, so that every slot's
    decode writes position 64 or later and wraps the ring; staggered
    arrivals."""
    rng = np.random.default_rng(12)
    return [(rng.integers(0, vocab, int(rng.integers(54, 61))).astype(np.int32),
             int(rng.integers(12, 17)), None, 3 * i) for i in range(4)]


@pytest.mark.parametrize("workload", [_mixed_lengths, _past_window])
def test_continuous_tokens_match_jax(pair, workload):
    jeng, _, cfg, teng = pair
    reqs = workload(cfg.vocab_size)
    jsched = JContinuousScheduler(jeng, n_slots=2, block_steps=4)
    tsched = ContinuousScheduler(teng, n_slots=2, block_steps=4)
    assert tsched.chunk == jsched.chunk == 0 and tsched.spec_k == 0   # fell back
    ref, port = serve(jsched, reqs), serve(tsched, reqs)
    _certify(jeng, teng, reqs, port, ref)
    for key in ("decode_steps", "prefill_calls", "prefill_tokens", "admission_rounds",
                "in_flight_admissions", "emitted"):
        assert tsched.stats[key] == jsched.stats[key], key
    if workload is _past_window:       # the last decode write is at len + m - 2
        assert min(len(p) + m - 2 for p, m, *_ in reqs) >= cfg.window


def test_admission_resets_and_leaves_live_state(pair):
    """An admission into slot 1 zeroes slot 1's recurrent state before its
    prefill and leaves the live slot 0's K/V, positions and state bit for
    bit."""
    _, _, cfg, teng = pair
    caches = teng.init_slot_caches(2)
    toks = np.zeros((2, 8), np.int32)
    toks[0, :5] = np.arange(5) + 7
    toks[1, :6] = np.arange(6) + 40
    teng.prefill_into_slots(caches, toks, np.array([True, True]), np.array([5, 6]))
    once = caches["h"][:, 1].clone()
    before = {k: t[..., 0, :, :].clone() if k in ("k", "v") else t[:, 0].clone()
              for k, t in caches.items() if k != "pos"}
    pos0 = caches["pos"][0].clone()
    teng.prefill_into_slots(caches, toks, np.array([False, True]), np.array([1, 6]))
    for k, t in before.items():
        now = caches[k][..., 0, :, :] if k in ("k", "v") else caches[k][:, 0]
        assert torch.equal(t, now), k
    assert torch.equal(pos0, caches["pos"][0])
    assert torch.equal(once, caches["h"][:, 1])      # the same prompt from a zero state


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_registry_refusals(pair):
    _, _, cfg, teng = pair
    sched = ContinuousScheduler(teng, n_slots=2)
    assert sched.prompt_limit == cfg.window
    with pytest.raises(ValueError, match="sliding-window"):
        sched.submit(np.zeros(cfg.window + 1, np.int32), 4)
    with pytest.raises(ValueError, match="does not support chunked prefill"):
        ContinuousScheduler(teng, n_slots=2, prefill_chunk=16)
    with pytest.raises(ValueError, match="does not support speculative decoding"):
        ContinuousScheduler(teng, n_slots=2, spec_k=2)
    with pytest.raises(ValueError, match="does not support paged KV"):
        PagedContinuousScheduler(teng, n_slots=2)
    quiet = Engine(cfg, parallel=ParallelConfig(prefill_chunk=32, spec_k=3), max_len=MAX_LEN,
                   params=teng.params, device="cpu")
    fell = ContinuousScheduler(quiet, n_slots=2)
    assert fell.chunk == 0 and fell.spec_k == 0
    # the ring holds window + spec_k entries, as the JAX package's ring_slack
    assert quiet.init_slot_caches(2)["pos"].shape == (2, cfg.window + 3)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        quiet.mixed_step(quiet.init_slot_caches(2), np.zeros((2, 8), np.int32),
                         np.array([True, False]), np.array([8, 1]), np.zeros(2), np.array([8, 1]),
                         np.zeros(2, np.int32), np.zeros(2, np.int32), np.ones(2, bool),
                         np.zeros(2, np.int32), np.full(2, -1))
