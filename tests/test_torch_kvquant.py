"""The int8 KV cache and the packed-weight checkpoint (``--wq-cache``)
against the JAX package.

* ``quantize_kv``/``dequantize_kv`` bit for bit against the JAX package's
  ``_quantize_kv``/``_dequantize_kv`` as the engine runs them (jitted: XLA
  folds the division by 127 into a product with fp32 1/127, which rounds
  apart from the division for some rows), on seeded bf16 rows, all-zero
  rows, rows whose values land on .5 ties and large values; and
  ``kv_quant_write``'s plain version, whose bytes land where its targets say
  and nowhere else.
* Prefill and teacher-forced decode logits of yi-9b (GQA, head_dim 128) and
  qwen-72b int4 with ``kv_quant=True`` within 5e-2 of the JAX forward's
  (tests/test_torch_model.py's tolerance).
* ``reset_slots`` zeroes a slot cache's scale rows and leaves pools alone.
* The RG-LRU hybrid (reduced recurrentgemma-9b, R, R, A, window 64) with
  int8 weights and the int8 KV cache, 80 prompt tokens into a 64-entry ring
  and 16 decode steps across its wrap: logits within 5e-2 or the JAX
  package's own spread between two compilations (tests/test_torch_rglru.py),
  whichever is larger; with a fault planted in the port (decode K/V written
  at a clamped ring index, the prefill's window dropped) the same limit
  fails.
* The packed-weight checkpoint: a port round trip is bit-exact (int4 on
  yi-9b, int8 on the 5-layer hybrid whose layers form three groups), a meta
  that does not match is an error, and a file that the JAX package saved
  loads equal, bit for bit, to ``params_from_jax`` of the same tree.
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
from repro.models import attention as jattn
from repro.models import model as JM
from repro.runtime import kvcache as jkvcache
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core.wquant import QuantWeight
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.runtime import kvcache
from repro_torch.runtime.engine import Engine
from repro_torch.training import checkpoint
from test_torch_model import GQA, assert_logits_match, jax_engine
from test_torch_rglru import hybrid_engine, reference_logits

TOL = 5e-2


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rows(kind: str) -> np.ndarray:
    """(2, 3, 40, 128) values, rounded to bf16 on both sides."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 40, 128)) * 2
    if kind == "zeros":
        x[0, 1, :7] = 0.0                              # scale max(0, 1e-6) / 127
        x[1, 2, 5] = 0.0
    elif kind == "ties":
        # amax 127 puts the scale at 1.0, so k + 0.5 values are exact ties
        x[:, :, :, 0] = 127.0
        x[:, :, :, 1:] = rng.integers(-126, 126, x[:, :, :, 1:].shape) + 0.5
    elif kind == "large":
        x *= 1e4
        x[0, 0, 0, 3] = 3e38
    return x


@pytest.mark.parametrize("kind", ["random", "zeros", "ties", "large"])
def test_quantize_kv_matches_jax_bit_for_bit(kind):
    jx = jnp.asarray(_rows(kind), jnp.bfloat16)
    tx = bridge.to_torch(np.asarray(jx))
    jq, js = jax.jit(jattn._quantize_kv)(jx)
    tq, ts = tattn.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16 and ts.shape == tx.shape[:-1]
    np.testing.assert_array_equal(_bits(tq), _jbits(jq))
    np.testing.assert_array_equal(_bits(ts), _jbits(js))
    jd = jax.jit(jattn._dequantize_kv)(jq, js)
    np.testing.assert_array_equal(_bits(tattn.dequantize_kv(tq, ts)), _jbits(jd))
    if kind == "ties":      # half to even, as jnp.round
        assert set(np.unique(np.abs(_bits(tq)[..., 1:]) % 2)) == {0}


@pytest.mark.parametrize("layout", ["wave", "ring", "targets"])
def test_kv_quant_write_plain_lands_where_its_targets_say(layout):
    """The plain kv_quant_write: the quantized bytes and scales of every
    written token at its destination, nothing else touched, dropped tokens
    nowhere; the dequantized fresh K/V it returns are ``dequantize_kv`` of
    them."""
    b, h, s, hd, n, m = 2, 3, 6, 64, 5, 8
    gen = torch.Generator().manual_seed(1)
    k, v = (torch.randn((b, s, h, hd), generator=gen).bfloat16().transpose(1, 2)
            for _ in range(2))                        # strided, as gqa_heads gives them
    if layout == "wave":
        dst = tattn.quant_targets(b, s, "cpu", wave_pos=2)
    elif layout == "ring":
        dst = tattn.quant_targets(b, s, "cpu", ring_idx=torch.tensor([7, 0, 1, 2]))
    else:                       # (row, index) pairs for tokens 1, 4, 9 and 11
        src = torch.tensor([1, 4, 9, 11])
        dst = tattn.quant_targets(b, s, "cpu", targets=(torch.tensor([4, 0, 2, 2]),
                                                        torch.tensor([3, 5, 0, 7])), src=src)
    kc, vc = (torch.full((n, h, m, hd), 99, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.full((n, h, m), -1.0).bfloat16() for _ in range(2))
    kd, vd = ops.kv_quant_write(k, v, kc, vc, ks, vs, *dst, dequantized=True)
    written = torch.zeros((n, m), dtype=torch.bool)
    for x, cache, scales, deq in ((k, kc, ks, kd), (v, vc, vs, vd)):
        q, sc = tattn.quantize_kv(x)
        assert torch.equal(deq, tattn.dequantize_kv(q, sc))
        for t in range(b * s):
            row, idx = int(dst[0][t]), int(dst[1][t])
            if row < 0:
                continue
            written[row, idx] = True
            assert torch.equal(cache[row, :, idx], q[t // s, :, t % s])
            assert torch.equal(scales[row, :, idx], sc[t // s, :, t % s])
        assert (cache.permute(0, 2, 1, 3)[~written] == 99).all()
    want = {"wave": b * s, "ring": b * 4, "targets": 4}[layout]
    assert int(written.sum()) == want
    assert ops.kv_quant_write(k, v, kc, vc, ks, vs, *dst) is None


@pytest.fixture(scope="module", params=["yi-9b-gqa", "qwen-72b-int4"])
def quant_pair(request):
    """(JAX engine with kv_quant, its numpy tree, port cfg, bridged params)."""
    arch, over, mode = {"yi-9b-gqa": ("yi-9b", GQA, "none"),
                        "qwen-72b-int4": ("qwen-72b", {}, "int4")}[request.param]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    eng, tree = jax_engine(jcfg, max_len=32, weight_quant=mode, kv_quant=True)
    return eng, tree, tcfg, bridge.params_from_jax(tree, tcfg, device="cpu")


def test_prefill_and_decode_logits_match_jax(quant_pair):
    eng, _, cfg, params = quant_pair
    assert eng.ctx.parallel.kv_quant
    assert_logits_match(eng, cfg, params, kv_quant=True)


def test_reset_slots_zeroes_dense_scales_only():
    cfg = get_config("yi-9b").reduced()
    dense = TM.init_caches(cfg, 3, 16, device="cpu", per_slot=True, kv_quant=True)
    pool = TM.init_caches(cfg, 3, 16, device="cpu", paged=(5, 8), kv_quant=True)
    for c in (dense, pool):
        for key in kvcache.SCALE_KEYS:
            c[key].fill_(0.5)
    mask = np.array([False, True, False])
    kvcache.reset_slots(dense, mask)
    kvcache.reset_slots(pool, mask, paged=True)
    for key in kvcache.SCALE_KEYS:
        assert (dense[key][:, 1] == 0).all() and (dense[key][:, [0, 2]] == 0.5).all()
        assert (pool[key] == 0.5).all()
    assert (dense["pos"][1] == -1).all() and (pool["pos"][1] == -1).all()
    # a pool's bytes include its scales
    assert kvcache.cache_bytes(pool) == sum(t.numel() * t.element_size() for t in pool.values())
    assert kvcache.cache_bytes(pool) > pool["k"].numel() * 2


# ---------------------------------------------------------------------------
# The hybrid: int8 weights and the int8 KV cache
# ---------------------------------------------------------------------------

MAX_LEN, PLEN, STEPS = 96, 80, 16


@pytest.fixture(scope="module")
def hybrid():
    """(JAX engine, numpy tree, port cfg, port params) of the reduced hybrid
    with int8 weights and the int8 KV cache."""
    jcfg = jget_config("recurrentgemma-9b").reduced()
    tcfg = get_config("recurrentgemma-9b").reduced()
    jeng, tree = hybrid_engine(jcfg, MAX_LEN, weight_quant="int8", kv_quant=True)
    return jeng, tree, tcfg, bridge.params_from_jax(tree, tcfg, device="cpu")


def _hybrid_worst(cfg, params, jl_all, prompts) -> float:
    """The largest |port - JAX| over the prefill's and every teacher-forced
    decode step's logits."""
    pq = ParallelConfig(weight_quant="int8", kv_quant=True)
    tc = TM.init_caches(cfg, prompts.shape[0], MAX_LEN, device="cpu", kv_quant=pq.kv_quant)
    with torch.inference_mode():
        tl = TM.forward(params, torch.from_numpy(prompts).long(), cfg, caches=tc)
        worst = float(np.abs(tl.numpy() - jl_all[0]).max())
        for step in range(STEPS):
            tok = jl_all[step][:, -1].argmax(-1)
            tl = TM.forward(params, torch.from_numpy(tok).long()[:, None], cfg, caches=tc,
                            cur_pos=PLEN + step)
            worst = max(worst, float(np.abs(tl.numpy()[:, -1] - jl_all[step + 1][:, -1]).max()))
    return worst


def test_hybrid_int8_weights_and_kv_match_jax_and_faults_fail(hybrid, monkeypatch):
    jeng, _, cfg, params = hybrid
    assert isinstance(params["layers"][0]["w_up"], QuantWeight)           # an RG-LRU layer's FFN
    assert isinstance(params["layers"][2]["w_q"], QuantWeight)            # the local_attn layer
    assert not isinstance(params["layers"][0]["mixer"]["w_x"], QuantWeight)
    ctx = jeng.ctx
    pspecs = JM.param_specs(ctx)
    cspec = jkvcache.cache_pspecs(ctx, kv_seq_shard=False)
    sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)

    def pre(p, t, c):
        logits, c, _ = JM.forward(p, t, ctx, caches=c, seq_sharded=True)
        return logits, c

    def dec(p, t, c, cur):
        logits, c, _ = JM.forward(p, t[:, None], ctx, caches=c, cur_pos=cur)
        return logits, c

    jpre = jax.jit(sm(pre, in_specs=(pspecs, P("data", None), cspec),
                      out_specs=(P("data", None, None), cspec)))
    jdec = jax.jit(sm(dec, in_specs=(pspecs, P("data"), cspec, P()),
                      out_specs=(P("data", None, None), cspec)))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, PLEN)).astype(np.int32)
    default, exact = reference_logits(jeng, prompts)
    tol = max(TOL, float(np.abs(default - exact).max()))
    assert tol < 0.2                                   # the reference's rounding, not drift
    jl, jc = jpre(jeng.params, jnp.asarray(prompts), jeng.init_caches(2))
    jl_all = [np.asarray(jl)]
    for step in range(STEPS):
        jl, jc = jdec(jeng.params, jnp.asarray(jl_all[-1][:, -1].argmax(-1).astype(np.int32)),
                      jc, jnp.int32(PLEN + step))
        jl_all.append(np.asarray(jl))
    assert "k_scale" in next(g["sub2"] for g in jc if "sub2" in g)
    sound = _hybrid_worst(cfg, params, jl_all, prompts)
    assert sound <= tol, f"logits differ by {sound} > {tol}"

    real_targets = tattn.quant_targets

    def clamped(b, s, device, wave_pos=None, **kw):     # decode writes at S - 1, not p % S
        if wave_pos is not None and s == 1:
            wave_pos = cfg.window - 1
        return real_targets(b, s, device, wave_pos=wave_pos, **kw)

    real_prefill = ops.flash_prefill
    faults = {"ring index clamped": (tattn, "quant_targets", clamped),
              "window dropped": (tattn.ops, "flash_prefill",
                                 lambda *a, window=0, **kw: real_prefill(*a, **kw))}
    for name, (mod, attr, fn) in faults.items():
        with monkeypatch.context() as mp:
            mp.setattr(mod, attr, fn)
            worst = _hybrid_worst(cfg, params, jl_all, prompts)
        assert worst > tol, f"{name}: the planted fault reads {worst} <= {tol}"


# ---------------------------------------------------------------------------
# The packed-weight checkpoint (--wq-cache)
# ---------------------------------------------------------------------------


def _assert_params_equal(a, b):
    def leaves(p):
        out = {"table": p["embed"]["table"], "final_norm": p["final_norm"],
               "lm_head": p["lm_head"]}
        for i, layer in enumerate(p["layers"]):
            for k, t in layer.items():
                for kk, tt in (t.items() if isinstance(t, dict) else [(None, t)]):
                    out[f"{i}.{k}.{kk}"] = tt
        return out
    la, lb = leaves(a), leaves(b)
    assert sorted(la) == sorted(lb)
    for key in la:
        x, y = la[key], lb[key]
        assert isinstance(x, QuantWeight) == isinstance(y, QuantWeight), key
        pairs = ([(x.q, y.q), (x.scale, y.scale)] if isinstance(x, QuantWeight) else [(x, y)])
        if isinstance(x, QuantWeight):
            assert (x.mode, x.group, x.k) == (y.mode, y.group, y.k), key
        for s, t in pairs:
            assert s.dtype == t.dtype and s.shape == t.shape, key
            np.testing.assert_array_equal(_bits(s), _bits(t), err_msg=key)


@pytest.mark.parametrize("arch,layers,mode", [("yi-9b", None, "int4"),
                                              ("recurrentgemma-9b", 5, "int8")])
def test_wq_cache_round_trip_is_bit_exact(tmp_path, arch, layers, mode):
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    par = ParallelConfig(weight_quant=mode)
    path = str(tmp_path / "wq")
    first = Engine(cfg, parallel=par, max_len=32, seed=3, device="cpu", wq_cache=path)
    assert checkpoint.has_quantized(path)
    again = Engine(cfg, parallel=par, max_len=32, seed=4, device="cpu", wq_cache=path)
    _assert_params_equal(first.params, again.params)
    fresh = Engine(cfg, parallel=par, max_len=32, seed=4, device="cpu")
    with pytest.raises(AssertionError):                 # it was read, not drawn again
        _assert_params_equal(fresh.params, again.params)
    for wrong in (dataclasses.replace(par, wq_group_size=64),
                  dataclasses.replace(par, weight_quant="int8" if mode == "int4" else "int4")):
        with pytest.raises(ValueError, match="packed for"):
            Engine(cfg, parallel=wrong, max_len=32, device="cpu", wq_cache=path)
    other = dataclasses.replace(cfg, name="another-arch")
    with pytest.raises(ValueError, match="packed for"):
        checkpoint.load_quantized(path, other, par, device="cpu")


def test_jax_saved_wq_cache_loads(tmp_path, quant_pair, hybrid):
    """Files that the JAX package's ``save_quantized`` wrote (meta
    ``backend`` included): qwen-72b int4 and the hybrid int8."""
    for jeng, tree, cfg, params in (quant_pair, hybrid):
        if jeng.ctx.parallel.weight_quant == "none":
            continue
        path = str(tmp_path / cfg.name)
        JM.save_quantized(jeng.ctx, jeng.params, path)
        par = ParallelConfig(weight_quant=jeng.ctx.parallel.weight_quant,
                             wq_group_size=jeng.ctx.parallel.wq_group_size)
        loaded = checkpoint.load_quantized(path, cfg, par, device="cpu")
        _assert_params_equal(loaded, bridge.params_from_jax(tree, cfg, device="cpu"))
        eng = Engine(cfg, parallel=par, max_len=32, device="cpu", wq_cache=path,
                     sampling=SamplingConfig(top_k=1))
        _assert_params_equal(eng.params, params)
