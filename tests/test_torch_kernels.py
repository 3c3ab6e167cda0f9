"""The port's plain kernel versions against the JAX package's Pallas kernels
(interpret mode) and pure-jnp oracles, on the same numpy inputs.

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these same plain versions there.  Tolerances are those of
``tests/test_kernels.py``: 1e-5 in fp32 and 3e-2 in bf16 (one bf16 ulp at
|x| ~ 4 is 1.6e-2, and bf16 outputs round once on each side).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_causal_attention
from repro_torch.kernels import build, ops

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch CPU tensor of one dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,hd,n_pad", [
    (2, 4, 4, 37, 37, 64, 0),     # g = 1 (MHA), odd lengths
    (1, 8, 2, 20, 50, 64, 3),     # g = 4, Sq < Sk (queries at the stripe's end), pad rows
    (2, 16, 2, 9, 130, 128, 2),   # g = 8, Sk past one 128 block, pad rows
])
def test_flash_prefill_plain_matches_jax(b, hq, hkv, sq, sk, hd, n_pad, dtype):
    rng = np.random.default_rng(sq * sk + hd)
    jq, tq = _both(rng.standard_normal((b, hq, sq, hd)), dtype)
    jk, tk = _both(rng.standard_normal((b, hkv, sk, hd)), dtype)
    jv, tv = _both(rng.standard_normal((b, hkv, sk, hd)), dtype)
    qpos = np.broadcast_to(np.arange(sk - sq, sk, dtype=np.int32), (b, sq)).copy()
    if n_pad:
        qpos[-1, -n_pad:] = -1
    scale = 1.0 / np.sqrt(hd)
    out = ops.flash_prefill(tq, tk, tv, torch.from_numpy(qpos), scale)
    assert out.dtype == tq.dtype and out.shape == (b, hq, sq, hd)
    tol = DTYPES[dtype][2]
    kernel = jops.flash_prefill(jq, jk, jv, jnp.asarray(qpos), scale)
    oracle = chunked_causal_attention(jq, jk, jv, jnp.asarray(qpos),
                                      jnp.arange(sk, dtype=jnp.int32), 0, scale)
    np.testing.assert_allclose(_np(out), _np(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)
    if n_pad:
        assert not _np(out)[-1, :, -n_pad:].any()      # pad rows are exact zeros


def _decode_inputs(b, hq, hkv, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    jq, tq = _both(rng.standard_normal((b, hq, 1, hd)), dtype)
    jk, tk = _both(rng.standard_normal((b, hkv, S, hd)), dtype)
    jv, tv = _both(rng.standard_normal((b, hkv, S, hd)), dtype)
    return (jq, jk, jv), (tq, tk, tv)


def _normalized(m, l, acc):
    return _np(acc) / np.maximum(_np(l)[..., None], 1e-30), _np(m)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,S,hd", [
    (1, 4, 4, 200, 64),           # S not a multiple of 128
    (2, 8, 2, 300, 64),
    (2, 16, 2, 130, 128),         # g = 8 over a ragged tail
])
def test_decode_attention_plain_matches_jax(b, hq, hkv, S, hd, dtype):
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(b, hq, hkv, S, hd, dtype, S + hd)
    valid = np.arange(S) < (S * 3) // 4
    scale = 1.0 / np.sqrt(hd)
    m, l, acc = ops.decode_attention_partial(tq, tk, tv, torch.from_numpy(valid), scale)
    assert m.shape == l.shape == (b, hq, 1) and acc.shape == (b, hq, 1, hd)
    assert m.dtype == l.dtype == acc.dtype == torch.float32
    tol = DTYPES[dtype][2]
    o, mm = _normalized(m, l, acc)
    for other in (jops.decode_attention_partial(jq, jk, jv, jnp.asarray(valid), scale),
                  jref.decode_attention_ref(jq, jk, jv, jnp.asarray(valid), scale)):
        o2, m2 = _normalized(*other)
        np.testing.assert_allclose(o, o2, atol=tol, rtol=tol)
        np.testing.assert_allclose(mm, m2, atol=tol, rtol=tol)


def test_decode_attention_plain_fully_masked_and_per_row_mask():
    """The partials contract of tests/test_kernels.py: a row with no valid
    key has m = -inf and l = 0.  A per-row (b, S) mask equals the shared-
    mask oracle row by row."""
    b, hq, hkv, S, hd = 3, 8, 2, 150, 64
    (jq, jk, jv), (tq, tk, tv) = _decode_inputs(b, hq, hkv, S, hd, "fp32", 7)
    lens = np.array([150, 0, 41])
    valid = np.arange(S)[None, :] < lens[:, None]
    m, l, acc = ops.decode_attention_partial(tq, tk, tv, torch.from_numpy(valid), 0.125)
    assert np.isneginf(_np(m)[1]).all() and not _np(l)[1].any() and not _np(acc)[1].any()
    for i in (0, 2):
        m2, l2, a2 = jref.decode_attention_ref(jq[i:i + 1], jk[i:i + 1], jv[i:i + 1],
                                               jnp.asarray(valid[i]), 0.125)
        np.testing.assert_allclose(_np(m)[i:i + 1], _np(m2), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(l)[i:i + 1], _np(l2), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(acc)[i:i + 1], _np(a2), atol=1e-4, rtol=1e-5)
    m1, l1, _ = ops.decode_attention_partial(tq, tk, tv, torch.zeros(S, dtype=torch.bool), 0.125)
    assert np.isneginf(_np(m1)).all() and not _np(l1).any()


def _paged_inputs(b, hq, hkv, hd, nb, bs, nbps, sq, seed):
    """q, pools and a shuffled block table with null entries (0): slot 0's
    table is a random permutation of pool blocks, the other slots take
    random blocks, some of them the null block."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, hd))
    kp, vp = rng.standard_normal((2, nb, hkv, bs, hd))
    bt = rng.integers(1, nb, (b, nbps)).astype(np.int32)
    bt[0] = rng.permutation(np.arange(1, nb))[:nbps]
    bt[1:, ::3] = 0                                   # null entries
    return rng, q, kp, vp, bt


def _jt(a):
    """The same fp32 values as a jax array and a torch CPU tensor."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# Paged kernels: tolerance 2e-5 on fp32 inputs (both sides sum the same
# products in fp32, in another order; outputs are O(1)).
PAGED_TOL = 2e-5


@pytest.mark.parametrize("b,hq,hkv,hd,nb,bs,nbps", [
    (3, 4, 4, 64, 20, 8, 6),      # g = 1, hd 64
    (2, 16, 2, 128, 12, 16, 5),   # g = 8, hd 128
    (3, 8, 1, 64, 40, 4, 9),      # g = 8, small blocks
])
def test_paged_decode_attention_plain_matches_jax(b, hq, hkv, hd, nb, bs, nbps):
    """Per-slot masks over shuffled tables: a ragged valid prefix, a fully
    dead block in the middle of slot 0, and a slot with no valid key."""
    rng, q, kp, vp, bt = _paged_inputs(b, hq, hkv, hd, nb, bs, nbps, 1, nb + bs)
    S = nbps * bs
    lens = rng.integers(1, S + 1, b)
    valid = np.arange(S)[None, :] < lens[:, None]
    valid[0] = np.arange(S) < S - 1
    valid[0, bs:2 * bs] = False                       # a dead block
    valid[-1] = False                                 # no valid key at all
    scale = 1.0 / np.sqrt(hd)
    (jq, tq), (jk, tk), (jv, tv) = _jt(q), _jt(kp), _jt(vp)
    m, l, acc = ops.paged_decode_attention_partial(tq, tk, tv, torch.from_numpy(bt),
                                                   torch.from_numpy(valid), scale)
    assert m.dtype == l.dtype == acc.dtype == torch.float32 and acc.shape == (b, hq, 1, hd)
    jm, jl, jacc = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(bt), jnp.asarray(valid),
                                               scale)
    for got, want in ((m, jm), (l, jl), (acc, jacc)):
        np.testing.assert_allclose(_np(got), _np(want), atol=PAGED_TOL, rtol=PAGED_TOL)
    assert np.isneginf(_np(m)[-1]).all() and not _np(l)[-1].any() and not _np(acc)[-1].any()


@pytest.mark.parametrize("sq", [1, 2, 9])
@pytest.mark.parametrize("b,hq,hkv,hd,nb,bs,nbps", [
    (2, 4, 4, 64, 16, 8, 5),      # g = 1, hd 64
    (3, 16, 2, 128, 24, 16, 4),   # g = 8, hd 128
])
def test_paged_flash_prefill_plain_matches_jax(b, hq, hkv, hd, nb, bs, nbps, sq):
    """A suffix of sq tokens after a per-slot cached prefix (view index ==
    position), through shuffled tables with null entries past the prefix;
    one pad row (q_pos -1) comes out as exact zeros."""
    rng, q, kp, vp, bt = _paged_inputs(b, hq, hkv, hd, nb, bs, nbps, sq, nb * sq + hd)
    starts = rng.integers(0, nbps * bs - sq + 1, b)
    q_pos = (starts[:, None] + np.arange(sq)[None, :]).astype(np.int32)
    q_pos[-1, -1] = -1
    scale = 1.0 / np.sqrt(hd)
    (jq, tq), (jk, tk), (jv, tv) = _jt(q), _jt(kp), _jt(vp)
    out = ops.paged_flash_prefill(tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(q_pos), scale)
    assert out.dtype == torch.float32 and out.shape == (b, hq, sq, hd)
    want = jops.paged_flash_prefill(jq, jk, jv, jnp.asarray(bt), jnp.asarray(q_pos), scale)
    np.testing.assert_allclose(_np(out), _np(want), atol=PAGED_TOL, rtol=PAGED_TOL)
    assert not _np(out)[-1, :, -1].any()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 8, 40])
@pytest.mark.parametrize("b,v", [(3, 500), (2, 9504)])
def test_topk_plain_matches_jax(b, v, k, dtype):
    rng = np.random.default_rng(b * v + k)
    jx, tx = _both(rng.standard_normal((b, v)), dtype)
    vals, idx = ops.topk(tx, k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    for jv_, ji in (jops.topk(jx, k), jref.topk_ref(jx, k)):
        np.testing.assert_array_equal(_np(vals), np.asarray(jv_))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_topk_plain_ties_go_to_lowest_index():
    """Greedy is idx[:, 0]: among equal values the lowest index comes first,
    as in the Pallas kernel (an all-equal row gives 0..k-1)."""
    x = np.zeros((2, 600), np.float32)
    x[1] = np.random.default_rng(0).integers(0, 4, 600)
    vals, idx = ops.topk(torch.from_numpy(x), 40)
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(40))
    jv_, ji = jops.topk(jnp.asarray(x), 40)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv_))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [1, 8, 40])
@pytest.mark.parametrize("b,v", [(4, 1100), (3, 9504)])
def test_topk_plain_nan_rows_match_jax(b, v, k, dtype):
    """NaN ranks above +inf, NaNs by index, in the Pallas kernel, the JAX
    oracle and the plain version alike: NaN on either side of a Pallas
    tile edge (512), a row of NaN (indices 0..k-1), NaN beside -inf and
    +inf, -0 beside +0."""
    rng = np.random.default_rng(b * v + k)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[0, [511, 512, v - 1]] = np.nan
    x[1] = np.nan
    x[2, [3, 4, 5]] = [np.inf, np.nan, -np.inf]
    x[2, 6], x[2, 7] = -0.0, 0.0
    jx, tx = _both(x, dtype)
    vals, idx = ops.topk(tx, k)
    np.testing.assert_array_equal(idx[1].numpy(), np.arange(k))
    assert idx[0, 0] == 511 and idx[2, 0] == 4
    for jv_, ji in (jops.topk(jx, k), jref.topk_ref(jx, k)):
        np.testing.assert_array_equal(_np(vals), np.asarray(jv_))   # NaN == NaN here
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_wrappers_check_their_arguments():
    q = torch.zeros(1, 4, 5, 64)
    with pytest.raises(ValueError):
        ops.flash_prefill(q, torch.zeros(1, 3, 5, 64), torch.zeros(1, 3, 5, 64),
                          torch.zeros(1, 5, dtype=torch.int32), 0.1)
    with pytest.raises(ValueError):
        ops.decode_attention_partial(q[:, :, :1], torch.zeros(1, 2, 7, 64),
                                     torch.zeros(1, 2, 7, 64), torch.ones(8, dtype=torch.bool), 0.1)
    with pytest.raises(ValueError):
        ops.topk(torch.zeros(2, 5), 6)
    pool = torch.zeros(6, 2, 8, 64)
    with pytest.raises(ValueError):                   # table rows != batch
        ops.paged_decode_attention_partial(q[:, :, :1], pool, pool, torch.zeros(2, 3, dtype=torch.int32),
                                           torch.ones(1, 24, dtype=torch.bool), 0.1)
    with pytest.raises(ValueError):                   # mask longer than the view
        ops.paged_decode_attention_partial(q[:, :, :1], pool, pool, torch.zeros(1, 3, dtype=torch.int32),
                                           torch.ones(1, 25, dtype=torch.bool), 0.1)
    with pytest.raises(ValueError):                   # q heads not a multiple of kv heads
        ops.paged_flash_prefill(torch.zeros(1, 3, 5, 64), pool, pool,
                                torch.zeros(1, 3, dtype=torch.int32), torch.zeros(1, 5, dtype=torch.int32), 0.1)


def test_build_signatures_match_the_c_sources():
    """The ctypes argtypes must have one entry per C parameter: a missing
    one would pass a pointer as a 32-bit int.  (nvcc exists only on the
    machine with the card, so this is the check the CPU can make.)"""
    exported = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            exported[name] = (src.stem, len([p for p in params.split(",") if p.strip()]))
    assert exported == {name: (src, len(args)) for name, (src, args) in build.SIGNATURES.items()}
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
    assert build.library_path("topk") == build.library_path("topk")
    assert build.library_path("topk").parent == build.BUILD_DIR
