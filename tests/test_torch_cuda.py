"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc and skip without them.  The file imports
no jax, so on the machine with the card it runs without the repository's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes cover what the main path does not: head_dim 64 and 256 (256 in every
layout: gptj-parallel's 16 MHA heads), ragged tails, pad
rows, g from 1 to 16, per-row masks with a fully masked row, verify
chunks of 1 to 8 queries over slot stripes read through a row index with
frontiers at 0, mid-stripe and the stripe's end, paged pools
read through shuffled block tables with null entries and dead blocks,
suffixes of 1, 2 and 9 tokens after a cached prefix, tie-heavy
top-k rows over vocabularies up to qwen's 152064, and dequant matmuls at
every instance width (T up to 64 padded to 8, 16, 32 or 64 rows; 65 to
512 on the wide tiles), split and unsplit K, ragged N and K, groups 64
and 128 and groups that are no whole 16-row step, and unaligned
per-layer views.  The tensor-core prefill body at its tiles' edges (query
and key counts of 1, 15-17, 63-65 and 2304, windows whose band starts on
a 64-key tile, tables whose 64-key tile gathers 4 pool blocks, dead
splits) is held per element to 2e-3 + 1e-2 |want|, chip_smoke.py's rule;
the split decode at S not a multiple of its chunk, wholly masked splits,
rows with no valid key, an unsplit grid, counters back at 0 after
back-to-back launches, and refused plans.  Tolerances: bf16 3e-2 as in
tests/test_kernels.py; fp32
1e-4, since the kernel and the plain version sum up to a thousand terms in
different orders.  The dequant matmul's products are exact in fp32, so its
fp32 output is held to 1e-4 of the largest output (sums over K up to 8192
in another order), and its bf16 output must be the kernel's own fp32
output rounded, bit for bit.  fused_dual_matmul: fp32 1e-4 (sums over K
up to 20480 in another order); bf16 1e-2 abs + 1e-2 rel, one output
rounding apart (one bf16 ulp is at most 7.8e-3 of a value).
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro_torch.core import wquant
from repro_torch.kernels import build, ops, ref


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 3e-2


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,hd", [
    (2, 4, 4, 37, 37, 64), (1, 8, 2, 20, 50, 64), (2, 16, 2, 9, 130, 128),
    (3, 32, 4, 70, 70, 128), (1, 8, 8, 200, 333, 128),
])
def test_flash_prefill_kernel(dev, b, hq, hkv, sq, sk, hd, dtype):
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q = _randn(gen, (b, hq, sq, hd), dtype, dev)
    k, v = _randn(gen, (b, hkv, sk, hd), dtype, dev), _randn(gen, (b, hkv, sk, hd), dtype, dev)
    q_pos = torch.arange(sk - sq, sk, device=dev, dtype=torch.int32).repeat(b, 1)
    q_pos[-1, -3:] = -1                      # pad rows
    if b > 1:
        q_pos[0] = -1                        # a whole row of padding
    before = ops.LAUNCHES["flash_prefill"]
    got = ops.flash_prefill(q, k, v, q_pos, hd ** -0.5)
    assert ops.LAUNCHES["flash_prefill"] == before + 1
    want = ref.flash_prefill_ref(q, k, v, q_pos, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[-1, :, -3:].any()


def _stripe_case(gen, dev, dtype, b, hq, hkv, sq, S, hd, n_cache):
    """q, a slot cache of n_cache stripes, a row index naming b distinct
    stripes (reversed order) and chunk positions: row 0 at the stripe's
    start (its first query sees one key), row 1 ending at S - 1, the others
    at random frontiers; the last row's last query is a pad row."""
    q = _randn(gen, (b, hq, sq, hd), dtype, dev)
    k = _randn(gen, (n_cache, hkv, S, hd), dtype, dev)
    v = _randn(gen, (n_cache, hkv, S, hd), dtype, dev)
    rows = torch.randperm(n_cache, generator=gen, device=dev)[:b].flip(0).to(torch.int32)
    starts = torch.randint(0, S - sq + 1, (b,), generator=gen, device=dev)
    starts[0] = 0
    if b > 1:
        starts[1] = S - sq
    q_pos = (starts[:, None] + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
    q_pos[-1, -1] = -1
    return q, k, v, rows.contiguous(), q_pos.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("sq", [1, 2, 5, 8])
@pytest.mark.parametrize("b,hq,hkv,S", [(4, 32, 4, 256), (3, 4, 4, 100), (2, 16, 8, 1000),
                                         (5, 8, 1, 70)])
def test_flash_verify_kernel(dev, b, hq, hkv, S, sq, hd, dtype):
    """g = 8, 1, 2 and 8; stripes of 70..1000 keys (one split or many);
    a 6-slot cache read through a row index."""
    gen = torch.Generator(device=dev).manual_seed(S * sq + hd)
    q, k, v, rows, q_pos = _stripe_case(gen, dev, dtype, b, hq, hkv, sq, S, hd, 6)
    before = ops.LAUNCHES["flash_verify"]
    got = ops.flash_verify(q, k, v, q_pos, hd ** -0.5, rows=rows)
    assert ops.LAUNCHES["flash_verify"] == before + 2          # split pass and merge
    want = ref.flash_verify_ref(q, k[rows.long()], v[rows.long()], q_pos, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[-1, :, -1].any()


def test_flash_verify_fully_masked_rows_and_refused_launch(dev):
    """A row whose queries are all padding comes out as exact zeros, and so
    does a row whose index lies outside the cache; a launch past the
    65535 blocks of the grid's second dimension raises."""
    gen = torch.Generator(device=dev).manual_seed(1)
    q = _randn(gen, (3, 8, 4, 128), torch.bfloat16, dev)
    k = _randn(gen, (2, 2, 64, 128), torch.bfloat16, dev)
    q_pos = torch.tensor([[-1] * 4, [3, 4, 5, 6], [60, 61, 62, 63]], dtype=torch.int32,
                         device=dev)
    rows = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)    # row 2 is no stripe
    got = ops.flash_verify(q, k, k, q_pos, 0.1, rows=rows)
    want = ref.flash_verify_ref(q[:2], k, k, q_pos[:2], 0.1)
    torch.cuda.synchronize()
    assert not got[0].any() and not got[2].any()
    torch.testing.assert_close(got[:2].float(), want.float(), atol=3e-2, rtol=3e-2)
    b = 65536 // 4 + 1
    pool = torch.zeros(1, 4, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash_verify"):
        ops.flash_verify(torch.zeros(b, 4, 1, 64, device=dev, dtype=torch.bfloat16), pool, pool,
                         torch.zeros(b, 1, dtype=torch.int32, device=dev), 0.1,
                         rows=torch.zeros(b, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,S,hd", [(4, 32, 4, 64, 256, 128), (3, 8, 2, 9, 100, 64),
                                              (2, 4, 4, 130, 300, 64)])
def test_flash_prefill_kernel_through_rows(dev, b, hq, hkv, sq, S, hd, dtype):
    """A chunk of admitted slots attending their stripes of a slot cache
    through the row index, as chunked admission does."""
    gen = torch.Generator(device=dev).manual_seed(sq + S)
    q, k, v, rows, q_pos = _stripe_case(gen, dev, dtype, b, hq, hkv, sq, S, hd, 5)
    before = ops.LAUNCHES["flash_prefill"]
    got = ops.flash_prefill(q, k, v, q_pos, hd ** -0.5, rows=rows)
    assert ops.LAUNCHES["flash_prefill"] == before + 1
    want = ref.flash_prefill_ref(q, k[rows.long()], v[rows.long()], q_pos, hd ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[-1, :, -1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,S,hd,per_row", [
    (1, 4, 4, 77, 64, False), (2, 8, 2, 300, 64, True), (4, 32, 4, 512, 128, False),
    (3, 16, 1, 1000, 128, True), (2, 12, 4, 33, 128, True),
])
def test_decode_attention_kernel(dev, b, hq, hkv, S, hd, per_row, dtype):
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q = _randn(gen, (b, hq, 1, hd), dtype, dev)
    k, v = _randn(gen, (b, hkv, S, hd), dtype, dev), _randn(gen, (b, hkv, S, hd), dtype, dev)
    if per_row:
        lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
        lens[0] = 0                          # a fully masked row
        valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    else:
        valid = torch.arange(S, device=dev) < (3 * S) // 4
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, hd ** -0.5)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, hd ** -0.5)
    torch.cuda.synchronize()
    tol = 1e-4
    torch.testing.assert_close(m, m2, atol=tol, rtol=tol)      # -inf rows included
    torch.testing.assert_close(l, l2, atol=tol, rtol=tol)
    torch.testing.assert_close(acc, acc2, atol=1e-3, rtol=tol)
    if per_row:
        assert torch.isneginf(m[0]).all() and not l[0].any() and not acc[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 40, 64])
@pytest.mark.parametrize("rows,n,ties", [
    (3, 500, False), (2, 4096, True), (2, 4097, False), (4, 64000, False),
    (4, 64000, True), (2, 152064, True),
])
def test_topk_kernel(dev, rows, n, ties, k, dtype):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    if ties:                                 # a handful of distinct values
        x = torch.randint(0, 5, (rows, n), generator=gen, device=dev).to(dtype)
        x[0] = 0                             # all equal: indices 0..k-1
        x[-1, n // 2] = float("-inf")
    else:
        x = _randn(gen, (rows, n), dtype, dev)
    vals, idx = ops.topk(x, k)
    rv, ri = ref.topk_ref(x, k)
    torch.cuda.synchronize()
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    if ties:
        assert torch.equal(idx[0].cpu(), torch.arange(k, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 40, 256])
@pytest.mark.parametrize("rows,n", [(1, 500), (3, 9000), (2, 64000), (4, 64000), (4, 256000),
                                    (300, 600)])
def test_topk_kernel_nan_rows_in_one_launch(dev, rows, n, k, dtype):
    """NaN ranks above +inf, NaNs by index (a row of NaN gives 0..k-1), as
    the plain version on the CPU orders them; the values are the input's
    own bits.  rows x chunks from 2 to 600 blocks (the SMs: 132), each
    call one launch."""
    gen = torch.Generator(device=dev).manual_seed(rows * n + k)
    x = _randn(gen, (rows, n), dtype, dev)
    x[0, [n // 3, n // 3 + 1, n - 1]] = float("nan")
    x[0, :5] = float("-inf")
    if rows > 1:
        x[1] = float("nan")
    chunk, n_chunks = ops.topk_chunk_plan(rows, n, k, ops._sm_count(x.device))
    before = ops.LAUNCHES["topk"]
    vals, idx = ops.topk(x, k)
    assert ops.LAUNCHES["topk"] == before + 1
    rv, ri = ref.topk_ref(x.cpu(), k)
    torch.cuda.synchronize()
    assert torch.equal(vals.cpu().view(torch.int32), rv.view(torch.int32))
    assert torch.equal(idx.cpu(), ri)
    assert idx[0, 0].item() == n // 3
    if rows > 1:
        assert torch.equal(idx[1].cpu(), torch.arange(k, dtype=torch.int32))
    below = (rows, n) in ((1, 500), (3, 9000)) or (k == 256 and n == 64000)
    assert (rows * n_chunks < 132) == below


def _paged(gen, dev, dtype, b, hq, hkv, hd, nb, bs, nbps, sq):
    """q, pools and block tables: shuffled pool blocks, every third entry
    of the later slots the null block 0."""
    q = _randn(gen, (b, hq, sq, hd), dtype, dev)
    kp, vp = _randn(gen, (nb, hkv, bs, hd), dtype, dev), _randn(gen, (nb, hkv, bs, hd), dtype, dev)
    bt = torch.stack([torch.randperm(nb - 1, generator=gen, device=dev)[:nbps] + 1
                      for _ in range(b)]).to(torch.int32)
    bt[1:, ::3] = 0
    return q, kp, vp, bt.contiguous()


# (b, hq, hkv, hd, nb, bs, nbps): yi-9b's heads at b = 4 over a 256-token
# view, g = 1 at head_dim 64, small blocks, gptj-parallel's 16 MHA heads of
# 256, and g = 2 at head_dim 256
PAGED_CASES = [(4, 32, 4, 128, 80, 16, 16), (3, 4, 4, 64, 40, 8, 9), (2, 16, 2, 128, 64, 4, 33),
               (4, 16, 16, 256, 80, 16, 16), (2, 4, 2, 256, 40, 8, 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,hd,nb,bs,nbps", PAGED_CASES)
def test_paged_decode_attention_kernel(dev, b, hq, hkv, hd, nb, bs, nbps, dtype):
    gen = torch.Generator(device=dev).manual_seed(nb + bs)
    q, kp, vp, bt = _paged(gen, dev, dtype, b, hq, hkv, hd, nb, bs, nbps, 1)
    S = nbps * bs
    lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    valid[0, bs:3 * bs] = False                # dead blocks inside the valid run
    valid[-1] = False                          # a slot with no valid key
    before = ops.LAUNCHES["paged_decode_attention"]
    m, l, acc = ops.paged_decode_attention_partial(q, kp, vp, bt, valid, hd ** -0.5)
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    m2, l2, acc2 = ref.paged_decode_attention_ref(q, kp, vp, bt, valid, hd ** -0.5)
    torch.cuda.synchronize()
    tol = 1e-4
    torch.testing.assert_close(m, m2, atol=tol, rtol=tol)      # -inf rows included
    torch.testing.assert_close(l, l2, atol=tol, rtol=tol)
    torch.testing.assert_close(acc, acc2, atol=1e-3, rtol=tol)
    assert torch.isneginf(m[-1]).all() and not l[-1].any() and not acc[-1].any()


@pytest.mark.parametrize("sq", [1, 2, 9, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,hd,nb,bs,nbps", PAGED_CASES)
def test_paged_flash_prefill_kernel(dev, b, hq, hkv, hd, nb, bs, nbps, dtype, sq):
    gen = torch.Generator(device=dev).manual_seed(nb * sq + bs)
    q, kp, vp, bt = _paged(gen, dev, dtype, b, hq, hkv, hd, nb, bs, nbps, sq)
    starts = torch.randint(0, nbps * bs - sq + 1, (b,), generator=gen, device=dev)
    q_pos = (starts[:, None] + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
    q_pos[-1, -1] = -1                         # a pad row
    before = ops.LAUNCHES["paged_flash_prefill"]
    got = ops.paged_flash_prefill(q, kp, vp, bt, q_pos, hd ** -0.5)
    assert ops.LAUNCHES["paged_flash_prefill"] == before + 1
    want = ref.paged_flash_prefill_ref(q, kp, vp, bt, q_pos, hd ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[-1, :, -1].any()


def test_paged_launches_are_checked(dev):
    """Launches the paged kernels refuse raise: an empty pool, and a grid
    past the 65535 blocks of its second dimension."""
    q = torch.zeros(2, 4, 1, 64, device=dev)
    empty = torch.zeros(0, 4, 8, 64, device=dev)
    bt = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="paged_decode_attention"):
        ops.paged_decode_attention_partial(q, empty, empty, bt,
                                           torch.ones(2, 8, dtype=torch.bool, device=dev), 0.1)
    b = 65536 // 4 + 1                         # b * hkv > 65535
    pool = torch.zeros(2, 4, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="paged_flash_prefill"):
        ops.paged_flash_prefill(torch.zeros(b, 4, 1, 64, device=dev, dtype=torch.bfloat16),
                                pool, pool, torch.ones(b, 1, dtype=torch.int32, device=dev),
                                torch.zeros(b, 1, dtype=torch.int32, device=dev), 0.1)


def test_kernel_launch_is_checked(dev):
    """A launch the card refuses raises instead of returning garbage."""
    x = torch.zeros(2, 300, device=dev)
    with pytest.raises(RuntimeError, match="topk"):
        ops.topk(x, 257)                     # above the kernel's k limit
    assert np.isfinite(ops.topk(x, 3)[0].cpu().numpy()).all()


# (mode, group, K, N): ragged N (97, 520: byte loads), K with a tail past the
# 128-row and the 32-row stage (200, 1408), a split K (8192)
DQ_CASES = [(mode, group, K, N)
            for mode, group in (("int8", 0), ("int4", 64), ("int4", 128))
            for K, N in ((200, 97), (384, 97), (1408, 520), (8192, 4096))
            if mode == "int8" or K % group == 0]


def _dq_check(got, want):
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert got.dtype == torch.float32 and (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 4, 16, 17, 20, 64, 65, 130, 512])
@pytest.mark.parametrize("mode,group,K,N", DQ_CASES)
def test_dequant_matmul_kernel(dev, mode, group, K, N, T, out_dtype):
    gen = torch.Generator(device=dev).manual_seed(T * K + N)
    w = wquant.quantize(0.05 * _randn(gen, (K, N), torch.bfloat16, dev), mode, group or 128)
    x = _randn(gen, (T, K), torch.bfloat16, dev)
    bits = 8 if mode == "int8" else 4
    before = ops.LAUNCHES["dequant_matmul"]
    got = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=out_dtype)
    assert ops.LAUNCHES["dequant_matmul"] == before + 1   # its splits merged in the launch
    again = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=out_dtype)
    f32 = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=torch.float32)
    want = ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (T, N)
    _dq_check(f32, want)
    assert torch.equal(got, f32.to(out_dtype))   # the same sums, rounded once
    assert torch.equal(got, again)           # a fixed merge order: the same bits each call
    if K == 8192 and T <= ops.GEMM_NARROW_T:  # K split across blocks
        blocks, _, _, bn, bm, _ = ops.dequant_split_plan(T, K, N, bits, w.group, ops._sm_count(dev))
        assert blocks > -(-T // bn) * -(-N // bm)


@pytest.mark.parametrize("T", [4, 20, 130])
@pytest.mark.parametrize("group", [2, 6, 24, 32, 96])
def test_dequant_matmul_kernel_odd_groups(dev, group, T):
    """int4 groups that are no whole number of 16-row steps (2, 6, 24: one
    product per group a step meets), smaller than a stage (32) and with a
    split unit of lcm(group, stage) rows (96)."""
    gen = torch.Generator(device=dev).manual_seed(group * T)
    w = wquant.quantize(0.05 * _randn(gen, (384, 200), torch.bfloat16, dev), "int4", group)
    assert w.group == group
    x = _randn(gen, (T, 384), torch.bfloat16, dev)
    got = ops.dequant_matmul(x, w.q, w.scale, mode="int4", group=group, out_dtype=torch.float32)
    want = ref.dequant_matmul_ref(x, w.q, w.scale, "int4", group)
    torch.cuda.synchronize()
    _dq_check(got, want)
    assert torch.equal(got, ops.dequant_matmul(x, w.q, w.scale, mode="int4", group=group,
                                               out_dtype=torch.float32))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_dequant_matmul_kernel_on_unaligned_layer_views(dev, mode):
    """Per-layer views of a stacked weight whose rows are not 16-byte
    aligned (N = 97): the kernel falls back to byte loads, not to an error."""
    gen = torch.Generator(device=dev).manual_seed(5)
    w = wquant.quantize(0.05 * _randn(gen, (3, 136, 97), torch.bfloat16, dev), mode, 64)
    x = _randn(gen, (4, 136), torch.bfloat16, dev)
    assert wquant.index_batch(w, 1).q.data_ptr() % 16
    for i in range(3):
        layer = wquant.index_batch(w, i)
        got = ops.dequant_matmul(x, layer.q, layer.scale, mode=mode, group=layer.group,
                                 out_dtype=torch.float32)
        want = ref.dequant_matmul_ref(x, layer.q, layer.scale, mode, layer.group)
        torch.cuda.synchronize()
        _dq_check(got, want)


# -- the RG-LRU hybrid's kernels: lru_scan, and head_dim 256 with a window ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,w", [(1, 1, 64), (2, 1, 4000), (3, 37, 200), (4, 17, 4096),
                                   (1, 300, 129), (4, 40, 4000)])
def test_lru_scan_kernel(dev, b, s, w, dtype):
    """One step and many, odd widths (a ragged last block and, at 129,
    rows that are no whole 16-byte copies: plain loads), b 1-4; sequences
    not a multiple of a tile's steps."""
    gen = torch.Generator(device=dev).manual_seed(b * s + w)
    a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=dev)).to(dtype)
    x = torch.randn((b, s, w), generator=gen, device=dev).to(dtype)
    h0 = torch.randn((b, w), generator=gen, device=dev)
    before = ops.LAUNCHES["lru_scan"]
    hs, hT = ops.lru_scan(a, x, h0)
    assert ops.LAUNCHES["lru_scan"] == before + 1
    want_hs, want_hT = ref.lru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    assert hs.dtype == hT.dtype == torch.float32
    torch.testing.assert_close(hs, want_hs, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hT, want_hT, atol=1e-5, rtol=1e-5)
    assert torch.equal(hT, hs[:, -1])


@pytest.mark.parametrize("decay", ["random", "slow"])
@pytest.mark.parametrize("b,s,w", [(1, 2304, 4096), (4, 2304, 512), (2, 700, 4000)])
def test_lru_scan_kernel_within_the_fp64_limit(dev, b, s, w, decay):
    """The tiled scan combines its segments' carries in its own order: held
    against an fp64 scan, its worst error is at most 4x the plain fp32
    version's, or 1e-5 of the largest |h|, with random decays and slow ones
    (a in [0.9, 0.999], a trained RG-LRU's range; b = sqrt(1 - a^2) x).
    Two calls give the same bits, one launch each; h_final is the last
    state."""
    gen = torch.Generator(device=dev).manual_seed(b * s + w)
    if decay == "random":
        a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=dev))
    else:
        a = 0.9 + 0.099 * torch.rand((b, s, w), generator=gen, device=dev)
    x = torch.sqrt(1 - a * a) * torch.randn((b, s, w), generator=gen, device=dev)
    h0 = torch.randn((b, w), generator=gen, device=dev)
    before = ops.LAUNCHES["lru_scan"]
    hs, hT = ops.lru_scan(a, x, h0)
    hs2, hT2 = ops.lru_scan(a, x, h0)
    assert ops.LAUNCHES["lru_scan"] == before + 2
    lim = ref.lru_scan_limit(a, x, h0)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs2) and torch.equal(hT, hT2) and torch.equal(hT, hs[:, -1])
    err = max((hs.double() - lim["want"]).abs().max().item(),
              (hT.double() - lim["want_T"]).abs().max().item())
    assert err <= lim["limit"]


def test_lru_scan_rows_are_the_same_bits_at_any_batch(dev):
    """A one-request admission and a wave of 4 scan a row alike."""
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.sigmoid(torch.randn((4, 1000, 256), generator=gen, device=dev))
    x = torch.randn((4, 1000, 256), generator=gen, device=dev)
    h0 = torch.randn((4, 256), generator=gen, device=dev)
    hs, hT = ops.lru_scan(a, x, h0)
    hs1, hT1 = ops.lru_scan(a[2:3].contiguous(), x[2:3].contiguous(), h0[2:3].contiguous())
    assert torch.equal(hs[2:3], hs1) and torch.equal(hT[2:3], hT1)


def _ring_mask(S, window, frontiers):
    """Per row: a ring of S entries after positions 0..f were written at
    p % S; entry i holds the last p <= f with p % S == i (none if that is
    negative), valid where it lies inside the window of the query at f."""
    idx = torch.arange(S)
    rows = []
    for f in frontiers:
        pos = f - (f - idx) % S
        rows.append((pos >= 0) & (pos > f - window))
    return torch.stack(rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 8, 16])
def test_decode_attention_kernel_hd256_ring(dev, g, dtype):
    """head_dim 256 (4 warps in bf16, 2 in fp32) over a 2048-entry ring
    whose valid rows wrap, per row: g query heads over one KV head (MQA at
    g = 16, recurrentgemma's) and g = 1, 8 over more KV heads."""
    hkv = 1 if g == 16 else 2
    b, S, hd, window = 3, 2048, 256, 2048
    gen = torch.Generator(device=dev).manual_seed(g)
    q = _randn(gen, (b, g * hkv, 1, hd), dtype, dev)
    k, v = _randn(gen, (b, hkv, S, hd), dtype, dev), _randn(gen, (b, hkv, S, hd), dtype, dev)
    valid = _ring_mask(S, window - 100, [2100, 3000, 500]).to(dev)
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, hd ** -0.5)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, hd ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(m, m2, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(acc, acc2, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 64, 2048])
@pytest.mark.parametrize("b,hq,hkv,sq", [(2, 16, 1, 300), (1, 4, 2, 2304)])
def test_flash_prefill_kernel_hd256_window(dev, b, hq, hkv, sq, window, dtype):
    """head_dim 256 over fresh K/V with a sliding window: bands that start
    mid-tile and on a 32-key tile edge (window 64 at rows 95 and 96), rows
    of the first window (no lower bound yet), a pad row."""
    hd = 256
    gen = torch.Generator(device=dev).manual_seed(sq + window)
    q = _randn(gen, (b, hq, sq, hd), dtype, dev)
    k, v = _randn(gen, (b, hkv, sq, hd), dtype, dev), _randn(gen, (b, hkv, sq, hd), dtype, dev)
    q_pos = torch.arange(sq, device=dev, dtype=torch.int32).repeat(b, 1)
    q_pos[-1, -1] = -1
    got = ops.flash_prefill(q, k, v, q_pos, hd ** -0.5, window=window)
    want = ref.flash_prefill_ref(q, k, v, q_pos, hd ** -0.5, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
    assert not got[-1, :, -1].any()


def test_hybrid_kernels_refuse_what_they_do_not_take(dev):
    """A launch the kernel refuses raises: lru_scan over more than 65535
    rows, a negative window; and a head_dim no layout has an instance for
    (96) is refused by the paged wrapper."""
    a = torch.zeros(65536, 1, 8, device=dev)
    with pytest.raises(RuntimeError, match="lru_scan"):
        ops.lru_scan(a, a, torch.zeros(65536, 8, device=dev))
    q = torch.zeros(1, 2, 4, 256, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 4, 256, device=dev, dtype=torch.bfloat16)
    q_pos = torch.zeros(1, 4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="flash_prefill"):
        ops.flash_prefill(q, kv, kv, q_pos, 0.1, window=-1)
    q96, kv96 = q[..., :96].contiguous(), kv[..., :96].contiguous()
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.paged_flash_prefill(q96, kv96, kv96, torch.zeros(1, 1, dtype=torch.int32, device=dev),
                                q_pos, 0.1)


# -- the parallel residual: fused_dual_matmul --------------------------------


def _fdm_tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,ka,kb,d", [
    (1, 64, 64, 64), (100, 300, 700, 200), (128, 512, 1728, 512), (257, 129, 65, 33),
    (6, 300, 700, 200), (9, 64, 72, 136), (20, 1024, 4096, 1024),
    (4, 4096, 16384, 4096), (512, 4096, 16384, 4096),
    (16, 1024, 4096, 1024), (20, 4096, 16384, 4096), (64, 4096, 16384, 4096),
    (65, 1024, 4096, 1024), (64, 136, 200, 520),
])
def test_fused_dual_matmul_kernel(dev, t, ka, kb, d, dtype):
    """The JAX package's sweep (odd shapes: unaligned rows, ragged tiles),
    each byte-bound width (T padded to 8, 16, 32, 64) and the wide tiles'
    edge (T 65), gptj-parallel's decode (T 4), verify step (T 20), chunk
    (T 64) and prefill (T 512), K split across blocks or not."""
    gen = torch.Generator(device=dev).manual_seed(t + ka + d)
    a, b = _randn(gen, (t, ka), dtype, dev), _randn(gen, (t, kb), dtype, dev)
    wa = (torch.randn((ka, d), generator=gen, device=dev) * ka ** -0.5).to(dtype)
    wb = (torch.randn((kb, d), generator=gen, device=dev) * kb ** -0.5).to(dtype)
    before = ops.LAUNCHES["fused_dual_matmul"]
    got = ops.fused_dual_matmul(a, wa, b, wb)
    assert ops.LAUNCHES["fused_dual_matmul"] == before + 1
    want = ref.fused_dual_matmul_ref(a, wa, b, wb)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (t, d)
    torch.testing.assert_close(got.float(), want.float(), **_fdm_tol(dtype))
    assert torch.equal(got, ops.fused_dual_matmul(a, wa, b, wb))     # a fixed merge order


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,s,hd,kb,d", [
    (4, 16, 1, 256, 1024, 512),     # decode: the heads' own (b, h * hd) layout
    (2, 16, 37, 256, 1024, 512),    # prefill: read by strides, no transposed copy
    (3, 5, 11, 20, 40, 24),         # a head_dim that is no whole 16-byte chunk
    (2, 3, 2, 16, 33, 57),          # the GEMV over strided heads
])
def test_fused_dual_matmul_kernel_reads_heads(dev, n, h, s, hd, kb, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(n * s + hd)
    heads = _randn(gen, (n, h, s, hd), dtype, dev)
    wo = (torch.randn((h, hd, d), generator=gen, device=dev) * (h * hd) ** -0.5).to(dtype)
    b = _randn(gen, (n * s, kb), dtype, dev)
    wb = (torch.randn((kb, d), generator=gen, device=dev) * kb ** -0.5).to(dtype)
    got = ops.fused_dual_matmul(heads, wo, b, wb)
    want = ref.fused_dual_matmul_ref(heads.transpose(1, 2).reshape(n * s, h * hd),
                                     wo.reshape(h * hd, d), b, wb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_fdm_tol(dtype))


def test_fused_dual_matmul_rows_alike_at_every_width(dev):
    """A row's output does not depend on T: the rows of a 4 x 128-token
    prefill, of one 128-token prompt, of its 64-token suffix, of a verify
    step and of a decode step come out the same bits (the schedulers
    agree)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    a, b = _randn(gen, (512, 4096), torch.bfloat16, dev), _randn(gen, (512, 16384), torch.bfloat16, dev)
    wa = (torch.randn((4096, 4096), generator=gen, device=dev) * 4096 ** -0.5).bfloat16()
    wb = (torch.randn((16384, 4096), generator=gen, device=dev) * 16384 ** -0.5).bfloat16()
    whole = ops.fused_dual_matmul(a, wa, b, wb)
    one = ops.fused_dual_matmul(a[128:256], wa, b[128:256], wb)
    suffix = ops.fused_dual_matmul(a[192:256], wa, b[192:256], wb)
    verify = ops.fused_dual_matmul(a[236:256], wa, b[236:256], wb)
    decode = ops.fused_dual_matmul(a[252:256], wa, b[252:256], wb)
    torch.cuda.synchronize()
    assert torch.equal(whole[128:256], one)
    assert torch.equal(one[64:], suffix)
    assert torch.equal(one[108:], verify)
    assert torch.equal(verify[16:], decode)


def test_fused_dual_matmul_takes_unaligned_views(dev):
    """Per-layer views whose rows start off a 16-byte boundary, and mixed
    dtypes refused."""
    gen = torch.Generator(device=dev).manual_seed(3)
    wa = _randn(gen, (2 * 100 * 40 + 1,), torch.bfloat16, dev)[1:].view(2, 100, 40)[1]
    wb = _randn(gen, (70 * 40 + 3,), torch.bfloat16, dev)[3:].view(70, 40)
    for t in (3, 30):
        a, b = _randn(gen, (t, 100), torch.bfloat16, dev), _randn(gen, (t, 70), torch.bfloat16, dev)
        got = ops.fused_dual_matmul(a, wa, b, wb)
        torch.testing.assert_close(got.float(), ref.fused_dual_matmul_ref(a, wa, b, wb).float(),
                                   atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="dtypes"):
        ops.fused_dual_matmul(a, wa.float(), b, wb)


# -- the tensor-core prefill body and the split decode: their tiles' edges ----


def _close_per_element(got, want):
    """bf16 output: 2e-3 + 1e-2 |want| per element (one bf16 ulp is at most
    7.8e-3 of a value), the stripe and window rule of chip_smoke.py."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    assert (err <= 2e-3 + 1e-2 * want.abs()).all(), err.max().item()


@pytest.mark.parametrize("g", [1, 8, 16])
@pytest.mark.parametrize("sq,sk", [(1, 1), (15, 15), (16, 16), (17, 17), (63, 63), (64, 64),
                                   (65, 65), (2304, 2304), (1, 64), (17, 65), (64, 65),
                                   (65, 2304)])
def test_flash_prefill_mma_tile_edges(dev, sq, sk, g):
    """bf16 on the tensor cores: query and key counts around the 16-row
    fragment and the 64-row / 64-key tiles; g 8 and 16 fold several
    positions into a tile (and a position across two tiles at g 16, sq 65);
    the last sq queries of sk keys; pad rows exact zeros."""
    hd = 256 if g == 16 else 128 if g == 8 else 64
    b, hkv = 2, 1 if g == 16 else 2
    gen = torch.Generator(device=dev).manual_seed(sq * 7 + sk + g)
    q = _randn(gen, (b, g * hkv, sq, hd), torch.bfloat16, dev)
    k, v = (_randn(gen, (b, hkv, sk, hd), torch.bfloat16, dev) for _ in range(2))
    q_pos = torch.arange(sk - sq, sk, device=dev, dtype=torch.int32).repeat(b, 1)
    q_pos[-1, -1] = -1                       # a pad row
    before = ops.LAUNCHES["flash_prefill"]
    got = ops.flash_prefill(q, k, v, q_pos, hd ** -0.5)
    assert ops.LAUNCHES["flash_prefill"] == before + 1
    want = ref.flash_prefill_ref(q, k, v, q_pos, hd ** -0.5)
    torch.cuda.synchronize()
    _close_per_element(got, want)
    assert not got[-1, :, -1].any()


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("window", [63, 64, 65, 128, 192])
def test_flash_prefill_mma_window_on_tile_edges(dev, window, hd):
    """Windows whose band edge falls on a 64-key tile boundary (rows
    window + 63, window + 127, ... start their band at a tile's first key)
    and just beside it; the plain version one key narrower must differ."""
    b, hq, hkv, sq = 2, 8, 2, 300
    gen = torch.Generator(device=dev).manual_seed(window + hd)
    q = _randn(gen, (b, hq, sq, hd), torch.bfloat16, dev)
    k, v = (_randn(gen, (b, hkv, sq, hd), torch.bfloat16, dev) for _ in range(2))
    q_pos = torch.arange(sq, device=dev, dtype=torch.int32).repeat(b, 1)
    got = ops.flash_prefill(q, k, v, q_pos, hd ** -0.5, window=window)
    want = ref.flash_prefill_ref(q, k, v, q_pos, hd ** -0.5, window)
    narrower = ref.flash_prefill_ref(q, k, v, q_pos, hd ** -0.5, window - 1)
    torch.cuda.synchronize()
    _close_per_element(got, want)
    assert (got.float() - narrower.float()).abs().max().item() > 5e-2


def test_flash_prefill_mma_rows_out_of_range_and_pad_rows(dev):
    """bf16 through the row index: a batch row whose index lies outside the
    cache and a batch row of pad rows both come out as exact zeros."""
    gen = torch.Generator(device=dev).manual_seed(11)
    q = _randn(gen, (3, 16, 70, 256), torch.bfloat16, dev)
    k, v = (_randn(gen, (2, 1, 200, 256), torch.bfloat16, dev) for _ in range(2))
    q_pos = (torch.arange(70, device=dev, dtype=torch.int32) + 100).repeat(3, 1)
    q_pos[1] = -1
    rows = torch.tensor([1, 0, 5], dtype=torch.int32, device=dev)
    got = ops.flash_prefill(q, k, v, q_pos, 0.0625, rows=rows)
    want = ref.flash_prefill_ref(q[:1], k[1:], v[1:], q_pos[:1], 0.0625)
    torch.cuda.synchronize()
    assert not got[1:].any()
    _close_per_element(got[:1], want)


@pytest.mark.parametrize("sq", [1, 5, 64, 100])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 4, 128), (16, 16, 256), (8, 1, 64)])
def test_paged_flash_prefill_mma_table_with_null_entries(dev, hq, hkv, hd, sq):
    """bf16 through a shuffled table of 16-row blocks, so that a 64-key
    tile gathers 4 pool blocks, with null entries past each slot's live
    blocks and inside one slot's prefix."""
    b, bs, nbps = 3, 16, 20
    nb = b * nbps + 1
    gen = torch.Generator(device=dev).manual_seed(sq + hd)
    q = _randn(gen, (b, hq, sq, hd), torch.bfloat16, dev)
    kp, vp = (_randn(gen, (nb, hkv, bs, hd), torch.bfloat16, dev) for _ in range(2))
    bt = (torch.randperm(nb - 1, generator=gen, device=dev)[:b * nbps] + 1).reshape(b, nbps)
    bt = bt.to(torch.int32)
    starts = torch.tensor([0, 150, 320 - sq], device=dev)
    q_pos = (starts[:, None] + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
    last = (q_pos.max(dim=1).values // bs).tolist()
    for i, blk in enumerate(last):
        bt[i, blk + 1:] = 0                     # unallocated: the null block
    bt[1, 2] = 0                                # a null entry inside a prefix
    q_pos[-1, -1] = -1
    got = ops.paged_flash_prefill(q, kp, vp, bt.contiguous(), q_pos, hd ** -0.5)
    want = ref.paged_flash_prefill_ref(q, kp, vp, bt, q_pos, hd ** -0.5)
    torch.cuda.synchronize()
    _close_per_element(got, want)
    assert not got[-1, :, -1].any()


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_verify_mma_dead_splits(dev, hd):
    """bf16 split launch over a 1000-key stripe whose frontiers lie in its
    first chunk or two: the later splits are dead and write empty partials
    before any load; a row outside the cache and a pad row are zeros."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    b, hq, hkv, sq, S = 4, 8, 2, 5, 1000
    q = _randn(gen, (b, hq, sq, hd), torch.bfloat16, dev)
    k, v = (_randn(gen, (4, hkv, S, hd), torch.bfloat16, dev) for _ in range(2))
    q_pos = (torch.tensor([0, 60, 120, 3], device=dev)[:, None]
             + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
    q_pos[2, -1] = -1
    rows = torch.tensor([3, 1, 0, 7], dtype=torch.int32, device=dev)    # row 3 is no stripe
    got = ops.flash_verify(q, k, v, q_pos, hd ** -0.5, rows=rows)
    want = ref.flash_verify_ref(q[:3], k[rows[:3].long()], v[rows[:3].long()], q_pos[:3],
                                hd ** -0.5)
    torch.cuda.synchronize()
    _close_per_element(got[:3], want)
    assert not got[3].any() and not got[2, :, -1].any()


def _decode_case(gen, dev, dtype, b, hq, hkv, S, hd):
    q = _randn(gen, (b, hq, 1, hd), dtype, dev)
    k, v = _randn(gen, (b, hkv, S, hd), dtype, dev), _randn(gen, (b, hkv, S, hd), dtype, dev)
    return q, k, v


def _decode_check(got, want):
    (m, l, acc), (m2, l2, acc2) = got, want
    torch.testing.assert_close(m, m2, atol=1e-4, rtol=1e-4)      # -inf rows included
    torch.testing.assert_close(l, l2, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(acc, acc2, atol=1e-3, rtol=1e-4)
    dead = torch.isneginf(m2)
    assert torch.equal(torch.isneginf(m), dead) and not acc[dead].any() and not l[dead].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,S,hd", [(4, 16, 1, 2000, 256), (2, 32, 4, 515, 128),
                                           (1, 8, 1, 4090, 64), (3, 12, 4, 33, 128)])
def test_decode_attention_split_edges(dev, b, hq, hkv, S, hd, dtype):
    """Splits of the KV axis: S not a multiple of the chunk; the first
    splits of row 0 wholly masked; row 1 with no valid key at all; a
    per-row mask; the arrival counters zero after the launch."""
    chunk, splits = ops.decode_split_plan(b, hq, hkv, S, ops._sm_count(dev))
    assert splits > 1 and S % chunk
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q, k, v = _decode_case(gen, dev, dtype, b, hq, hkv, S, hd)
    valid = torch.rand((b, S), generator=gen, device=dev) < 0.8
    valid[0, :2 * chunk + 5] = False
    if b > 1:
        valid[1] = False
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention_partial(q, k, v, valid, hd ** -0.5)
    assert ops.LAUNCHES["decode_attention"] == before + 1        # the merge is in the launch
    want = ref.decode_attention_ref(q, k, v, valid, hd ** -0.5)
    torch.cuda.synchronize()
    _decode_check(got, want)
    assert not ops._ARRIVALS[torch.cuda.current_device()].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_unsplit_when_the_grid_fills_the_card(dev, dtype):
    """b * hkv large enough that the plan keeps one split: the blocks write
    the outputs themselves."""
    b, hq, hkv, S, hd = 64, 8, 8, 300, 128
    assert ops.decode_split_plan(b, hq, hkv, S, ops._sm_count(dev))[1] == 1
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v = _decode_case(gen, dev, dtype, b, hq, hkv, S, hd)
    valid = torch.arange(S, device=dev) < 250
    got = ops.decode_attention_partial(q, k, v, valid, hd ** -0.5)
    want = ref.decode_attention_ref(q, k, v, valid, hd ** -0.5)
    torch.cuda.synchronize()
    _decode_check(got, want)


def test_decode_attention_counters_come_back_to_zero(dev):
    """Two split launches back to back on the same counters, then a third
    at other shapes (more groups, the paged layout): each is right, which
    it could not be if an earlier launch had left a counter above 0."""
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = _decode_case(gen, dev, torch.bfloat16, 4, 16, 1, 2048, 256)
    valid = torch.rand((4, 2048), generator=gen, device=dev) < 0.9
    first = ops.decode_attention_partial(q, k, v, valid, 0.0625)
    second = ops.decode_attention_partial(q, k, v, valid, 0.0625)
    want = ref.decode_attention_ref(q, k, v, valid, 0.0625)
    q2, kp, vp, bt = _paged(gen, dev, torch.bfloat16, 2, 32, 2, 128, 70, 16, 33, 1)
    valid2 = torch.arange(33 * 16, device=dev)[None, :] < torch.tensor([[400], [20]], device=dev)
    third = ops.paged_decode_attention_partial(q2, kp, vp, bt, valid2, 128 ** -0.5)
    want3 = ref.paged_decode_attention_ref(q2, kp, vp, bt, valid2, 128 ** -0.5)
    torch.cuda.synchronize()
    for got in (first, second):
        _decode_check(got, want)
    _decode_check(third, want3)
    assert not ops._ARRIVALS[torch.cuda.current_device()].any()
    assert all(torch.equal(a, b) for a, b in zip(first, second))   # the same merge order


def test_decode_attention_refuses_a_bad_plan(dev):
    """The C entry point checks the plan and the workspace: a chunk that is
    no whole number of tiles, splits that leave keys out or an empty split,
    and a workspace too small for the splits are refused, and the wrapper
    raises."""
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = _decode_case(gen, dev, torch.bfloat16, 2, 8, 1, 256, 64)
    valid = torch.ones(256, dtype=torch.bool, device=dev)
    m, l = torch.empty(2, 8, 1, device=dev), torch.empty(2, 8, 1, device=dev)
    acc = torch.empty(2, 8, 1, 64, device=dev)
    counters = ops._arrival_counters(dev, 2)
    for chunk, splits, n_work in ((48, 6, 6 * 16 * 66), (64, 3, 3 * 16 * 66),
                                  (64, 5, 5 * 16 * 66), (64, 4, 4 * 16 * 66 - 1)):
        work = torch.empty(4 * 16 * 66 + 2 * 16 * 66, device=dev)
        with pytest.raises(RuntimeError, match="decode_attention"):
            build.call("decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None,
                       valid.data_ptr(), 0, m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                       work.data_ptr(), n_work, counters.data_ptr(), counters.numel(), chunk,
                       splits, 2, 8, 1, 256, 64, 1, 0.125, ops._stream())


# ---------------------------------------------------------------------------
# The int8 KV cache: the decode kernels' int8 load path and kv_quant_write
# ---------------------------------------------------------------------------


def _int8_cache(gen, dev, shape):
    """An int8 cache side and its bf16 scales, as kv_quant_write leaves
    them: ``ref.quantize_kv`` of seeded bf16 values, some rows all zero."""
    x = _randn(gen, shape, torch.bfloat16, dev) * 3
    x.view(-1, shape[-1])[::7] = 0
    return ref.quantize_kv(x)


def _equal_partials(got, want):
    """m, l and acc bit for bit (a row with no valid key: -inf, 0, 0)."""
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def _close_to_plain(got, plain):
    """m, l and acc against the plain version (dequantize, then the plain
    decode) at the bf16 decode tests' tolerance."""
    for g, w, atol in zip(got, plain, (1e-4, 1e-4, 1e-3)):
        torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)    # -inf rows included


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("b,hq,hkv,S,mask", [
    (4, 32, 4, 512, "shared"), (3, 16, 1, 1000, "per_row"), (2, 8, 8, 77, "per_row"),
    (4, 64, 64, 300, "window"),
])
def test_decode_attention_int8_equals_bf16_on_the_dequantized_cache(dev, b, hq, hkv, S, hd,
                                                                     mask):
    """The int8 load path against the bf16 instance on ``dequantize_kv`` of
    the same cache, bit for bit: shared and per-row masks (a row with no
    valid key), a window's mask over a ring, several splits and one."""
    gen = torch.Generator(device=dev).manual_seed(S + hd)
    q = _randn(gen, (b, hq, 1, hd), torch.bfloat16, dev)
    (kq, ks), (vq, vs) = (_int8_cache(gen, dev, (b, hkv, S, hd)) for _ in range(2))
    if mask == "shared":
        valid = torch.arange(S, device=dev) < (3 * S) // 4
    elif mask == "per_row":
        lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
        lens[0] = 0
        valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    else:                           # positions past a 128-key window over a wrapped ring
        cur = torch.tensor([400, 299, 150, 1000][:b], device=dev)
        pos = torch.arange(S, device=dev)[None, :] + (cur[:, None] // S) * S
        pos = torch.where(pos > cur[:, None], pos - S, pos)
        valid = (pos >= 0) & (pos <= cur[:, None]) & (pos > cur[:, None] - 128)
    before = ops.LAUNCHES["decode_attention_int8"]
    got = ops.decode_attention_partial(q, kq, vq, valid, hd ** -0.5, k_scale=ks, v_scale=vs)
    assert ops.LAUNCHES["decode_attention_int8"] == before + 1
    want = ops.decode_attention_partial(q, ref.dequantize_kv(kq, ks), ref.dequantize_kv(vq, vs),
                                        valid, hd ** -0.5)
    torch.cuda.synchronize()
    _equal_partials(got, want)
    plain = ref.decode_attention_ref(q, ref.dequantize_kv(kq, ks), ref.dequantize_kv(vq, vs),
                                     valid, hd ** -0.5)
    _close_to_plain(got, plain)


@pytest.mark.parametrize("b,hq,hkv,hd,nb,bs,nbps", PAGED_CASES + [(4, 16, 1, 256, 70, 16, 16)])
def test_paged_decode_attention_int8_equals_bf16_on_the_dequantized_pools(dev, b, hq, hkv, hd,
                                                                          nb, bs, nbps):
    gen = torch.Generator(device=dev).manual_seed(nb + bs + 1)
    q, _, _, bt = _paged(gen, dev, torch.bfloat16, b, hq, hkv, hd, nb, bs, nbps, 1)
    (kq, ks), (vq, vs) = (_int8_cache(gen, dev, (nb, hkv, bs, hd)) for _ in range(2))
    S = nbps * bs
    lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    valid[0, bs:3 * bs] = False
    valid[-1] = False
    before = ops.LAUNCHES["paged_decode_attention_int8"]
    got = ops.paged_decode_attention_partial(q, kq, vq, bt, valid, hd ** -0.5, k_scale=ks,
                                             v_scale=vs)
    assert ops.LAUNCHES["paged_decode_attention_int8"] == before + 1
    want = ops.paged_decode_attention_partial(q, ref.dequantize_kv(kq, ks),
                                              ref.dequantize_kv(vq, vs), bt, valid, hd ** -0.5)
    torch.cuda.synchronize()
    _equal_partials(got, want)
    plain = ref.paged_decode_attention_ref(q, ref.dequantize_kv(kq, ks),
                                           ref.dequantize_kv(vq, vs), bt, valid, hd ** -0.5)
    _close_to_plain(got, plain)
    assert torch.isneginf(got[0][-1]).all() and not got[2][-1].any()


def _kvq_case(gen, dev, layout, b, h, s, hd, n, m):
    """Fresh K/V (strided, as a layer makes them), int8 caches and scales
    filled with a marker, and (dst_row, dst_idx) of one layout."""
    from repro_torch.models import attention as attn

    k, v = (_randn(gen, (b, s, h, hd), torch.bfloat16, dev).transpose(1, 2) for _ in range(2))
    caches = [torch.full((n, h, m, hd), 99, dtype=torch.int8, device=dev) for _ in range(2)]
    scales = [torch.full((n, h, m), -1.0, device=dev).bfloat16() for _ in range(2)]
    if layout == "wave":
        dst = attn.quant_targets(b, s, dev, wave_pos=m - s)
    elif layout == "ring":          # the last m tokens at p % m, the others dropped
        dst = attn.quant_targets(b, s, dev, ring_idx=torch.arange(s - m, s, device=dev) % m)
    else:                           # pool targets: shuffled blocks, the null block 0 twice
        bt = torch.randperm(n - 1, generator=gen, device=dev)[:b * 2].reshape(b, 2) + 1
        bt[-1, -1] = 0
        starts = torch.arange(b, device=dev) * 3
        phys, off = attn.paged_flat_targets(bt, starts, s, m)
        src = torch.arange(b * s, device=dev)[1:]         # token 0 is not written
        dst = attn.quant_targets(b, s, dev, targets=(phys[1:], off[1:]), src=src)
    return k, v, caches, scales, dst


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("layout,b,h,s,n,m", [
    ("wave", 4, 4, 37, 4, 64), ("wave", 2, 64, 1, 2, 8), ("ring", 3, 1, 100, 3, 64),
    ("targets", 4, 8, 13, 12, 16), ("targets", 2, 2, 1, 6, 8),
])
def test_kv_quant_write_kernel(dev, layout, b, h, s, hd, n, m):
    """Bit for bit against the plain version in every layout: the wave's
    slice, a ring's indices with the earlier tokens dropped, pool targets
    with a dropped token and the null block named twice (its entries, never
    read as valid, are left out of the comparison); the dequantized fresh
    K/V too, and one launch."""
    gen = torch.Generator(device=dev).manual_seed(b * s + hd)
    k, v, caches, scales, dst = _kvq_case(gen, dev, layout, b, h, s, hd, n, m)
    plain = ([c.clone() for c in caches], [t.clone() for t in scales])
    want = ref.kv_quant_write_ref(k, v, *plain[0], *plain[1], *dst)
    before = ops.LAUNCHES["kv_quant_write"]
    got = ops.kv_quant_write(k, v, *caches, *scales, *dst, dequantized=True)
    assert ops.LAUNCHES["kv_quant_write"] == before + 1
    torch.cuda.synchronize()
    keep = slice(1, None) if layout == "targets" else slice(None)
    for a, w in zip(caches + scales, plain[0] + plain[1]):
        assert torch.equal(a[keep].view(torch.uint8) if a.dtype == torch.int8 else
                           a[keep].view(torch.int16),
                           w[keep].view(torch.uint8) if w.dtype == torch.int8 else
                           w[keep].view(torch.int16))
    for a, w in zip(got, want):
        assert torch.equal(a.view(torch.int16), w.view(torch.int16))
    assert (caches[0] != 99).any() and ops.kv_quant_write(k, v, *caches, *scales, *dst) is None


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = _randn(gen, (2, 8, 1, 128), torch.bfloat16, dev)
    (kq, ks), (vq, vs) = (_int8_cache(gen, dev, (2, 2, 64, 128)) for _ in range(2))
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="needs its scales"):
        ops.decode_attention_partial(q, kq, vq, valid, 0.1)
    with pytest.raises(ValueError, match="scales"):
        ops.decode_attention_partial(q.float(), kq, vq, valid, 0.1, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="both scales"):
        ops.decode_attention_partial(q, kq, vq, valid, 0.1, k_scale=ks)
    k = _randn(gen, (2, 2, 3, 128), torch.bfloat16, dev)
    dst = (torch.zeros(6, dtype=torch.int32, device=dev),) * 2
    with pytest.raises(ValueError, match="dtypes"):
        ops.kv_quant_write(k.float(), k.float(), kq, vq, ks, vs, *dst)
    with pytest.raises(ValueError, match="shapes"):
        ops.kv_quant_write(k, k, kq, vq, ks, vs, dst[0][:5], dst[1])


# -- tensor parallelism: the kernels at a rank's shard shapes -----------------


@pytest.mark.parametrize("k", [1, 40])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fill", ["randn", "ties", "nan"])
def test_topk_kernel_merges_shard_candidates(dev, tp, k, fill):
    """distributed_topk's two launches on one card: each rank's top-k of its
    vocab shard (yi-9b's 64000 over tp), the tp * k candidates (V = tp * k:
    2, 4, 80, 160) in rank order with global indices, and the top-k of
    those, equal bit for bit to the plain top-k of the whole row: ties to
    the lowest global index, NaN above +inf by index."""
    gen = torch.Generator(device=dev).manual_seed(tp * 100 + k)
    rows, V = 4, 64000
    if fill == "ties":
        x = torch.randint(0, 3, (rows, V), generator=gen, device=dev).float()
    else:
        x = torch.randn((rows, V), generator=gen, device=dev)
    if fill == "nan":
        x[0, ::977] = float("nan")
        x[1] = float("nan")
    lv = V // tp
    parts = [ops.topk(x[:, r * lv:(r + 1) * lv].contiguous(), k) for r in range(tp)]
    vals = torch.cat([v for v, _ in parts], dim=1)
    gidx = torch.cat([i + r * lv for r, (_, i) in enumerate(parts)], dim=1)
    assert vals.shape == (rows, tp * k)
    top, pos = ops.topk(vals, k)
    want_v, want_i = ref.topk_ref(x, k)
    torch.cuda.synchronize()
    assert torch.equal(torch.gather(gidx, 1, pos.long()), want_i)
    assert torch.equal(top.nan_to_num(7.0), want_v.nan_to_num(7.0))
    cand_v, cand_i = ref.topk_ref(vals, k)       # the candidates' top-k, plain
    assert torch.equal(pos, cand_i)


@pytest.mark.parametrize("T", [4, 100])
@pytest.mark.parametrize("K,N,k_shards", [(8192, 4096, 1), (8192, 12288, 1), (24576, 8192, 2)])
def test_dequant_matmul_kernel_at_qwen_tp2_shards(dev, K, N, k_shards, T):
    """qwen-72b int4 at tp=2: a rank's w_q (8192, 4096) and w_up (8192,
    12288) columns, and its w_down rows (12288, 8192) of the global leaf
    quantized with shard-local groups (``k_shards``), rank 1's slice."""
    gen = torch.Generator(device=dev).manual_seed(K + N + T)
    w = wquant.quantize(0.02 * _randn(gen, (K, N), torch.bfloat16, dev), "int4", 128,
                        k_shards=k_shards)
    if k_shards > 1:
        w = wquant.slice_rows(w, K // 2, K // 2)
    if k_shards == 1:
        w = wquant.slice_cols(w, N // 2, N // 2)
    q, s = w.q.contiguous(), w.scale.contiguous()
    x = _randn(gen, (T, w.k), torch.bfloat16, dev)
    got = ops.dequant_matmul(x, q, s, mode="int4", group=w.group, out_dtype=torch.float32)
    want = ref.dequant_matmul_ref(x, q, s, "int4", w.group)
    torch.cuda.synchronize()
    assert got.shape == (T, q.shape[1]) and w.group == 128
    _dq_check(got, want)


@pytest.mark.parametrize("s", [1, 37])
def test_fused_dual_matmul_kernel_at_gptj_tp2_shard(dev, s):
    """gptj-parallel at tp=2: a rank's 8 heads of 256 read in place @ w_o
    (8, 256, 4096) plus h (4 s, 8192) @ w_down (8192, 4096): decode (s 1)
    and a 37-token prefill."""
    gen = torch.Generator(device=dev).manual_seed(s)
    heads = _randn(gen, (4, 8, s, 256), torch.bfloat16, dev)
    wo = (torch.randn((8, 256, 4096), generator=gen, device=dev) * 4096 ** -0.5).bfloat16()
    h = _randn(gen, (4 * s, 8192), torch.bfloat16, dev)
    wd = (torch.randn((8192, 4096), generator=gen, device=dev) * 16384 ** -0.5).bfloat16()
    got = ops.fused_dual_matmul(heads, wo, h, wd)
    want = ref.fused_dual_matmul_ref(heads.transpose(1, 2).reshape(4 * s, 2048),
                                     wo.reshape(2048, 4096), h, wd)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **_fdm_tol(torch.bfloat16))


# ---------------------------------------------------------------------------
# deepseek-moe-16b's shapes: the router's top-k and the g-1 attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [4, 256, 500])
def test_topk_kernel_at_the_router_shape(dev, T):
    """deepseek-moe-16b's routing: softmax rows of 64 experts in fp32, top
    6, one launch; rows with planted ties (equal router columns give equal
    probabilities) rank the lower expert first, as lax.top_k does."""
    gen = torch.Generator(device=dev).manual_seed(T)
    logits = _randn(gen, (T, 64), torch.float32, dev)
    logits[:, 7] = logits[:, 3]                # ties at every rank they reach
    logits[::2, 40:48] = logits[::2, 40:41] + 2.0
    probs = torch.softmax(logits, dim=-1)
    before = ops.LAUNCHES["topk"]
    vals, idx = ops.topk(probs, 6)
    assert ops.LAUNCHES["topk"] == before + 1
    rv, ri = ref.topk_ref(probs.cpu(), 6)
    torch.cuda.synchronize()
    assert torch.equal(vals.cpu(), rv) and torch.equal(idx.cpu(), ri)
    assert torch.equal(idx[0].cpu(), torch.arange(40, 46, dtype=torch.int32))


# deepseek-moe-16b's attention: 16 MHA heads of head_dim 128 (g 1), b 4
DS_H, DS_HD = 16, 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["decode", "prefill", "paged_decode", "paged_prefill"])
def test_attention_kernels_at_deepseek_heads(dev, kernel, dtype):
    """decode_attention over 300 of 512 entries per row, flash_prefill of
    125-token rows (a wave of deepseek's chip phase), and the paged pair
    over 16-token blocks, each against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(len(kernel))
    b, scale = 4, DS_HD ** -0.5
    if kernel.startswith("paged"):
        sq = 1 if kernel == "paged_decode" else 64
        q, kp, vp, bt = _paged(gen, dev, dtype, b, DS_H, DS_H, DS_HD, 80, 16, 16, sq)
        if kernel == "paged_decode":
            valid = torch.arange(256, device=dev)[None, :] < torch.tensor(
                [[200], [256], [17], [1]], device=dev)
            got = ops.paged_decode_attention_partial(q, kp, vp, bt, valid, scale)
            want = ref.paged_decode_attention_ref(q, kp, vp, bt, valid, scale)
        else:
            q_pos = (torch.tensor([[0], [64], [100], [192]], device=dev)
                     + torch.arange(sq, device=dev)[None, :]).to(torch.int32)
            got = ops.paged_flash_prefill(q, kp, vp, bt, q_pos, scale)
            want = ref.paged_flash_prefill_ref(q, kp, vp, bt, q_pos, scale)
    elif kernel == "decode":
        q = _randn(gen, (b, DS_H, 1, DS_HD), dtype, dev)
        k, v = (_randn(gen, (b, DS_H, 512, DS_HD), dtype, dev) for _ in range(2))
        valid = torch.arange(512, device=dev) < 300
        got = ops.decode_attention_partial(q, k, v, valid, scale)
        want = ref.decode_attention_ref(q, k, v, valid, scale)
    else:
        q, k, v = (_randn(gen, (b, DS_H, 125, DS_HD), dtype, dev) for _ in range(3))
        q_pos = torch.arange(125, device=dev, dtype=torch.int32).repeat(b, 1)
        q_pos[1, 100:] = -1                    # a right-padded row
        got = ops.flash_prefill(q, k, v, q_pos, scale)
        want = ref.flash_prefill_ref(q, k, v, q_pos, scale)
    torch.cuda.synchronize()
    if kernel.endswith("decode"):
        for g, w in zip(got, want):          # (m, l, acc) in fp32
            torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))


# mixtral-8x7b's attention: 32 q heads over 8 KV heads of head_dim 128 (g 4),
# a 4096-token window, its slot ring of window + spec_k 4 entries
MX_HQ, MX_HKV, MX_HD, MX_WINDOW, MX_RING = 32, 8, 128, 4096, 4100


@pytest.mark.parametrize("kernel,dtype", [
    ("prefill", torch.float32), ("prefill", torch.bfloat16), ("decode", torch.float32),
    ("decode", torch.bfloat16), ("decode_int8", torch.bfloat16)])
def test_attention_kernels_at_mixtral_heads(dev, kernel, dtype):
    """flash_prefill of 125-token rows with the 4096 window (a wave of
    mixtral's chip phase; one row right-padded), and decode_attention and
    its int8 instance over the wrapped 4100-entry ring, each row's 4096 live
    entries named by the reference's ring position rows, each against its
    plain version (the int8 instance bit for bit against the bf16 one on
    the dequantized cache)."""
    from repro_torch.runtime.kvcache import position_rows

    gen = torch.Generator(device=dev).manual_seed(len(kernel))
    b, scale = 4, MX_HD ** -0.5
    if kernel == "prefill":
        q = _randn(gen, (b, MX_HQ, 125, MX_HD), dtype, dev)
        k, v = (_randn(gen, (b, MX_HKV, 125, MX_HD), dtype, dev) for _ in range(2))
        q_pos = torch.arange(125, device=dev, dtype=torch.int32).repeat(b, 1)
        q_pos[1, 100:] = -1
        got = ops.flash_prefill(q, k, v, q_pos, scale, window=MX_WINDOW)
        want = ref.flash_prefill_ref(q, k, v, q_pos, scale, window=MX_WINDOW)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
        return
    cur = torch.tensor([4200, 4099, 8191, 100], device=dev)
    pos = position_rows(cur + 1, MX_RING, ring=True)
    valid = (pos >= 0) & (pos <= cur[:, None]) & (pos > cur[:, None] - MX_WINDOW)
    assert valid.sum(1).tolist() == [4096, 4096, 4096, 101]
    q = _randn(gen, (b, MX_HQ, 1, MX_HD), dtype, dev)
    if kernel == "decode":
        k, v = (_randn(gen, (b, MX_HKV, MX_RING, MX_HD), dtype, dev) for _ in range(2))
        got = ops.decode_attention_partial(q, k, v, valid, scale)
        want = ref.decode_attention_ref(q, k, v, valid, scale)
        torch.cuda.synchronize()
        for g, w in zip(got, want):          # (m, l, acc) in fp32
            torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)
        return
    (kq, ks), (vq, vs) = (_int8_cache(gen, dev, (b, MX_HKV, MX_RING, MX_HD)) for _ in range(2))
    got = ops.decode_attention_partial(q, kq, vq, valid, scale, k_scale=ks, v_scale=vs)
    want = ops.decode_attention_partial(q, ref.dequantize_kv(kq, ks), ref.dequantize_kv(vq, vs),
                                        valid, scale)
    torch.cuda.synchronize()
    _equal_partials(got, want)


@pytest.mark.parametrize("T", [4, 500, 1024])
def test_topk_kernel_at_mixtral_router(dev, T):
    """mixtral-8x7b's routing: softmax rows of 8 experts in fp32, top 2, one
    launch, planted ties ranking the lower expert first (T 1024: a mixed
    step of 4 chunks of 256)."""
    gen = torch.Generator(device=dev).manual_seed(T + 8)
    logits = _randn(gen, (T, 8), torch.float32, dev)
    logits[:, 6] = logits[:, 1]
    probs = torch.softmax(logits, dim=-1)
    before = ops.LAUNCHES["topk"]
    vals, idx = ops.topk(probs, 2)
    assert ops.LAUNCHES["topk"] == before + 1
    rv, ri = ref.topk_ref(probs.cpu(), 2)
    torch.cuda.synchronize()
    assert torch.equal(vals.cpu(), rv) and torch.equal(idx.cpu(), ri)


@pytest.mark.parametrize("K,N,out_dtype", [(4096, 4096, torch.bfloat16),
                                           (4096, 1024, torch.bfloat16),
                                           (4096, 32000, torch.float32)])
@pytest.mark.parametrize("T", [4, 20, 500])
def test_dequant_matmul_kernel_at_mixtral_int4(dev, K, N, out_dtype, T):
    """mixtral-8x7b's int4 attention projections (w_q, w_k/w_v) and its
    lm_head (fp32 out), group 128, at a decode step (T 4), a verify step of
    4 slots (T 20) and a wave prefill (T 500), against the plain version
    (fp32: 1e-4 of the largest output; bf16: within one bf16 ulp of it)."""
    gen = torch.Generator(device=dev).manual_seed(K + N + T)
    w = wquant.quantize((torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
                        .bfloat16(), "int4", 128)
    x = _randn(gen, (T, K), torch.bfloat16, dev)
    got = ops.dequant_matmul(x, w.q, w.scale, mode="int4", group=w.group, out_dtype=out_dtype)
    want = ref.dequant_matmul_ref(x, w.q, w.scale, "int4", w.group)
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    if out_dtype == torch.float32:
        assert (got - want).abs().max().item() <= tol
    else:
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
        assert bool(((got.float() - want).abs() <= ulp + tol).all())


def test_topk_kernel_at_mamba2_vocab(dev):
    """mamba2-1.3b's sampling: (4, 50280) fp32 logits, k 1, with a tied
    maximum ranking the lower index first."""
    gen = torch.Generator(device=dev).manual_seed(50280)
    x = _randn(gen, (4, 50280), torch.float32, dev)
    x[2, 777] = x[2, 40000] = x[2].max() + 1.0
    vals, idx = ops.topk(x, 1)
    rv, ri = ref.topk_ref(x.cpu(), 1)
    torch.cuda.synchronize()
    assert torch.equal(vals.cpu(), rv) and torch.equal(idx.cpu(), ri) and idx[2, 0] == 777


# internvl2-26b: a 256-position prefix, 48 q heads over 8 KV heads of head_dim
# 128 (g 6), vocab 92553, d 6144; musicgen-medium: a 64-position prefix, 24 MHA
# heads of head_dim 64 (g 1), 4 codebooks of 2048
FRONTEND_HEADS = {"internvl2-26b": (48, 8, 128, 256, 448), "musicgen-medium": (24, 24, 64, 64, 256)}


@pytest.mark.parametrize("kernel,dtype", [
    ("prefill", torch.float32), ("prefill", torch.bfloat16), ("decode", torch.float32),
    ("decode", torch.bfloat16), ("decode_int8", torch.bfloat16)])
@pytest.mark.parametrize("arch", sorted(FRONTEND_HEADS))
def test_attention_kernels_at_frontend_heads(dev, arch, kernel, dtype):
    """flash_prefill over prefix + 125 prompt positions (a wave of the chip
    phase; one row right-padded past its prompt), and decode_attention and
    its int8 instance over the slot cache, each row's valid length its own
    (prefix + prompt + steps), each against its plain version (the int8
    instance bit for bit against the bf16 one on the dequantized cache)."""
    hq, hkv, hd, prefix, S = FRONTEND_HEADS[arch]
    gen = torch.Generator(device=dev).manual_seed(hd + len(kernel))
    b, scale = 4, hd ** -0.5
    if kernel == "prefill":
        sq = prefix + 125
        q = _randn(gen, (b, hq, sq, hd), dtype, dev)
        k, v = (_randn(gen, (b, hkv, sq, hd), dtype, dev) for _ in range(2))
        q_pos = torch.arange(sq, device=dev, dtype=torch.int32).repeat(b, 1)
        q_pos[1, prefix + 60:] = -1
        got = ops.flash_prefill(q, k, v, q_pos, scale)
        want = ref.flash_prefill_ref(q, k, v, q_pos, scale)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(dtype), rtol=_tol(dtype))
        return
    lens = torch.tensor([prefix + 41, prefix + 90, prefix + 125 + 31, S], device=dev)
    valid = torch.arange(S, device=dev)[None, :] < lens[:, None]
    q = _randn(gen, (b, hq, 1, hd), dtype, dev)
    if kernel == "decode":
        k, v = (_randn(gen, (b, hkv, S, hd), dtype, dev) for _ in range(2))
        got = ops.decode_attention_partial(q, k, v, valid, scale)
        want = ref.decode_attention_ref(q, k, v, valid, scale)
        torch.cuda.synchronize()
        for g, w in zip(got, want):          # (m, l, acc) in fp32
            torch.testing.assert_close(g, w, atol=1e-3, rtol=1e-4)
        return
    (kq, ks), (vq, vs) = (_int8_cache(gen, dev, (b, hkv, S, hd)) for _ in range(2))
    got = ops.decode_attention_partial(q, kq, vq, valid, scale, k_scale=ks, v_scale=vs)
    want = ops.decode_attention_partial(q, ref.dequantize_kv(kq, ks), ref.dequantize_kv(vq, vs),
                                        valid, scale)
    torch.cuda.synchronize()
    _equal_partials(got, want)


@pytest.mark.parametrize("rows,n", [(4, 92553), (16, 2048), (1, 92553)])
def test_topk_kernel_at_frontend_rows(dev, rows, n):
    """The sampling top-k over internvl2-26b's 92553-wide rows (no whole
    number of chunks, rows not 16-byte aligned) and musicgen-medium's
    (4 x 4, 2048) codebook frames, k 1, one launch, a tied maximum ranking
    the lower index first."""
    gen = torch.Generator(device=dev).manual_seed(rows + n)
    x = _randn(gen, (rows, n), torch.float32, dev)
    x[rows - 1, 5] = x[rows - 1, n - 1] = x[rows - 1].max() + 1.0
    before = ops.LAUNCHES["topk"]
    vals, idx = ops.topk(x, 1)
    assert ops.LAUNCHES["topk"] == before + 1
    rv, ri = ref.topk_ref(x.cpu(), 1)
    torch.cuda.synchronize()
    assert torch.equal(vals.cpu(), rv) and torch.equal(idx.cpu(), ri) and idx[rows - 1, 0] == 5


@pytest.mark.parametrize("K,N,out_dtype", [(6144, 6144, torch.bfloat16),
                                           (6144, 1024, torch.bfloat16),
                                           (6144, 92553, torch.float32)])
@pytest.mark.parametrize("T", [4, 500])
def test_dequant_matmul_kernel_at_internvl_int4(dev, K, N, out_dtype, T):
    """internvl2-26b's int4 attention projections (w_q, w_k/w_v) and its
    lm_head of 92553 columns (no 16-byte weight rows; fp32 out), group 128,
    at a decode step (T 4) and a wave prefill (T 500), against the plain
    version (fp32: 1e-4 of the largest output; bf16: within one bf16 ulp of
    it)."""
    gen = torch.Generator(device=dev).manual_seed(K + N + T)
    w = wquant.quantize((torch.randn((K, N), generator=gen, device=dev) * K ** -0.5)
                        .bfloat16(), "int4", 128)
    x = _randn(gen, (T, K), torch.bfloat16, dev)
    got = ops.dequant_matmul(x, w.q, w.scale, mode="int4", group=w.group, out_dtype=out_dtype)
    want = ref.dequant_matmul_ref(x, w.q, w.scale, "int4", w.group)
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    if out_dtype == torch.float32:
        assert (got - want).abs().max().item() <= tol
    else:
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
        assert bool(((got.float() - want).abs() <= ulp + tol).all())


@pytest.mark.parametrize("paged", [False, True])
def test_dispatch_decode_waits_for_nothing(dev, paged):
    """The overlapped loop's contract on the card: a decode block
    dispatched on the previous block's device state before that block
    lands, under ``set_sync_debug_mode("error")``, makes no synchronising
    call; the two chained blocks give one block of 4's tokens and state."""
    from repro_torch.configs import SamplingConfig, get_config
    from repro_torch.runtime.engine import Engine

    eng = Engine(get_config("yi-9b").reduced(), sampling=SamplingConfig(top_k=1), max_len=64,
                 seed=0, device=dev)
    toks = np.tile(np.arange(8, dtype=np.int32) + 3, (2, 1))
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4) if paged else None
    state = dict(pos=np.full(2, 8), done=np.zeros(2, bool), remaining=np.array([4, 2]),
                 eos=np.full(2, -1))
    outs = []
    for chained in (False, True):
        if paged:
            caches = eng.init_paged_caches(2, 9, 16)
            first = eng.prefill_into_slots_paged(caches, toks, np.ones(2, bool), np.full(2, 8),
                                                 np.zeros(2, np.int32), np.full(2, 8), bt)
        else:
            caches = eng.init_slot_caches(2)
            first = eng.prefill_into_slots(caches, toks, np.ones(2, bool), np.full(2, 8))
        if not chained:
            outs.append(eng.decode_slots(caches, first, **state, n=4, block_tables=bt))
            continue
        a = eng.dispatch_decode(caches, first, state["pos"], state["done"], state["remaining"],
                                state["eos"], n=2, block_tables=bt)
        torch.cuda.set_sync_debug_mode("error")
        try:
            b = eng.dispatch_decode(caches, *a.state, state["eos"], n=2, block_tables=bt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ta, tb = eng.land_decode(a), eng.land_decode(b)
        outs.append((np.concatenate([ta[0], tb[0]]), *tb[1:]))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
