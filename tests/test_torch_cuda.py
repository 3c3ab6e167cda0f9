"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc and skip without them.  The file imports
no jax, so on the machine with the card it runs without the repository's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes cover what the main path does not: head_dim 64, ragged tails, pad
rows, g from 1 to 16, per-row masks with a fully masked row, tie-heavy
top-k rows over vocabularies up to qwen's 152064, and dequant matmuls at
every GEMV width, the GEMM, ragged N and K, both groups and unaligned
per-layer views.  Tolerances: bf16 3e-2 as in tests/test_kernels.py; fp32
1e-4, since the kernel and the plain version sum up to a thousand terms in
different orders.  The dequant matmul's products are exact in fp32, so its
fp32 output is held to 1e-4 of the largest output (sums over K up to 8192
in another order), and its bf16 output must be the kernel's own fp32
output rounded, bit for bit.
"""
import numpy as np
import pytest
import torch

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


def test_kernel_launch_is_checked(dev):
    """A launch the card refuses raises instead of returning garbage."""
    x = torch.zeros(2, 300, device=dev)
    with pytest.raises(RuntimeError, match="topk"):
        ops.topk(x, 257)                     # above the kernel's k limit
    assert np.isfinite(ops.topk(x, 3)[0].cpu().numpy()).all()


# (mode, group, K, N): ragged N (97, 520: byte loads), K with a tail past the
# 128-row x tile and the 32-row GEMM tile (200, 1408), a split K (8192)
DQ_CASES = [(mode, group, K, N)
            for mode, group in (("int8", 0), ("int4", 64), ("int4", 128))
            for K, N in ((200, 97), (384, 97), (1408, 520), (8192, 4096))
            if mode == "int8" or K % group == 0]


def _dq_check(got, want):
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert got.dtype == torch.float32 and (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 4, 16, 17, 130])
@pytest.mark.parametrize("mode,group,K,N", DQ_CASES)
def test_dequant_matmul_kernel(dev, mode, group, K, N, T, out_dtype):
    gen = torch.Generator(device=dev).manual_seed(T * K + N)
    w = wquant.quantize(0.05 * _randn(gen, (K, N), torch.bfloat16, dev), mode, group or 128)
    x = _randn(gen, (T, K), torch.bfloat16, dev)
    bits = 8 if mode == "int8" else 4
    before = ops.LAUNCHES["dequant_matmul"]
    got = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=out_dtype)
    launches = build.library("dequant_matmul").dequant_matmul_launches(T, K, N, bits, w.group)
    assert ops.LAUNCHES["dequant_matmul"] == before + launches
    again = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=out_dtype)
    f32 = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=torch.float32)
    want = ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (T, N)
    _dq_check(f32, want)
    assert torch.equal(got, f32.to(out_dtype))   # the same sums, rounded once
    assert torch.equal(got, again)           # no atomics: the same bits each call
    if K == 8192:
        assert launches == 2                 # K split across blocks, then summed


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
