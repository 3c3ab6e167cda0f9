"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc and skip without them.  The file imports
no jax, so on the machine with the card it runs without the repository's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Shapes cover what the main path does not: head_dim 64, ragged tails, pad
rows, g from 1 to 16, per-row masks with a fully masked row, and tie-heavy
top-k rows over vocabularies up to qwen's 152064.  Tolerances: bf16 3e-2 as
in tests/test_kernels.py; fp32 1e-4, since the kernel and the plain version
sum up to a thousand terms in different orders.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


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
