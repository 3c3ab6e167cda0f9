"""Plain PyTorch versions of the kernels: the same math, no kernel.

The wrappers in ``ops`` run these on CPU tensors; the tests hold them
against the JAX package's Pallas kernels, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  All arithmetic is fp32, whatever the
input type, as in the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import wquant


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(b, hq, s, hd) -> (b, hkv, g, s, hd) fp32: the g query heads that
    share a KV head side by side."""
    b, hq, s, hd = q.shape
    return q.float().reshape(b, hkv, hq // hkv, s, hd)


def flash_prefill_ref(q, k, v, q_pos, scale: float) -> torch.Tensor:
    """Causal GQA attention by view index: row i attends key j iff
    ``j <= q_pos[b, i]``.  Rows with ``q_pos = -1`` attend nothing and come
    out as exact zeros.

    q (b, hq, Sq, hd); k, v (b, hkv, Sk, hd); q_pos (b, Sq) int
    -> (b, hq, Sq, hd) in q.dtype."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = _grouped(q, hkv)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    j = torch.arange(sk, device=q.device)
    ok = j[None, None, None, None, :] <= q_pos[:, None, None, :, None]
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, hd).to(q.dtype)


def decode_attention_ref(q, k, v, valid, scale: float):
    """Unnormalized flash partials for one query token per row.

    q (b, hq, 1, hd); k, v (b, hkv, S, hd); valid (S,) or (b, S) bool
    -> m (b, hq, 1), l (b, hq, 1), acc (b, hq, 1, hd), all fp32; a row with
    no valid key has m = -inf, l = 0, acc = 0."""
    b, hq, _, hd = q.shape
    hkv = k.shape[1]
    qg = _grouped(q, hkv)[:, :, :, 0]                         # (b, hkv, g, hd)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    mask = valid.bool().reshape(-1 if valid.dim() == 2 else 1, 1, 1, valid.shape[-1])
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return m.reshape(b, hq, 1), l.reshape(b, hq, 1), acc.reshape(b, hq, 1, hd)


def topk_ref(x: torch.Tensor, k: int):
    """(b, v) -> (vals (b, k) fp32, idx (b, k) int32), largest first and,
    among equal values, the lowest index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x.float(), dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def dequant_matmul_ref(x, q, scale, mode: str, group: int) -> torch.Tensor:
    """x (T, K) @ dequant(q, scale) in fp32, as the JAX oracle computes it.
    int8: ``(x @ q) * scale``, the per-column scale applied once to the
    sum; int4: ``x @ w`` with ``w`` the unpacked nibbles times the scale of
    their group.  Returns fp32 (T, N); callers cast."""
    xf = x.float()
    if mode == "int8":
        return (xf @ q.float()) * scale.float()[None, :]
    w = wquant.unpack4(q).float()
    K, N = w.shape
    wg = w.reshape(K // group, group, N) * scale.float()[:, None, :]
    return xf @ wg.reshape(K, N)
