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


def flash_prefill_ref(q, k, v, q_pos, scale: float, window: int = 0) -> torch.Tensor:
    """Causal GQA attention by view index: row i attends key j iff
    ``j <= q_pos[b, i]`` and, with ``window`` > 0, ``j > q_pos[b, i] -
    window`` (a sliding window over fresh K/V, where view index ==
    position).  Rows with ``q_pos = -1`` attend nothing and come out as
    exact zeros.

    q (b, hq, Sq, hd); k, v (b, hkv, Sk, hd); q_pos (b, Sq) int
    -> (b, hq, Sq, hd) in q.dtype."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = _grouped(q, hkv)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    j = torch.arange(sk, device=q.device)
    qp = q_pos[:, None, None, :, None]
    ok = j[None, None, None, None, :] <= qp
    if window > 0:
        ok = ok & (j[None, None, None, None, :] > qp - window)
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, hd).to(q.dtype)


def flash_verify_ref(q, k, v, q_pos, scale: float) -> torch.Tensor:
    """The verify step's attention: ``flash_prefill_ref`` at a narrow query
    chunk (Sq = spec_k + 1).  The function is the same; only the kernel's
    blocking differs (its KV axis split across blocks, then merged)."""
    return flash_prefill_ref(q, k, v, q_pos, scale)


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


def paged_view(pool: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Block pool (nb, h, bs, hd) gathered through the table bt (b, nbps)
    -> per-slot dense view (b, h, nbps*bs, hd), view index == position
    (``_paged_view`` of the JAX package)."""
    b, nbps = bt.shape
    g = pool[bt.long()].transpose(1, 2)                       # (b, h, nbps, bs, hd)
    return g.reshape(b, pool.shape[1], nbps * pool.shape[2], pool.shape[3])


# The int8 KV cache.  The JAX package's ``_quantize_kv`` divides the clamped
# absmax by 127; jitted, XLA folds that division by a constant into a
# product with the fp32 constant 1/127, which rounds apart from the
# division for some values.  The port computes what the reference runs.
KV_INV_QMAX = 1.0 / 127.0


def quantize_kv(x: torch.Tensor):
    """(..., hd) -> (int8 values (..., hd), bf16 scales (...)), bit for bit
    the JAX package's ``_quantize_kv``: per row the fp32 absmax, ``scale =
    max(amax, 1e-6) * (1/127)`` in fp32, ``q = clip(round(x / scale), -127,
    127)`` (IEEE division, half to even) with the fp32 scale, the scale
    stored in bf16."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) * KV_INV_QMAX
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 (..., hd) with bf16 scales (...) -> ``dtype``: fp32(q) times
    fp32(scale), rounded once (``_dequantize_kv``)."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def kv_quant_write_ref(k, v, k_cache, v_cache, k_scale, v_scale, dst_row, dst_idx):
    """In place: ``quantize_kv`` of the fresh k, v (b, h, s, hd), token t of
    the flat (row, position) order written to [dst_row[t], :, dst_idx[t]]
    of the caches (n, h, m, hd) int8 and scales (n, h, m) bf16, tokens with
    dst_row < 0 dropped.  -> the dequantized fresh (k, v) (b, h, s, hd)
    bf16."""
    b, h, s, hd = k.shape
    keep = dst_row >= 0
    rows, idx = dst_row[keep].long(), dst_idx[keep].long()
    out = []
    for x, cache, scales in ((k, k_cache, k_scale), (v, v_cache, v_scale)):
        q, sc = quantize_kv(x)
        cache[rows, :, idx] = q.transpose(1, 2).reshape(b * s, h, hd)[keep]
        scales[rows, :, idx] = sc.transpose(1, 2).reshape(b * s, h)[keep]
        out.append(dequantize_kv(q, sc))
    return tuple(out)


def paged_decode_attention_ref(q, k_pool, v_pool, bt, valid, scale: float):
    """``decode_attention_ref`` over the view gathered through the block
    table.  q (b, hq, 1, hd); pools (nb, hkv, bs, hd); bt (b, nbps) int;
    valid (b, nbps*bs) bool -> fp32 partials m, l (b, hq, 1), acc
    (b, hq, 1, hd)."""
    return decode_attention_ref(q, paged_view(k_pool, bt), paged_view(v_pool, bt), valid, scale)


def paged_flash_prefill_ref(q, k_pool, v_pool, bt, q_pos, scale: float) -> torch.Tensor:
    """``flash_prefill_ref`` over the view gathered through the block table:
    row i attends view index j iff j <= q_pos[b, i].  q (b, hq, Sq, hd);
    pools (nb, hkv, bs, hd); bt (b, nbps) int; q_pos (b, Sq) int ->
    (b, hq, Sq, hd) in q.dtype."""
    return flash_prefill_ref(q, paged_view(k_pool, bt), paged_view(v_pool, bt), q_pos, scale)


def topk_ref(x: torch.Tensor, k: int):
    """(b, v) -> (vals (b, k) fp32, idx (b, k) int32), largest first and,
    among equal values, the lowest index first (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x.float(), dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def lru_scan_ref(a, b, h0):
    """The linear recurrence ``h_t = a_t h_{t-1} + b_t`` over the sequence,
    step by step in fp32 whatever the input type.  a, b (batch, seq, w);
    h0 (batch, w) -> (h (batch, seq, w) fp32, h_final (batch, w) fp32)."""
    af, bf = a.float(), b.float()
    h = h0.float()
    hs = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs, h


# The kernel's tiles combine carries in another order than the plain
# version's loop, so both are held to an fp64 scan of the same inputs: the
# kernel's worst error may be at most LRU_ERR_FACTOR times the plain
# version's, or LRU_ERR_FLOOR times the largest |h|, whichever is larger.
LRU_ERR_FACTOR, LRU_ERR_FLOOR = 4, 1e-5


def lru_scan_fp64(a, b, h0):
    """``lru_scan_ref`` in fp64: -> (h (batch, seq, w), h_final (batch, w))."""
    af, bf, h = a.double(), b.double(), h0.double()
    hs = torch.empty(af.shape, dtype=torch.float64, device=a.device)
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs[:, t] = h
    return hs, h


def lru_scan_limit(a, b, h0) -> dict:
    """The fp64 scan of the inputs (``want``, ``want_T``), the plain
    version's worst error against it (``plain``) and the limit of a
    kernel's worst error (``limit``)."""
    want, want_T = lru_scan_fp64(a, b, h0)
    hs, hT = lru_scan_ref(a, b, h0)
    plain = max((hs.double() - want).abs().max().item(),
                (hT.double() - want_T).abs().max().item())
    return {"want": want, "want_T": want_T, "plain": plain,
            "limit": max(LRU_ERR_FACTOR * plain, LRU_ERR_FLOOR * want.abs().max().item())}


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


def fused_dual_matmul_ref(a, wa, b, wb) -> torch.Tensor:
    """``a @ wa + b @ wb`` with both products in fp32, cast once to a's type
    (``repro.kernels.ref.fused_residual_ref``).  a (T, Ka), wa (Ka, D),
    b (T, Kb), wb (Kb, D) -> (T, D)."""
    return (a.float() @ wa.float() + b.float() @ wb.float()).to(a.dtype)
