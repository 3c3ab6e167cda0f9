"""Weight-only quantization: packed low-precision weights and bf16 scales
(``repro.core.wquant`` at tp=1).

A decode step sweeps every weight byte once, so storing the projections in
fewer bits shrinks the step's memory traffic: int4 sweeps about a quarter of
what bf16 sweeps.

* ``int8``: per-output-column symmetric scales, ``W ~ q * s[n]`` with
  ``q`` int8 in [-127, 127] and one bf16 scale per output column.
* ``int4``: group-wise symmetric scales, one per ``group``-long segment of
  the reduction dim and output column; ``q`` in [-7, 7], two values per
  byte, even k in the low nibble.

Every quantized weight keeps the layout the model declares, ``(*B, K, N)``:
leading batch dims (the layer stack, the heads of ``w_o``, the codebook of
the lm_head), the reduction dim at -2, the output dim last.  Quantization
is bit-exact with the JAX package: the scale is rounded to bf16 before the
division and ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops

MODES = ("int8", "int4")


@dataclass
class QuantWeight:
    """A quantized weight: ``q`` int8 ``(*B, K, N)`` (int8) or uint8
    ``(*B, K//2, N)`` (int4); ``scale`` bf16 ``(*B, N)`` (int8) or
    ``(*B, K//group, N)`` (int4); ``group`` the effective int4 group (0
    for int8) and ``k`` the unpacked reduction length.  The tensors' device
    decides whether a product goes through the kernel or its plain
    version."""

    q: torch.Tensor
    scale: torch.Tensor
    mode: str = "int8"
    group: int = 0
    k: int = 0


def effective_group(k: int, group_size: int) -> int:
    """Largest even group <= group_size that divides the reduction length;
    0 if there is none.  (The JAX package also clamps to the per-shard
    length under tensor parallelism, which the port does not have yet.)"""
    for cand in range(min(group_size, k), 1, -1):
        if cand % 2 == 0 and k % cand == 0:
            return cand
    return 0


def quantizable(shape, mode: str, group_size: int) -> bool:
    """A weight quantizes if it has a (K, N) tail and, for int4, an even
    grouping of K exists."""
    if len(shape) < 2:
        return False
    k = shape[-2]
    if k < 2:
        return False
    if mode == "int4":
        return k % 2 == 0 and effective_group(k, group_size) > 0
    return mode == "int8"


def pack4(q4: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], (*B, K, N) -> uint8 (*B, K//2, N); even k in
    the low nibble, odd k in the high nibble."""
    lo = (q4[..., 0::2, :] & 0xF).to(torch.uint8)
    hi = (q4[..., 1::2, :] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def _nibbles(packed: torch.Tensor):
    """uint8 (*B, K//2, N) -> the low and the high nibbles (even and odd k)
    as int8, sign-extended by arithmetic shifts of the byte."""
    return (packed << 4).view(torch.int8) >> 4, packed.view(torch.int8) >> 4


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (*B, K//2, N) -> int8 (*B, K, N), two's-complement nibbles."""
    shape = packed.shape[:-2] + (2 * packed.shape[-2], packed.shape[-1])
    return torch.stack(_nibbles(packed), dim=-2).reshape(shape)


def quantize(w: torch.Tensor, mode: str, group_size: int) -> QuantWeight:
    """Symmetric quantization of ``w`` (*B, K, N) at load time."""
    if mode not in MODES:
        raise ValueError(f"weight_quant mode {mode!r} not in {MODES}")
    k = w.shape[-2]
    wf = w.float()

    def stored(amax, levels):
        # divide by the scale dequantization will use: the bf16-stored one
        s = torch.clamp_min(amax, 1e-8) / levels
        return s.to(torch.bfloat16).float()

    if mode == "int8":
        scale = stored(wf.abs().amax(dim=-2), 127.0)                 # (*B, N)
        q = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127).to(torch.int8)
        return QuantWeight(q, scale.to(torch.bfloat16), "int8", 0, k)
    g = effective_group(k, group_size)
    if not g:
        raise ValueError(f"no even int4 group for K={k}, group_size={group_size}")
    lead = w.shape[:-2]
    wg = wf.reshape(*lead, k // g, g, w.shape[-1])
    scale = stored(wg.abs().amax(dim=-2), 7.0)                       # (*B, K/g, N)
    q4 = torch.clamp(torch.round(wg / scale[..., None, :]), -7, 7)
    q4 = q4.reshape(*lead, k, w.shape[-1]).to(torch.int8)
    return QuantWeight(pack4(q4), scale.to(torch.bfloat16), "int4", g, k)


def dequantize(w: QuantWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """QuantWeight -> dense (*B, K, N) weight in ``dtype``.  Each value is
    ``q * s`` rounded once to ``dtype``: the product of a 7-bit integer and
    a bf16 scale is exact in fp32, so multiplying in ``dtype`` gives the
    JAX package's fp32-then-cast bits for bf16 and fp32 alike."""
    if w.mode == "int8":
        return w.q * w.scale.to(dtype)[..., None, :]
    # each nibble times the scale of its group, written straight into the
    # even and odd K rows of the output (no unpacked int8 copy in between)
    lead, half, N = w.q.shape[:-2], w.q.shape[-2], w.q.shape[-1]
    g = w.group // 2                                     # packed rows per group
    out = torch.empty((*lead, half // g, g, 2, N), dtype=dtype, device=w.q.device)
    s = w.scale.to(dtype)[..., None, :]                  # (*B, K/group, 1, N)
    for i, nib in enumerate(_nibbles(w.q)):
        torch.mul(nib.reshape(*lead, half // g, g, N), s, out=out[..., i, :])
    return out.reshape(*lead, 2 * half, N)


def to_dense(w, dtype=torch.bfloat16):
    """A plain tensor passes through; a QuantWeight is dequantized (the
    batched einsum sites, such as the zero-copy out-projection)."""
    return dequantize(w, dtype) if isinstance(w, QuantWeight) else w


def matmul(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` with ``w`` a tensor or a 2-D QuantWeight,
    which goes through ``ops.dequant_matmul`` (the kernel on the card, its
    plain version on the CPU)."""
    if not isinstance(w, QuantWeight):
        y = x @ w
        return y if out_dtype is None else y.to(out_dtype)
    if w.q.dim() != 2:
        raise ValueError("wquant.matmul serves 2-D weights; use to_dense for batched sites")
    lead = x.shape[:-1]
    y = ops.dequant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w.q, w.scale, mode=w.mode,
                           group=w.group, out_dtype=out_dtype or x.dtype)
    return y.reshape(*lead, y.shape[-1])


def map_tensors(w, fn):
    """``fn`` applied to a tensor, or to the values and the scales of a
    QuantWeight (an index, a device move)."""
    if isinstance(w, QuantWeight):
        return QuantWeight(fn(w.q), fn(w.scale), w.mode, w.group, w.k)
    return fn(w)


def index_batch(w: QuantWeight, i: int) -> QuantWeight:
    """Drop one leading batch dim (a layer of the stack, the codebook axis
    of the lm_head)."""
    return map_tensors(w, lambda t: t[i])


def quant_bytes(shape, mode: str, group_size: int) -> int:
    """Stored bytes of the quantized form (values and bf16 scales)."""
    n_el = math.prod(shape)
    lead_n = n_el // shape[-2]                       # (*B, N) element count
    if mode == "int8":
        return n_el + 2 * lead_n
    g = effective_group(shape[-2], group_size)
    return n_el // 2 + 2 * lead_n * (shape[-2] // g)
