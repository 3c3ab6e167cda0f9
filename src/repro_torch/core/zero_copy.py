"""Paper section 2.3: the attention output is contracted straight from its
(b, h, s, hd) layout into the residual layout, with no transposed copy
between the heads and the out-projection (``repro.core.zero_copy``).

``parallel_partials`` is the same handoff for a parallel-residual layer
(section 2.2): the out-projection of the heads and the FFN's
down-projection are summed into one output by the fused_dual_matmul
kernel, which reads the heads in place.  Under tensor parallelism that
one buffer is the rank's partial that the layer's single all-reduce sums
(``SyncPolicy.reduce_out``, tag ``one_shot``)."""
from __future__ import annotations

import torch

from repro_torch.core import wquant
from repro_torch.kernels import ops

# profiler range around the dequantization of a quantized w_o
# (launch/profile_decode.py reports its device time per step)
W_O_DENSE_RANGE = "w_o dense copy"


def fused_out_projection(attn_heads: torch.Tensor, w_o) -> torch.Tensor:
    """(b, h, s, hd) x (h, hd, d) -> (b, s, d) in one contraction.  A
    quantized ``w_o`` is dequantized to bf16 for it, as the JAX package
    serves this einsum site: a dense copy written and read each call."""
    if isinstance(w_o, wquant.QuantWeight):   # the bf16 path pays no range
        with torch.profiler.record_function(W_O_DENSE_RANGE):
            w_o = wquant.to_dense(w_o)
    return torch.einsum("bhsd,hde->bse", attn_heads, w_o)


def parallel_partials(attn_heads: torch.Tensor, w_o, h: torch.Tensor, w_down, *,
                      fused: bool = True) -> torch.Tensor:
    """heads (b, hq, s, hd) x w_o (hq, hd, d) plus h (b, s, f) x w_down
    (f, d) -> (b, s, d): the attention and FFN partials of a
    parallel-residual layer, summed.  With both weights bf16 one
    fused_dual_matmul sums both products in fp32 and rounds once.  A
    quantized weight keeps the two apart, as the JAX package computes them:
    ``w_o`` dequantized at its einsum site, ``w_down`` through
    dequant_matmul, each partial rounded to bf16 and then added.  So does
    the training forward (``fused`` False): the reference's
    ``attn_p + ffn_p`` of two plain products, which autograd differentiates
    (the kernel's output carries no gradient)."""
    if (not fused or isinstance(w_o, wquant.QuantWeight)
            or isinstance(w_down, wquant.QuantWeight)):
        return fused_out_projection(attn_heads, w_o) + wquant.matmul(h, w_down)
    b, s, f = h.shape
    return ops.fused_dual_matmul(attn_heads, w_o, h.reshape(b * s, f), w_down).view(b, s, -1)
