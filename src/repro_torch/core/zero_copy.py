"""Paper section 2.3: the attention output is contracted straight from its
(b, h, s, hd) layout into the residual layout, with no transposed copy
between the heads and the out-projection (``repro.core.zero_copy``)."""
from __future__ import annotations

import torch

from repro_torch.core import wquant

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
