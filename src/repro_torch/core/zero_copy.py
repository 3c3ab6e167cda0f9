"""Paper section 2.3: the attention output is contracted straight from its
(b, h, s, hd) layout into the residual layout, with no transposed copy
between the heads and the out-projection (``repro.core.zero_copy``)."""
from __future__ import annotations

import torch


def fused_out_projection(attn_heads: torch.Tensor, w_o: torch.Tensor) -> torch.Tensor:
    """(b, h, s, hd) x (h, hd, d) -> (b, s, d) in one contraction."""
    return torch.einsum("bhsd,hde->bse", attn_heads, w_o)
