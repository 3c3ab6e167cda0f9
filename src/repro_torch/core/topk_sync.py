"""Paper section 2.1b at tp=1: top-k over the local logits before any
reduction (``repro.core.topk_sync``).

With one shard the candidate all-gather and the re-top-k over the gathered
candidates are the identity, so the local top-k is the global one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def local_topk(logits: torch.Tensor, k: int):
    """(b, V) fp32 -> (vals (b, k) fp32, idx (b, k) int32), largest first,
    ties to the lowest index (the top-k kernel on CUDA tensors)."""
    return ops.topk(logits, k)
