"""Paper section 2.1b: each rank takes the top-k of its vocab shard before
any reduction, so only (k values, k global indices) a row cross the wire
(``repro.core.topk_sync``).

``distributed_topk``: the top-k kernel on the rank's (b, local_vocab)
logits, global index = local index + rank * local_vocab, an all-gather of
the tp * k candidates and the kernel once more over them.  The candidates
arrive rank by rank, each rank's largest first and ties to the lowest
index, so the second top-k (ties to the lowest position) keeps the global
order of ``lax.top_k``: ties to the lowest global index, NaN above +inf.
``full_gather_topk`` is the baseline: all-gather the whole logits row, then
one top-k.  At tp=1 both are the local top-k.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives as cc
from repro_torch.kernels import ops
from repro_torch.models.common import Dist, ShardPlan


def local_topk(logits: torch.Tensor, k: int):
    """(b, V) fp32 -> (vals (b, k) fp32, idx (b, k) int32), largest first,
    ties to the lowest index (the top-k kernel on CUDA tensors)."""
    return ops.topk(logits, k)


def distributed_topk(local_logits: torch.Tensor, k: int, plan: ShardPlan, dist: Dist):
    """The global (vals, idx) top-k over vocab-sharded logits (b,
    local_vocab), the same on every rank."""
    vals, idx = local_topk(local_logits, k)
    if dist.tp == 1:
        return vals, idx
    gidx = idx + dist.rank * plan.local_vocab
    vals_g = cc.all_gather(vals, dist, 1, tag="topk_vals")
    gidx_g = cc.all_gather(gidx, dist, 1, tag="topk_idx")
    top_vals, pos = local_topk(vals_g, k)
    return top_vals, torch.gather(gidx_g, 1, pos.long())


def full_gather_topk(local_logits: torch.Tensor, k: int, plan: ShardPlan, dist: Dist):
    """The baseline: the whole logits row gathered (vocab bytes), then one
    top-k."""
    full = cc.all_gather(local_logits, dist, 1, tag="full_logits")
    return local_topk(full, k)
