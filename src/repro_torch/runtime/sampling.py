"""Sampling on the logits of the last position (``repro.runtime.sampling``
and ``repro.core.topk_sync.sample``): one token a row, or one a codebook of
a multi-codebook head's frame."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import SamplingConfig
from repro_torch.core.topk_sync import distributed_topk, full_gather_topk
from repro_torch.models.common import Dist, ShardPlan


def sample_tokens(logits: torch.Tensor, sampling: SamplingConfig,
                  generator: torch.Generator, plan: Optional[ShardPlan] = None,
                  dist: Dist = Dist(), topk_sync: bool = True) -> torch.Tensor:
    """Next token ids (b,) int64 from (b, V) fp32 logits, or at tp > 1 this
    rank's vocab shard of them (b, local_vocab); (b, ncb) frames from the
    (b, ncb, V) logits of a multi-codebook head, its rows flattened to
    (b * ncb, V) for one top-k call, as the reference samples them.

    The top-k is taken on each shard before the gather (``topk_sync``, the
    paper's section 2.1b) or after gathering the whole row.  Greedy
    (``top_k`` 1) is ``idx[:, 0]``, so ties go to the lowest index.
    Otherwise one draw from the softmax of the top-k values at
    ``temperature``, by the Gumbel-max rule that ``jax.random.categorical``
    uses; the noise comes from ``generator``, so a run repeats itself but
    does not reproduce the JAX package's threefry draws.  Every rank seeds
    its generator alike and draws in the same order, so the sampled ids
    are the same on every rank."""
    frames = logits.shape[:-1]
    logits = logits.reshape(-1, logits.shape[-1])
    k = max(1, sampling.top_k)
    topk = distributed_topk if topk_sync else full_gather_topk
    vals, idx = topk(logits, k, plan, dist)
    idx = idx.long()
    if k == 1:
        return idx[:, 0].reshape(frames)
    scaled = vals / max(sampling.temperature, 1e-6)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(scaled + gumbel, dim=-1, keepdim=True)
    return torch.gather(idx, 1, choice)[:, 0].reshape(frames)
