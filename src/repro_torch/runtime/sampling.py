"""Sampling on the logits of the last position (``repro.runtime.sampling``
and ``repro.core.topk_sync.sample`` at tp=1, one codebook)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import SamplingConfig
from repro_torch.core.topk_sync import local_topk


def sample_tokens(logits: torch.Tensor, sampling: SamplingConfig,
                  generator: torch.Generator) -> torch.Tensor:
    """Next token ids (b,) int64 from (b, V) fp32 logits.

    Greedy (``top_k`` 1) is ``idx[:, 0]``, so ties go to the lowest index.
    Otherwise one draw from the softmax of the top-k values at
    ``temperature``, by the Gumbel-max rule that ``jax.random.categorical``
    uses; the noise comes from ``generator``, so a run repeats itself but
    does not reproduce the JAX package's threefry draws."""
    k = max(1, sampling.top_k)
    vals, idx = local_topk(logits, k)
    idx = idx.long()
    if k == 1:
        return idx[:, 0]
    scaled = vals / max(sampling.temperature, 1e-6)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(scaled + gumbel, dim=-1, keepdim=True)
    return torch.gather(idx, 1, choice)[:, 0]
