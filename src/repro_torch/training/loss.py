"""Vocab-parallel cross-entropy (``repro.training.loss``): the logits are
sharded over the model ranks, and the (b, s, V) logits are never gathered.
Each rank reduces its shard to (b, s) statistics -- the max, the sum of
exponentials and the label's logit where the rank holds the label -- and
those cross the ranks.

The chunked loss applies the head itself, a sequence chunk at a time,
each chunk's fp32 logits inside ``torch.utils.checkpoint`` (recomputed in
the backward, as the reference's ``jax.checkpoint`` body), so at most one
chunk's logits are ever alive.  The subtracted max is a stability
constant, detached before any collective, as the reference stops its
gradient.  At tp > 1 the max crosses the ranks as an all-reduce max
(recorded as kind ``all_reduce_max``, which the JAX package's ``pmax``
does not record), the sum of exponentials and the label logits as
all-reduces tagged ``xent_sumexp`` and ``xent_label``; over the data
replicas the loss's sum and count are summed (``xent_mean``), so the loss
is the mean over the global batch.  The gradient of every such sum passes
through it (``collectives.all_reduce_ad(grad_sum=False)``,
``data_sum_ad``): every rank turns the sums into the same loss.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint

from repro_torch.core import collectives as cc
from repro_torch.models.common import Dist, ShardPlan


def _offset(plan: ShardPlan, dist: Dist) -> int:
    return dist.rank * plan.local_vocab if dist.tp > 1 else 0


def _label_logit(logits: torch.Tensor, labels: torch.Tensor, lo: int, local_vocab: int):
    """The label's logit where this rank holds it, else 0."""
    lid = labels.long() - lo
    ok = (lid >= 0) & (lid < local_vocab)
    picked = logits.gather(-1, lid.clamp(0, local_vocab - 1)[..., None])[..., 0]
    return torch.where(ok, picked, 0.0)


def _mean(nll: torch.Tensor, mask: torch.Tensor, dist: Dist) -> torch.Tensor:
    tot, cnt = (nll * mask).sum(), mask.sum()
    if dist.dp > 1:
        tot = cc.data_sum_ad(tot, dist, tag="xent_mean")
        cnt = cc.data_all_reduce(cnt.detach().clone(), dist, tag="xent_mean")
    return tot / torch.clamp(cnt, min=1.0)


def vocab_parallel_xent(local_logits: torch.Tensor, labels: torch.Tensor, plan: ShardPlan,
                        dist: Dist, *, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over the tokens of the global batch.
    local_logits (b, s, V_local) fp32, or (b, s, ncb, V_local); labels (b,
    s) or (b, s, ncb) global vocab ids; mask (b, s), 1 = count."""
    if local_logits.dim() == 4:          # codebook models: fold ncb into seq
        b, s, ncb, v = local_logits.shape
        local_logits = local_logits.reshape(b, s * ncb, v)
        labels = labels.reshape(b, s * ncb)
        if mask is not None:
            mask = mask.repeat_interleave(ncb, dim=1)
    gmax = cc.all_reduce_max(local_logits.detach().amax(dim=-1), dist, "xent_sumexp")
    sumexp = torch.exp(local_logits - gmax[..., None]).sum(dim=-1)
    sumexp = cc.all_reduce_ad(sumexp, dist, tag="xent_sumexp", grad_sum=False)
    lse = torch.log(sumexp) + gmax
    picked = _label_logit(local_logits, labels, _offset(plan, dist), plan.local_vocab)
    picked = cc.all_reduce_ad(picked, dist, tag="xent_label", grad_sum=False)
    nll = lse - picked
    return _mean(nll, torch.ones_like(nll) if mask is None else mask, dist)


def chunked_vocab_parallel_xent(hidden: torch.Tensor, head_fn: Callable, labels: torch.Tensor,
                                plan: ShardPlan, dist: Dist, *, chunk: int = 512,
                                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same loss from the final-norm hidden states (b, s, d) and the
    head ``head_fn`` ((b, c, d) -> fp32 local logits (b, c, [ncb,]
    V_local)), a chunk of ``chunk`` positions at a time; every cross-rank
    collective runs once, after the chunks, on (b, s)-sized statistics."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} not divisible by xent chunk {c}")
    lo = _offset(plan, dist)
    ncb = labels.shape[2] if labels.dim() == 3 else 1
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)

    def body(h_c: torch.Tensor, lab_c: torch.Tensor):
        logits = head_fn(h_c)                                        # fp32
        if logits.dim() == 4:
            logits = logits.reshape(b, c * ncb, plan.local_vocab)
        lmax = logits.detach().amax(dim=-1)
        sexp = torch.exp(logits - lmax[..., None]).sum(dim=-1)
        return lmax, sexp, _label_logit(logits, lab_c, lo, plan.local_vocab)

    parts = [torch.utils.checkpoint.checkpoint(
        body, hidden[:, c0:c0 + c], labels[:, c0:c0 + c].reshape(b, c * ncb),
        use_reentrant=False) for c0 in range(0, s, c)]
    lmax, sexp, picked = (torch.cat(t, dim=1) for t in zip(*parts))   # (b, s * ncb)
    if dist.tp > 1:
        gmax = cc.all_reduce_max(lmax, dist, "xent_sumexp")
        sexp = cc.all_reduce_ad(sexp * torch.exp(lmax - gmax), dist, tag="xent_sumexp",
                                grad_sum=False)
        picked = cc.all_reduce_ad(picked, dist, tag="xent_label", grad_sum=False)
    else:
        gmax = lmax
    nll = torch.log(sexp) + gmax - picked
    return _mean(nll, mask.repeat_interleave(ncb, dim=1), dist)
