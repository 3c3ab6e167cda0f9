"""Paper section 2.2: one synchronisation per decoder layer, generalised
(``repro.core.sync_policy``).

A tensor-parallel layer ends each of its row-parallel products (attention
out-projection, FFN down-projection) with a reduction: two a layer.  A
parallel-residual layer sums its two partials locally and reduces once
(``one_shot``).  This policy decides every residual-stream collective,
so each layer runs the same countable schedule:

* replicated (decode): the residual is the same on every rank, and a
  branch's partial is all-reduced;
* sequence-sharded (prefill, chunks, verify; Megatron-SP): each rank holds
  its ``seq_chunk`` of the residual; a branch all-gathers the sequence on
  entry and reduce-scatters its partial on exit: the bytes of one
  all-reduce, and 1/tp of the residual per rank.

Unlike the JAX package's, the chunks take any length s (``seq_len``): the
collectives pad and trim, and no row is dropped.

``train`` (the training forward) runs the same schedule through the
differentiable collectives (``collectives.all_gather_ad`` and its pairs):
a gather's backward reduce-scatters, a reduce-scatter's gathers, and a
replicated branch's all-reduce all-reduces its gradient too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import collectives as cc
from repro_torch.models.common import Dist

SEQ_AXIS = 1   # the residual stream is (batch, seq, d_model)


@dataclass(frozen=True)
class SyncPolicy:
    dist: Dist
    seq_sharded: bool = False     # Megatron-SP residual stream
    one_shot: bool = True         # paper section 2.2 for parallel-residual layers
    seq_len: int = 0              # the full sequence a sequence-sharded forward holds
    train: bool = False           # differentiable collectives (the training forward)

    @property
    def _sp(self) -> bool:
        return self.seq_sharded and self.dist.tp > 1

    def gather_in(self, x: torch.Tensor, tag: str = "sp_gather") -> torch.Tensor:
        """Entering a branch, which needs the whole sequence."""
        if self._sp:
            gather = cc.all_gather_ad if self.train else cc.all_gather
            return gather(x, self.dist, SEQ_AXIS, tag=tag, total=self.seq_len)
        return x

    def reduce_out(self, partial: torch.Tensor, tag: str = "branch_reduce") -> torch.Tensor:
        """Leaving a branch: its row-parallel partial reduced, to this
        rank's chunk when the residual is sequence-sharded."""
        if self.dist.tp == 1:
            return partial
        if self.train:
            if self._sp:
                return cc.reduce_scatter_ad(partial, self.dist, SEQ_AXIS, tag=tag)
            return cc.all_reduce_ad(partial, self.dist, tag=tag)
        if self._sp:
            return cc.reduce_scatter(partial, self.dist, SEQ_AXIS, tag=tag)
        return cc.all_reduce(partial, self.dist, tag=tag)

    def shard_residual(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated residual cut down to this rank's sequence chunk."""
        if not self._sp:
            return x
        lo, hi = cc.seq_chunk(x.shape[SEQ_AXIS], self.dist.tp, self.dist.rank)
        return x[:, lo:hi]

    def unshard_residual(self, x: torch.Tensor, tag: str = "final_gather") -> torch.Tensor:
        if not self._sp:
            return x
        gather = cc.all_gather_ad if self.train else cc.all_gather
        return gather(x, self.dist, SEQ_AXIS, tag=tag, total=self.seq_len)
