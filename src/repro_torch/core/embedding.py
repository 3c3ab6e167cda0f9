"""Paper section 2.1a: broadcast token ids, not embedding activations
(``repro.core.embedding``).

The table is laid out ``(n_codebooks, V, d)`` as in the JAX package; a
multi-codebook token frame sums its codebooks' rows.  Token
ids are replicated on every rank (each runs the same scheduler over the
same requests and samples the same ids), so their "broadcast" costs
nothing.  Two table layouts:

* replicated (tables of at most ``REPLICATE_BYTES_LIMIT`` bytes in bf16:
  yi-9b's 500 MiB, gptj-parallel's 413 MB): every rank looks up the whole
  table, zero collective bytes;
* vocab-sharded (qwen-72b's 2.49 GB): each rank holds rows
  [rank * local_vocab, (rank + 1) * local_vocab) of the padded vocab, looks
  up the ids that fall there, zeros elsewhere, and one all-reduce
  (``embed_shard_merge``) sums the ranks' rows.

``id_broadcast=False`` is the paper's baseline: rank 0's activations are
broadcast (``embed_bcast``) after the lookup.  At tp=1 every layout is the
plain lookup.  ``train`` (the training forward) merges a vocab-sharded
lookup through ``collectives.all_reduce_ad``, whose backward sums the
ranks' gradients of the activations, so each rank's rows of the table
get every token's gradient.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as cc
from repro_torch.models.common import Dist, ShardPlan

# tables at or below this many bytes (bf16) are replicated, paper-style
REPLICATE_BYTES_LIMIT = 512 * 2**20


def table_replicated(cfg: ModelConfig) -> bool:
    return (not cfg.tie_embeddings
            and cfg.vocab_size * cfg.d_model * 2 * cfg.n_codebooks <= REPLICATE_BYTES_LIMIT)


def embed_lookup(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 plan: ShardPlan = None, dist: Dist = Dist(), *,
                 id_broadcast: bool = True, train: bool = False) -> torch.Tensor:
    """tokens (b, s) int, or (b, s, n_codebooks) token frames -> (b, s, d)
    activations in the table's dtype, the same on every rank.  A frame's
    rows are summed codebook by codebook in the table's dtype, in the
    reference's order.  The table's rows say its layout: all V, or this
    rank's ``plan.local_vocab`` of a vocab-sharded one."""
    table = params["table"]
    if tokens.dim() == 2:
        tokens = tokens[..., None]
    out = None
    for cb in range(tokens.shape[-1]):
        ids = tokens[..., cb]
        if dist.tp == 1 or table.shape[1] != plan.local_vocab:
            rows = table[cb][ids]
        else:
            local = ids - dist.rank * plan.local_vocab
            ok = (local >= 0) & (local < plan.local_vocab)
            rows = torch.where(ok[..., None], table[cb][local.clamp(0, plan.local_vocab - 1)], 0)
        out = rows if out is None else out + rows
    if dist.tp > 1 and table.shape[1] == plan.local_vocab:
        merge = cc.all_reduce_ad if train else cc.all_reduce
        out = merge(out, dist, tag="embed_shard_merge")
    if not id_broadcast:
        # the baseline: rank 0's activations cross the wire
        out = cc.broadcast_from0(out, dist, tag="embed_bcast")
    return out
