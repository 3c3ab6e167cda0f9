"""Token embedding: the replicated-table lookup of ``repro.core.embedding``
(paper section 2.1a, token ids are the only thing broadcast).

The table is laid out ``(n_codebooks, V, d)`` as in the JAX package.  At
tp=1 the vocab-sharded variant of the JAX package reduces to this same
lookup, so one path serves every table size the port runs.
"""
from __future__ import annotations

from typing import Dict

import torch


def embed_lookup(params: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """tokens (b, s) int -> (b, s, d) activations in the table's dtype."""
    return params["table"][0][tokens]
