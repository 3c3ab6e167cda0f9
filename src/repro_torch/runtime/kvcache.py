"""Slot utilities of the continuous-batching caches, and the paged-KV block
allocator (``repro.runtime.kvcache`` for one device, one data shard).

Cache layouts (built by ``models.model.init_caches``) are one dict for the
whole model; ``pos`` is shared by every layer, since all layers hold the
same positions:

* slot cache: ``k``/``v`` (L, b, hkv, S, hd), ``pos`` (b, S) -- row b is
  slot b, and ``pos[b, j]`` is the absolute position held at index j
  (-1 = empty);
* the recurrent state of the n RG-LRU layers (slot cache): ``h`` (n, b, w)
  and ``conv`` (n, b, W-1, w), slot b's in row b; of n SSD layers ``h``
  (n, b, heads, P, N) and ``conv`` (n, b, W-1, d_in + 2N), in every layout
  (an attention-free model's pools hold no layer);
* a sliding-window ring (slot cache): ``pos[b, j]`` is the position held at
  ring index j = position % S;
* behind a modality frontend's prefix (internvl2-26b, musicgen-medium) a
  slot's positions 0..prefix-1 hold the projected features and its prompt
  follows: every extent the engine passes here counts the prefix;
* an MLA model caches latents, ``ckv``/``krope`` (L, b, 1, S, r), in place
  of K/V, in every layout (pools (L, n_blocks, 1, bs, r));
* paged cache: ``k``/``v`` are block pools (L, n_blocks, hkv, bs, hd)
  addressed through a per-slot block table (b, nbps) that the scheduler
  keeps on the host; ``pos`` (b, nbps*bs) is per-slot over the slot's view,
  where view index == absolute position;
* an int8 cache (``kv_quant``) holds int8 ``k``/``v`` and bf16
  ``k_scale``/``v_scale`` of their shape less hd, in every layout.

The JAX package updates caches functionally and picks the admitted rows
with ``merge_slots``.  Here every update is **in place** and takes the
admission mask itself, so rows outside it keep their bytes untouched --
what ``merge_slots`` guarantees there; pool leaves need no merge at all,
because the admission computes the admitted rows only and writes through
their own table rows.

``BlockAllocator`` is host logic, the JAX package's semantics: one block
namespace per data shard (at dp > 1 each data rank holds its shard's pool
of ``blocks_per_shard`` blocks, and a slot's table holds local ids of its
shard's pool), refcounted blocks, local block 0 of every shard reserved as
the null block (a write sink that is never validly read), hash-chained
prefix keys verified against the stored tokens, and the migration pins of
disaggregated serving.  Every method takes the shard last (default 0, the
one shard at dp = 1).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

NULL_BLOCK = 0      # reserved write sink; never allocated, never valid

# pool-shaped leaves of the paged layout: indexed by block id, not by slot
# (K/V, or an MLA model's latents)
POOL_KEYS = ("k", "v", "ckv", "krope")
# an int8 cache's scales, shaped as k / v less hd (pools in the paged layout)
SCALE_KEYS = ("k_scale", "v_scale")


def cache_bytes(caches: Dict[str, torch.Tensor]) -> int:
    """Device bytes of a cache dict: K/V (or pools), an int8 cache's
    scales, positions and recurrent state."""
    return sum(t.numel() * t.element_size() for t in caches.values())


def _rows(mask, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(mask, dtype=bool), device=device)


def device_ints(x, device, dtype=torch.long) -> torch.Tensor:
    """A fresh device copy of host ints (never a view of the caller's
    array, which the scheduler mutates while the device may still read)."""
    return torch.from_numpy(np.array(x, dtype=np.int64)).to(device, dtype)


def reset_slots(caches: Dict[str, torch.Tensor], mask, *, paged: bool = False) -> None:
    """In place: the position rows of the slots in ``mask`` (b,) go to -1,
    which masks every stale K/V entry without touching the K/V bytes (they
    are dead by position and are overwritten as the new request runs), and
    their recurrent state zeroes, since a prefill integrates it from t=0.
    An int8 slot cache's scale rows zero too, so that a dead entry
    dequantizes to exactly 0 and a fresh slot starts as a fresh cache
    does; ``paged``: scales are block pools, left alone like the K/V pools
    (the JAX package's ``reset_slots``)."""
    pos = caches["pos"]
    rows = _rows(mask, pos.device)
    pos[rows] = -1
    for key in ("h", "conv") + (() if paged else SCALE_KEYS):
        if key in caches:
            caches[key][:, rows] = 0


def mask_prompt_padding(caches: Dict[str, torch.Tensor], plens, mask) -> None:
    """In place, for the slots in ``mask``: invalidate the position entries
    at and after each slot's true prompt length ``plens[b]`` (behind a
    frontend's prefix, the prefix and the prompt: positions count from the
    prefix's start).  Admission prefills a right-padded batch; the K/V
    written for padding tokens must never be attended, and decode
    overwrites index plen, plen+1, ...  On a
    ring this holds only while index == position, so a prompt longer than
    the cache raises (the schedulers cap prompts at the window)."""
    pos = caches["pos"]
    longest = int(np.max(np.asarray(plens)[np.asarray(mask, bool)], initial=0))
    if longest > pos.shape[1]:
        raise ValueError(f"an admitted prompt of {longest} tokens is longer than the cache "
                         f"of {pos.shape[1]}")
    idx = torch.arange(pos.shape[1], device=pos.device)
    plens = device_ints(plens, pos.device)
    drop = _rows(mask, pos.device)[:, None] & (idx[None, :] >= plens[:, None])
    pos.masked_fill_(drop, -1)


def position_rows(totals: torch.Tensor, S: int, ring: bool = False) -> torch.Tensor:
    """(c,) totals -> (c, S) position rows over which exactly positions
    [0, totals[r]) read valid, -1 elsewhere: index j holds position j, or
    on a ``ring`` the largest p = j (mod S) below the total, valid iff it
    is among the last S written (``set_slot_positions`` of the reference,
    its ring layout)."""
    idx = torch.arange(S, device=totals.device, dtype=totals.dtype)[None, :]
    t = totals[:, None]
    if not ring:
        return torch.where(idx < t, idx, -1)
    p = idx + torch.div(t - 1 - idx, S, rounding_mode="floor") * S
    return torch.where((p >= 0) & (p >= t - S), p, -1)


def set_slot_positions(caches: Dict[str, torch.Tensor], total_lens, mask, *,
                       ring: bool = False) -> None:
    """In place, for the slots in ``mask``: rewrite the position row so that
    exactly positions [0, total_lens[b]) read as valid (``position_rows``;
    ``ring``: a sliding-window slot ring), everything else -1.  The paged
    admission's and the chunk's position update: a cached prefix or the
    earlier chunks and the freshly written tokens become one valid run."""
    pos = caches["pos"]
    row = position_rows(device_ints(total_lens, pos.device, pos.dtype), pos.shape[1], ring)
    m = _rows(mask, pos.device)
    pos[m] = row[m]


def rewind_slots(caches: Dict[str, torch.Tensor], rows: torch.Tensor,
                 totals: torch.Tensor, *, ring: bool = False) -> None:
    """In place, from device tensors: the position rows of slots ``rows``
    (c,) read valid over exactly [0, totals[r]) -- the verify step's rewind.
    Accepted drafts stay valid; the K/V of rejected ones stay behind, dead
    by position, until the next chunk at the frontier overwrites them.  On
    a ``ring`` a rejected draft at position q sits where q - S was, which
    the row then claims; the ring's ``spec_k`` slack entries keep q - S
    out of every later query's window."""
    pos = caches["pos"]
    pos[rows] = position_rows(totals.to(pos.dtype), pos.shape[1], ring)


def pool_block_bytes(caches: Dict[str, torch.Tensor]) -> int:
    """Bytes one block holds across every pool leaf (K/V or latents, an int8
    cache's scales too), all layers and this rank's heads: the unit of the
    migration traffic of disaggregated serving (``repro.runtime.kvcache``'s
    ``pool_block_bytes``)."""
    return sum(t[:, 0].numel() * t.element_size() for key, t in caches.items()
               if key in POOL_KEYS + SCALE_KEYS)


class BlockAllocator:
    """Hands out, refcounts and frees KV blocks; tracks reusable prefixes.

    The pool's blocks split into ``n_shards`` independent namespaces of
    ``blocks_per_shard`` (one per data shard): a slot on shard d references
    only that shard's local blocks, and local block 0 of every shard is the
    null block.

    Prefix reuse is vLLM-style hash chaining: full block ``i`` of a prompt
    is keyed by ``h_i = hash((h_{i-1}, tokens[i*bs:(i+1)*bs]))``, so a hit
    means the whole chain matches, and every hit is checked against the
    block's stored tokens.  Registered blocks are full and never written
    again (decode writes only a request's private tail block), so sharing
    needs no copy.  An entry lives as long as its block has a reference.

    Migration pins (``begin_migration``/``end_migration``): a block queued
    for a copy to another shard holds an extra reference until the copy
    has run, so releasing its slot cannot hand it to a new prefill first.
    """

    def __init__(self, n_blocks: int, block_size: int, n_shards: int = 1):
        if n_blocks % n_shards:
            raise ValueError(f"n_blocks {n_blocks} must divide shards {n_shards}")
        per = n_blocks // n_shards
        if per < 2:
            raise ValueError("need >= 2 blocks per shard (one is the null block)")
        self.block_size = block_size
        self.n_blocks = n_blocks
        self.n_shards = n_shards
        self.blocks_per_shard = per
        self._free = [deque(range(1, per)) for _ in range(n_shards)]
        self._ref: List[Dict[int, int]] = [{} for _ in range(n_shards)]
        # (shard, chain hash) -> (block id, the block's exact tokens);
        # (shard, block) -> chain hash
        self._prefix: Dict[Tuple[int, int], Tuple[int, Tuple[int, ...]]] = {}
        self._prefix_of: Dict[Tuple[int, int], int] = {}
        self._migrating = 0          # source blocks pinned by queued copies

    # -- accounting -------------------------------------------------------
    def free_count(self, shard: int = 0) -> int:
        return len(self._free[shard])

    def used_count(self, shard: int = 0) -> int:
        return len(self._ref[shard])

    def total_used(self) -> int:
        return sum(len(r) for r in self._ref)

    def refcount(self, block: int, shard: int = 0) -> int:
        return self._ref[shard].get(block, 0)

    def migrating_count(self) -> int:
        return self._migrating

    def audit(self, expect_no_migration: bool = False) -> None:
        """Raise ``AssertionError`` naming the first broken invariant, shard
        by shard: free and referenced blocks are exactly local 1..per-1
        with no duplicates and the null block in neither; every refcount
        >= 1; every prefix entry points at a live block, and the two prefix
        maps agree; the migration pins never go negative and, with
        ``expect_no_migration``, have all drained."""
        full = set(range(1, self.blocks_per_shard))
        for sh in range(self.n_shards):
            free = list(self._free[sh])
            fset, refd = set(free), set(self._ref[sh])
            assert len(free) == len(fset), f"shard {sh}: duplicate blocks on the free list"
            assert not fset & refd, f"shard {sh}: blocks both free and referenced: {fset & refd}"
            assert 0 not in fset and 0 not in refd, f"shard {sh}: null block entered circulation"
            assert fset | refd == full, (f"shard {sh}: conservation broken: leaked "
                                         f"{full - fset - refd}, foreign {(fset | refd) - full}")
            for b, c in self._ref[sh].items():
                assert c >= 1, f"shard {sh}: block {b} refcount {c} < 1"
        for (sh, h), (b, _) in self._prefix.items():
            assert self._prefix_of.get((sh, b)) == h, \
                f"shard {sh}: prefix maps disagree for block {b}"
            assert b in self._ref[sh], f"shard {sh}: prefix cache points at dead block {b}"
        for (sh, b), h in self._prefix_of.items():
            assert self._prefix.get((sh, h), (None,))[0] == b, \
                f"shard {sh}: prefix entry of block {b} orphaned"
        assert self._migrating >= 0, f"migration pin counter underflow: {self._migrating}"
        if expect_no_migration:
            assert self._migrating == 0, f"{self._migrating} migration pins never drained"

    # -- migration pins ---------------------------------------------------
    def begin_migration(self, blocks: Sequence[int], shard: int = 0) -> None:
        """Pin source ``blocks`` of ``shard`` until their copy has run."""
        self.incref(blocks, shard)
        self._migrating += len(blocks)

    def end_migration(self, blocks: Sequence[int], shard: int = 0) -> None:
        """Drop the pins of ``begin_migration`` (the copy ran, or was
        dropped with its handoff)."""
        self._migrating -= len(blocks)
        self.free(blocks, shard)

    # -- alloc / free -----------------------------------------------------
    def alloc(self, n: int, shard: int = 0):
        """n fresh blocks of ``shard`` (refcount 1), or None -- never a
        partial grant."""
        if n > len(self._free[shard]):
            return None
        out = [self._free[shard].popleft() for _ in range(n)]
        for b in out:
            self._ref[shard][b] = 1
        return out

    def incref(self, blocks: Sequence[int], shard: int = 0) -> None:
        for b in blocks:
            self._ref[shard][b] += 1

    def free(self, blocks: Sequence[int], shard: int = 0) -> None:
        """Drop one reference per block; at refcount 0 the block returns to
        the free list and its prefix entry is evicted."""
        for b in blocks:
            c = self._ref[shard][b] - 1
            if c:
                self._ref[shard][b] = c
                continue
            del self._ref[shard][b]
            h = self._prefix_of.pop((shard, b), None)
            if h is not None:
                self._prefix.pop((shard, h), None)
            self._free[shard].append(b)

    # -- prefix cache -----------------------------------------------------
    @staticmethod
    def _chain(tokens, block_size: int):
        """-> (chain hash, this block's exact tokens) per full block."""
        h = 0
        for i in range(len(tokens) // block_size):
            blk = tuple(int(t) for t in tokens[i * block_size:(i + 1) * block_size])
            h = hash((h, blk))
            yield h, blk

    def match_prefix(self, tokens, shard: int = 0) -> Tuple[List[int], int]:
        """Longest chain of ``shard``'s resident full blocks covering a
        prefix of ``tokens`` -> (block ids, tokens covered).  Does not
        incref."""
        blocks: List[int] = []
        for h, blk in self._chain(tokens, self.block_size):
            hit = self._prefix.get((shard, h))
            if hit is None or hit[1] != blk:
                break
            blocks.append(hit[0])
        return blocks, len(blocks) * self.block_size

    def register_prefix(self, tokens, blocks: Sequence[int], shard: int = 0) -> None:
        """Publish ``blocks`` (the prompt's full blocks) of ``shard`` under
        the token chain; existing entries win (they hold the same K/V)."""
        for (h, blk), b in zip(self._chain(tokens, self.block_size), blocks):
            if (shard, h) in self._prefix:
                continue
            self._prefix[(shard, h)] = (b, blk)
            self._prefix_of[(shard, b)] = h
