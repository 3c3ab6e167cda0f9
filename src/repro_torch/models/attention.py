"""Dense GQA/MHA attention with RoPE and optional QKV bias, full causal
(``attn``) or over a sliding window (``local_attn``): the subset of
``repro.models.attention.gqa_forward`` that the port serves, over its three
KV layouts (see ``model.init_caches``):

* wave cache: ``k``/``v`` (L, b, hkv, S, hd) and one position row ``pos``
  (S,), since in wave serving every row sits at the same position;
* slot cache (continuous batching): the same K/V and ``pos`` (b, S), each
  row an independent slot at its own position; a chunk (chunked admission,
  the spec-decode verify step) writes at each row's own offset and attends
  the row's stripe of the cache;
* paged cache: ``k``/``v`` block pools (L, n_blocks, hkv, bs, hd) read and
  written through a per-slot block table (b, nbps), ``pos`` (b, nbps*bs)
  over each slot's view (view index == absolute position).

With a sliding window the wave and slot caches are rings of
``cache_len_for`` entries: position p lives at index p % S, and decode masks
the entries more than ``window`` behind the query.  A chunk into a slot
ring (chunked admission, a verify step) cannot attend the ring after its
write, since writing position p clobbers the entry for p - S that the
chunk's earlier queries still read: it attends the rows' pre-write ring,
by its position stripe, beside the fresh chunk, in plain PyTorch
(``chunked_causal_attention``, the reference's jnp function of that name),
and then scatters the chunk's real tokens to p % S.

With ``ParallelConfig.kv_quant`` every layout stores K/V as int8 with a
bf16 scale per (row, KV head, entry), ``k_scale``/``v_scale`` beside
``k``/``v`` (the JAX package's int8 cache): fresh K/V are quantized and
written by one kv_quant_write launch a layer, decode reads the int8 cache
through the decode kernels' int8 path, and a prefill attends the
dequantized values, as the reference does.

Under tensor parallelism each rank holds ``ShardPlan.local_q`` query heads
and ``local_kv`` KV heads (its projection columns; a KV head replicated
over ``kv_rep`` ranks is sliced to the rank's columns at load, where the
JAX package slices it each forward in ``_slice_kv_weight``), caches those
KV heads in every layout, and returns the unreduced row-parallel partial
of the out-projection: the layer reduces it (``core/sync_policy.py``).
The head counts are read from the projections' widths.

With ``ParallelConfig.kv_seq_shard`` (the long-context wave path) each of
the ``dp`` data ranks holds one slice of the wave cache's sequence:
``cache_len_for`` divides it, a prefill writes the rank's slice of the
prompt's K/V (every rank attends the whole prompt), a decode step writes
its token only on the rank that owns the position, and every rank runs the
decode kernel over its slice; the kernel's unnormalized ``(m, l, acc)``
then merge across the ranks by log-sum-exp (``lse_merge``: an all-reduce
max and an all-reduce sum over the data axis, tag ``lse_merge``), as the
JAX package's ``decode_attention_shardable`` does.  Slots and chunks
refuse it, as there.

``pos`` is shared by all layers, as every layer holds the same positions.
What a forward does with the cache -- where it writes, which mask decode
reads -- is worked out once per forward into a ``KVStep`` (as the RoPE
tables are), and each layer only applies it.  Writes are in place, which
is what buffer donation gives the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as cc
from repro_torch.core import wquant
from repro_torch.core.zero_copy import fused_out_projection
from repro_torch.kernels import ops
# the int8 cache's plain quantizer and dequantizer live beside the kernels'
# plain versions, which use them; this module is where the model reads them
from repro_torch.kernels.ref import dequantize_kv, paged_view, quantize_kv
from repro_torch.models.common import Dist, apply_rope, online_softmax_step

VERIFY_WIDTH = 8    # chunks of at most this many queries attend through flash_verify
KV_CHUNK = 1024     # the reference's flash-style KV chunk of its jnp attention


@dataclass
class KVStep:
    """One forward's use of the KV cache, read by every layer.

    ``cache`` None attends the fresh K/V only.  ``wave_pos`` (wave cache):
    K/V land at view [wave_pos, wave_pos + s) of every row.  ``targets``
    (slot and paged caches): one (dim-0, dim-2) index pair per written
    token, in (row, position) order -- (slot, view index) for the slot
    cache, (pool block, offset in block) for the paged one -- taken by the
    flat (row, position) tokens ``src`` (None: every token, in order).
    ``ring_idx`` (wave ring, a prompt longer than the ring): the last
    ``len(ring_idx)`` tokens land at these indices (position % S) instead.
    ``quant_dst`` (an int8 cache): the same writes as one (dim-0, dim-2)
    pair per flat token, dim-0 -1 where a token is not written
    (``quant_targets``), which kv_quant_write takes.
    ``state_rows``: the cache rows of recurrent state this forward
    continues from and writes (None: every row, in order).
    Decode reads the cache entries ``valid`` marks ((S,) shared or (b, S)
    per slot); prefill attends by view position ``q_pos`` (b, s), over the
    fresh K/V, or with ``paged_read`` over the slot's view through ``bt``,
    or with ``rows`` (b,) int32 over those slots' stripes of the slot
    cache.  ``lse`` (a sequence-sharded wave cache): decode merges its
    partials over that rank's data axis (``lse_merge``).

    ``train`` (the training forward, no cache): every mixer takes its
    plain differentiable branch (``prefill_attention``, the RG-LRU's
    associative scan, the unfused parallel residual) and reaches no kernel
    but ``topk`` on the detached router probabilities; each MoE layer
    appends its load-balance loss to ``aux``."""

    cache: Optional[Dict[str, Any]]
    decode: bool
    q_pos: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    wave_pos: Optional[int] = None
    ring_idx: Optional[torch.Tensor] = None
    state_rows: Optional[torch.Tensor] = None
    targets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    src: Optional[torch.Tensor] = None
    bt: Optional[torch.Tensor] = None
    paged_read: bool = False
    rows: Optional[torch.Tensor] = None
    quant_dst: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ring_kv_pos: Optional[torch.Tensor] = None
    lse: Optional[Dist] = None
    train: bool = False
    aux: Optional[list] = None


# ---------------------------------------------------------------------------
# Cache addressing of the slot engine (``_slot_index``, ``_write_pos_batched``,
# ``_paged_decode_targets``, ``_paged_flat_targets`` of the JAX package)
# ---------------------------------------------------------------------------


def cache_len_for(cfg: ModelConfig, kind: str, seq_len: int, ring_slack: int = 0,
                  kv_seq_shard_dp: int = 1) -> int:
    """Cache length of a layer (a rank's): a windowed ``local_attn`` layer
    keeps a ring of ``window + ring_slack`` entries (at most ``seq_len``);
    every other layer all ``seq_len``, or its ceil(seq_len /
    ``kv_seq_shard_dp``) slice where the sequence is sharded over the data
    axis."""
    if cfg.window and kind == "local_attn":
        eff = min(seq_len, cfg.window + ring_slack)
    else:
        eff = seq_len
    if kv_seq_shard_dp > 1 and eff == seq_len:
        eff = -(-seq_len // kv_seq_shard_dp)
    return eff


def lse_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, dist: Dist):
    """Decode partials of one rank's slice of a sequence-sharded cache ->
    the merged (l, acc) of the whole sequence on every data rank (the JAX
    package's ``pmax`` and ``psum(..., tag="lse_merge")``): each rank's
    partials rescaled to the global max, then summed; a rank whose slice
    has no valid entry (m = -inf) adds nothing.  m, l (b, hq, 1), acc (b,
    hq, 1, hd) fp32; l and acc ride in one all-reduce."""
    m_g = cc.data_all_reduce(m.clone(), dist, "max", tag="lse_merge")
    m_gs = torch.where(torch.isfinite(m_g), m_g, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_gs), 0.0)
    packed = torch.cat([(l * corr)[..., None], acc * corr[..., None]], dim=-1)
    packed = cc.data_all_reduce(packed, dist, tag="lse_merge")
    return packed[..., 0], packed[..., 1:]


def _normalized(m, l, acc, step: "KVStep", dtype) -> torch.Tensor:
    """A decode kernel's partials divided out (merged over the data axis
    first where the cache's sequence is sharded)."""
    if step.lse is not None:
        l, acc = lse_merge(m, l, acc, step.lse)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype)


def block_size(caches: Dict[str, Any]) -> int:
    """Tokens per block of a paged cache's pools (K/V or MLA latents)."""
    return (caches["k"] if "k" in caches else caches["ckv"]).shape[3]


def slot_index(pos: torch.Tensor, S: int, ring: bool = False) -> torch.Tensor:
    """(b,) positions -> per-slot write index: position % S on a ring,
    else clamped into [0, S).  Empty or overrun slots are masked (pos -1)
    or already retired, so their clamped write is harmless."""
    p = pos.clamp_min(0)
    return p % S if ring else p.clamp_max(S - 1)


def write_pos_batched(pos_arr: torch.Tensor, pos: torch.Tensor, rows: torch.Tensor,
                      ring: bool = False) -> None:
    """pos_arr (b, S), in place: record the position ``pos[i]`` of row
    ``rows[i]`` at its own index."""
    pos_arr[rows, slot_index(pos, pos_arr.shape[1], ring)] = pos.to(pos_arr.dtype)


def chunk_writes(slots: np.ndarray, starts: np.ndarray, s: int, S: int, device, *,
                 ring: bool = False, lens: Optional[np.ndarray] = None):
    """Host side of a chunk into the dense slot cache: row r of the chunk
    covers view positions [starts[r], starts[r] + s) of slot slots[r] ->
    ((slot, view index) targets, src) for ``KVStep``.  Positions at or past
    the cache end S are dropped, not clamped (``_write_prefill_chunk``'s
    ``mode="drop"``): padding or rejected drafts of a row at the cache's
    end would otherwise race the real write at S - 1.  On a ``ring`` of S
    entries position p goes to index p % S, and the pad columns (from
    ``lens[r]`` on; default none) are dropped instead
    (``_write_prefill_chunk_ring``): every ring index holds a live entry.
    Built from host arrays, so dropping needs no device sync; ``src`` is
    None when nothing is dropped."""
    vpos = (np.asarray(starts, np.int64)[:, None] + np.arange(s)[None, :]).ravel()
    rows = np.repeat(np.asarray(slots, np.int64), s)
    if ring:
        n = np.full(len(slots), s) if lens is None else np.asarray(lens, np.int64)
        keep = (np.arange(s)[None, :] < n[:, None]).ravel()
        vpos = vpos % S
    else:
        keep = vpos < S
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    src = None if keep.all() else dev(np.flatnonzero(keep))
    return (dev(rows[keep]), dev(vpos[keep])), src


def paged_decode_targets(bt: torch.Tensor, pos: torch.Tensor, bs: int):
    """(b,) write positions -> (pool block, offset in block); positions past
    the table (frozen or overrun slots) go to the null block 0."""
    nbps = bt.shape[1]
    p = pos.clamp_min(0).long()
    vi, off = p // bs, p % bs
    rows = torch.arange(bt.shape[0], device=bt.device)
    phys = torch.where(vi < nbps, bt[rows, vi.clamp_max(nbps - 1)].long(), 0)
    return phys, off


def paged_flat_targets(bt: torch.Tensor, starts: torch.Tensor, s: int, bs: int):
    """Flattened (b*s,) pool blocks and offsets of a prefill whose row b
    covers view positions [starts[b], starts[b] + s); positions past the
    table go to the null block 0.  Padding tokens land in the row's private
    tail block or the null block, never in a shared prefix block (shared
    blocks are full and lie before ``starts``)."""
    nbps = bt.shape[1]
    vpos = starts.long()[:, None] + torch.arange(s, device=bt.device)[None, :]
    vi, off = vpos // bs, vpos % bs
    phys = torch.where(vi < nbps, torch.gather(bt.long(), 1, vi.clamp_max(nbps - 1)), 0)
    return phys.reshape(-1), off.reshape(-1)


def write_targets(side: torch.Tensor, new: torch.Tensor,
                  targets: Tuple[torch.Tensor, torch.Tensor],
                  src: Optional[torch.Tensor] = None) -> None:
    """In place: K or V ``new`` (b, h, s, hd) into ``side`` (n, h, m, hd) at
    one (dim-0, dim-2) pair per token -- a slot's row and view index, or a
    pool block and offset -- for the flat (row, position) tokens ``src``
    (default all).  Only the null block can be a target twice; its value is
    never read as valid, so whichever write lands is harmless."""
    b, h, s, hd = new.shape
    flat = new.transpose(1, 2).reshape(b * s, h, hd)
    if src is not None:
        flat = flat[src]
    side[targets[0], :, targets[1]] = flat.to(side.dtype)


def quant_targets(b: int, s: int, device, *, wave_pos: Optional[int] = None,
                  ring_idx: Optional[torch.Tensor] = None,
                  targets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  src: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``KVStep``'s writes as kv_quant_write takes them: (dst_row, dst_idx)
    (b * s,) int32, one destination per flat (row, position) token, dst_row
    -1 for a token not written.  The wave slice from ``wave_pos``, the last
    ``len(ring_idx)`` tokens of each row at ``ring_idx``, or ``targets`` for
    the tokens ``src`` (default all)."""
    if targets is not None:
        if src is None:
            return targets[0].to(torch.int32), targets[1].to(torch.int32)
        row = torch.full((b * s,), -1, dtype=torch.int32, device=device)
        idx = torch.zeros((b * s,), dtype=torch.int32, device=device)
        row[src], idx[src] = targets[0].to(torch.int32), targets[1].to(torch.int32)
        return row, idx
    rows = torch.arange(b, dtype=torch.int32, device=device).repeat_interleave(s)
    pos = torch.arange(s, dtype=torch.int32, device=device)
    if ring_idx is None:
        return rows, (pos + wave_pos).repeat(b)
    n = ring_idx.numel()
    at = torch.zeros((s,), dtype=torch.int32, device=device)
    at[s - n:] = ring_idx.to(torch.int32)
    return torch.where((pos >= s - n).repeat(b), rows, -1), at.repeat(b)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def gqa_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                rope: Tuple[torch.Tensor, torch.Tensor], step: KVStep,
                layer: int = 0, window: int = 0) -> torch.Tensor:
    """x (b, s, d) -> attention output (b, s, d) after the out-projection
    (``gqa_heads``, then ``fused_out_projection``): at tp > 1 this rank's
    unreduced partial."""
    return fused_out_projection(
        gqa_heads(p, x, cfg, rope=rope, step=step, layer=layer, window=window), p["w_o"])


def gqa_heads(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
              rope: Tuple[torch.Tensor, torch.Tensor], step: KVStep,
              layer: int = 0, window: int = 0) -> torch.Tensor:
    """x (b, s, d) -> the attention heads (b, hq, s, hd) that the
    out-projection ``w_o`` (hq, hd, d) contracts; hq and the KV heads hkv
    are this rank's (the widths of ``w_q`` and ``w_k``).  ``rope`` holds the (cos,
    sin) tables of this forward's positions;
    ``layer`` is the layer's index among the attention layers, which own
    the cache's K/V; ``window`` > 0 is a ``local_attn`` layer's window
    (decode reads it from ``step.valid``).

    Prefill writes the fresh K/V where ``step`` says and attends by view
    position through the flash-prefill kernel: over the fresh K/V, or over
    the slot's paged view (cached-prefix admission, every chunk) through the
    paged one, or over the slots' stripes of the dense slot cache (a chunk),
    through flash_verify when the chunk is at most ``VERIFY_WIDTH`` wide.
    A chunk into a slot ring attends the rows' pre-write ring beside the
    fresh chunk and writes after (``_attend_ring_chunk``).  Decode (s == 1)
    writes its token and attends the valid cache entries through the
    decode kernel, or the paged decode kernel."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = wquant.out_cols(p["w_q"]) // hd, wquant.out_cols(p["w_k"]) // hd
    scale = 1.0 / math.sqrt(hd)

    q = wquant.matmul(x, p["w_q"])
    k = wquant.matmul(x, p["w_k"])
    v = wquant.matmul(x, p["w_v"])
    if "b_q" in p:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    q = apply_rope(q.view(b, s, hq, hd).transpose(1, 2), *rope)
    k = apply_rope(k.view(b, s, hkv, hd).transpose(1, 2), *rope)
    v = v.view(b, s, hkv, hd).transpose(1, 2)

    c = step.cache
    if step.train:
        return prefill_attention(q, k, v, step.q_pos[0], window, scale)
    if step.ring_kv_pos is not None:
        return _attend_ring_chunk(q, k, v, c, step, layer, scale, window)
    if c is not None and "k_scale" in c:
        return _attend_int8(q, k, v, c, step, layer, scale, window)
    if c is not None:
        ck, cv = c["k"][layer], c["v"][layer]
        if step.targets is not None:
            write_targets(ck, k, step.targets, step.src)
            write_targets(cv, v, step.targets, step.src)
        elif step.ring_idx is not None:       # keep the last S tokens, at p % S
            n = step.ring_idx.numel()
            ck[:, :, step.ring_idx] = k[:, :, s - n:]
            cv[:, :, step.ring_idx] = v[:, :, s - n:]
        else:
            ck[:, :, step.wave_pos:step.wave_pos + s] = k
            cv[:, :, step.wave_pos:step.wave_pos + s] = v
    q = q.contiguous()
    if step.decode:
        # the partials divided out (decode_attention_shardable, no seq sharding)
        if step.bt is not None:
            m, l, acc = ops.paged_decode_attention_partial(q, ck, cv, step.bt, step.valid, scale)
        else:
            m, l, acc = ops.decode_attention_partial(q, ck, cv, step.valid, scale)
        out = _normalized(m, l, acc, step, q.dtype)
    elif step.paged_read:
        out = ops.paged_flash_prefill(q, ck, cv, step.bt, step.q_pos, scale)
    elif step.rows is not None:
        attend = ops.flash_verify if s <= VERIFY_WIDTH else ops.flash_prefill
        out = attend(q, ck, cv, step.q_pos, scale, rows=step.rows)
    else:
        out = ops.flash_prefill(q, k.contiguous(), v.contiguous(), step.q_pos, scale,
                                window=window)
    return out


def _attend_int8(q, k, v, c, step: KVStep, layer: int, scale: float, window: int):
    """``gqa_heads``' cache write and attention over an int8 cache (the JAX
    package's ``quant`` branches): the fresh K/V quantized and written by
    one kv_quant_write launch; decode reads the int8 cache through the
    decode kernels' int8 path; a chunk attends its rows' stripes dequantized
    by the plain ``dequantize_kv`` (flash_verify up to ``VERIFY_WIDTH``
    wide, flash_prefill above, as the JAX package does), or its slots'
    paged views gathered and dequantized (flash_prefill at every width,
    where the JAX package attends them in jnp); a whole prompt attends the
    dequantized fresh K/V (``_dequantize_kv(kq, ksc)``)."""
    ck, cv, cks, cvs = c["k"][layer], c["v"][layer], c["k_scale"][layer], c["v_scale"][layer]
    fresh = not step.decode and not step.paged_read and step.rows is None
    kd = ops.kv_quant_write(k, v, ck, cv, cks, cvs, *step.quant_dst, dequantized=fresh)
    q = q.contiguous()
    if step.decode:
        if step.bt is not None:
            m, l, acc = ops.paged_decode_attention_partial(q, ck, cv, step.bt, step.valid, scale,
                                                           k_scale=cks, v_scale=cvs)
        else:
            m, l, acc = ops.decode_attention_partial(q, ck, cv, step.valid, scale,
                                                     k_scale=cks, v_scale=cvs)
        return _normalized(m, l, acc, step, q.dtype)
    if fresh:
        return ops.flash_prefill(q, kd[0], kd[1], step.q_pos, scale, window=window)
    if step.paged_read:
        # the scales gathered as a pool of head_dim 1
        view = lambda pool, sc: dequantize_kv(paged_view(pool, step.bt),
                                              paged_view(sc[..., None], step.bt)[..., 0])
        return ops.flash_prefill(q, view(ck, cks), view(cv, cvs), step.q_pos, scale)
    rows = step.rows.long()
    k_att, v_att = dequantize_kv(ck[rows], cks[rows]), dequantize_kv(cv[rows], cvs[rows])
    attend = ops.flash_verify if q.shape[2] <= VERIFY_WIDTH else ops.flash_prefill
    return attend(q, k_att, v_att, step.q_pos, scale)


def _attend_ring_chunk(q, k, v, c, step: KVStep, layer: int, scale: float, window: int):
    """``gqa_heads``' chunk into a slot ring (the JAX package's ring branch,
    ``attention.py:949-992`` there): the rows' ring as it stood before the
    chunk (gathered, so a copy), concatenated with the fresh K/V and masked
    by ``step.ring_kv_pos`` and the window, then the chunk's real tokens
    written at p % S (a step with no ``targets`` writes nothing: the rows
    of a ``moe.RowLayout``).  Over an int8 ring the old entries and the
    fresh K/V attend dequantized, and one kv_quant_write launch writes the
    int8 values and scales."""
    rows = step.rows.long()
    ck, cv = c["k"][layer], c["v"][layer]
    write = step.targets is not None
    if "k_scale" in c:
        cks, cvs = c["k_scale"][layer], c["v_scale"][layer]
        k_old, v_old = dequantize_kv(ck[rows], cks[rows]), dequantize_kv(cv[rows], cvs[rows])
        if write:
            k, v = ops.kv_quant_write(k, v, ck, cv, cks, cvs, *step.quant_dst, dequantized=True)
        else:
            k, v = dequantize_kv(*quantize_kv(k)), dequantize_kv(*quantize_kv(v))
        return chunked_causal_attention(q, torch.cat([k_old, k], 2),
                                        torch.cat([v_old, v], 2), step.q_pos,
                                        step.ring_kv_pos, window, scale)
    out = chunked_causal_attention(q, torch.cat([ck[rows], k.to(ck.dtype)], 2),
                                   torch.cat([cv[rows], v.to(cv.dtype)], 2), step.q_pos,
                                   step.ring_kv_pos, window, scale)
    if write:
        write_targets(ck, k, step.targets, step.src)
        write_targets(cv, v, step.targets, step.src)
    return out


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
                             scale: float) -> torch.Tensor:
    """The reference's jnp ``chunked_causal_attention``: q (b, hq, sq, hd)
    over k, v (b, hkv, sk, hd) (GQA groups), q_pos (sq,) or (b, sq), kv_pos
    (sk,) or (b, sk) (-1 empty); entry j is attended iff 0 <= kv_pos <=
    q_pos and, with ``window``, kv_pos > q_pos - window.  fp32 scores of
    the bf16 operands, an online softmax over KV_CHUNK-entry chunks, the
    probabilities rounded to v's dtype before P.V (``_grouped_attend``) ->
    (b, hq, sq, hd) in q's dtype.  Out-of-place throughout, so autograd
    differentiates it: a chunk into a slot ring attends through it, and so
    does the training forward (``prefill_attention``)."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, hd).float()
    q_pos = q_pos if q_pos.dim() == 2 else q_pos[None]
    kv_pos = kv_pos if kv_pos.dim() == 2 else kv_pos[None]
    qp = q_pos[:, None, None, :, None]
    m = torch.full(qg.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, device=q.device)
    chunk = min(KV_CHUNK, sk)
    for c0 in range(0, sk, chunk):
        k_i, v_i = k[:, :, None, c0:c0 + chunk].float(), v[:, :, None, c0:c0 + chunk]
        p_i = kv_pos[:, None, None, None, c0:c0 + chunk]
        sc = (qg @ k_i.transpose(-1, -2)) * scale                      # (b, hkv, g, sq, t)
        valid = (p_i >= 0) & (p_i <= qp)
        if window:
            valid &= p_i > qp - window
        sc = sc.masked_fill(~valid, float("-inf"))
        m, m_safe, corr = online_softmax_step(sc, m)
        p = torch.exp(sc - m_safe[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(v.dtype).float() @ v_i.float()
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, hq, sq, hd).to(q.dtype)


def banded_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            positions: torch.Tensor, window: int, scale: float,
                            q_chunk: int = 1024) -> torch.Tensor:
    """The reference's sliding-window prefill in O(S * window)
    (``banded_causal_attention``): query chunks of ``q_chunk`` rows, each
    attending only its band of ``window + q_chunk`` keys before it (the K/V
    front-padded with empty positions), in one masked softmax with the
    probabilities rounded to v's dtype before P.V.  positions (S,).  Falls
    back to ``chunked_causal_attention`` where the chunk does not divide S."""
    b, hq, S, hd = q.shape
    cq = min(q_chunk, S)
    if S % cq:
        return chunked_causal_attention(q, k, v, positions, positions, window, scale)
    hkv = k.shape[1]
    band = window + cq
    kp = torch.nn.functional.pad(k, (0, 0, band, 0))
    vp = torch.nn.functional.pad(v, (0, 0, band, 0))
    pp = torch.nn.functional.pad(positions, (band, 0), value=-1)
    outs = []
    for i in range(S // cq):
        start = (i + 1) * cq                              # pad + (i + 1) * cq - band
        q_i = q[:, :, i * cq:(i + 1) * cq].reshape(b, hkv, hq // hkv, cq, hd).float()
        k_i, v_i = kp[:, :, None, start:start + band], vp[:, :, None, start:start + band]
        p_i, qp = pp[start:start + band][None, :], positions[i * cq:(i + 1) * cq][:, None]
        sc = (q_i @ k_i.float().transpose(-1, -2)) * scale          # (b, hkv, g, cq, band)
        ok = (p_i >= 0) & (p_i <= qp) & (p_i > qp - window)
        sc = sc.masked_fill(~ok, float("-inf"))
        mx = sc.amax(dim=-1)
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        p = torch.exp(sc - mx[..., None])
        o = (p.to(v.dtype).float() @ v_i.float()) / torch.clamp(p.sum(-1), min=1e-30)[..., None]
        outs.append(o.reshape(b, hq, cq, hd).to(q.dtype))
    return torch.cat(outs, dim=2)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, window: int, scale: float) -> torch.Tensor:
    """The training forward's attention over its fresh K/V (the reference's
    ``_prefill_attention`` without Pallas, as its training step runs it):
    the banded path for a windowed layer whose sequence is at least 4
    windows long and a multiple of min(1024, S), else the chunked flash
    scan.  Plain PyTorch, differentiable, no kernel: a kernel's output
    carries no gradient (``kernels/ops.py`` refuses a grad-requiring
    input)."""
    S = q.shape[2]
    if window and S >= 4 * window and S % min(1024, S) == 0:
        return banded_causal_attention(q, k, v, positions, window, scale)
    return chunked_causal_attention(q, k, v, positions, positions, window, scale)
