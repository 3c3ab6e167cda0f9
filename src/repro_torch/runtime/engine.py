"""Serving engine: weights and caches on one device, prefill and decode
steps, the wave ``generate`` loop and the slot engine of continuous
batching over a dense or a paged KV cache (``repro.runtime.engine.Engine``).

Under tensor parallelism (``dist``) each rank's engine holds its shard of
the weights and caches its KV heads, and every rank makes the same calls
in the same order: the same scheduler over the same requests, so the token
ids are replicated and need no broadcast (the paper's SPMD form).  The
forwards that the JAX engine runs sequence-sharded (prefill, admission,
chunks, verify) run so here.

Over the data axis (``dist.dp`` replicas, ``launch/mesh.py``) every rank
runs the same scheduler in lockstep too, and a replica computes only its
shard's rows: slots [d * B / dp, (d + 1) * B / dp) of the slot engine and
its pool of n_blocks / dp blocks (``init_slot_caches``,
``init_paged_caches``), a wave's rows split as evenly as they go.  Each
slot call takes the world's B-wide host arrays, runs the rank's rows (none
at all where its shard has no row in the step: its launches are skipped)
and all-gathers its outputs over the data group once a call (tag
``dp_tokens``), so every rank lands the world's tokens; a decode block
gathers when it lands (``land_decode``), so that the next block can be
dispatched on the replica's own device state before it does (a replica's
rows depend on its own rows only), and every rank lands in the same
order, so the gathers pair up.  With
``kv_seq_shard`` the data axis splits the wave cache's sequence instead:
every replica serves the whole batch over its slice, merged by log-sum-exp
in each attention layer (``models/attention.py``).  ``migrate_blocks``
moves KV blocks between the data shards' pools (disaggregated serving).

The decode step is the paper's experiment unit (ms/token of exactly this
function).  The JAX package fuses n decode steps into one ``lax.scan``
program; here the steps are a plain Python loop that keeps the sampled
tokens on the device, so the host waits only once per block (at the end of
``generate``, and in ``land`` for the slot engine).  KV caches are updated
in place instead of donated.

A slot decode block is dispatched and landed apart (``dispatch_decode``,
``land_decode``), as the JAX package's async dispatch allows: the
dispatch queues the block's kernels and a copy of its outputs into pinned
host memory behind a CUDA event, and returns without waiting; the landing
waits on that event.  A dispatch takes the previous block's device outputs
as its inputs, and what it uploads from the host goes through pinned
buffers copied without waiting, so the overlapped scheduler queues block
N+1 before block N lands.  ``dispatch_hook`` runs before every slot step
launches anything: the fault boundary of ``runtime/faults.py``.
"""
from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, SamplingConfig
from repro_torch.core import collectives as cc
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.common import Dist, resolve_device
from repro_torch.models.moe import RowLayout
from repro_torch.runtime import kvcache
from repro_torch.runtime.sampling import sample_tokens
from repro_torch.training import checkpoint


class DecodeBlock(NamedTuple):
    """A dispatched slot decode block (``Engine.dispatch_decode``): the
    device state after its last step, which the next dispatch may take as
    its inputs, and the host copy of its outputs, queued behind ``event``
    (None on the CPU, where the copy is the tensor itself)."""
    tok: torch.Tensor              # (B,) or frames (B, ncb) after the last step
    pos: torch.Tensor              # (B,)
    done: torch.Tensor             # (B,) bool
    remaining: torch.Tensor        # (B,)
    n: int                         # steps in the block
    host: torch.Tensor             # tokens (n * B[* ncb]), pos, done, remaining
    event: Optional[Any]           # torch.cuda.Event recorded after the copy

    @property
    def state(self):
        return self.tok, self.pos, self.done, self.remaining


class Engine:
    """One model on one device.

    ``params`` defaults to random weights drawn on the device from ``seed``
    (``model.init_params``); pass the output of ``repro_torch.bridge`` to
    serve the JAX package's weights.  With ``parallel.weight_quant`` set the
    weights are quantized at load: drawn quantized, or quantized here when
    ``params`` holds bf16 leaves (quantized leaves pass through).  A bf16
    lm_head is kept resident as one fp32 copy, because the logits are
    computed in fp32 and casting the head on every step would allocate and
    write it anew each time; a quantized head is not, since an fp32 copy
    would undo its point; a tied head is the embed table, kept as an fp32
    copy of its transpose; a multi-codebook head is kept whole, (ncb, d,
    V).  ``caps`` is the arch's serving-capability record, which the
    schedulers consult.

    A config with a ``frontend`` puts ``prefix`` projected feature
    positions in front of every prompt: the stub encoder's features are
    zeros unless ``generate`` is given some, as in the JAX engine, and
    every cache extent and position counts the prefix.  A multi-codebook
    model takes and gives (.., ncb) token frames where a single-codebook
    one takes and gives tokens; its EOS reads codebook 0.

    ``wq_cache`` (with ``parallel.weight_quant``): the path of a packed
    weight checkpoint (``training.checkpoint``): restored when it exists,
    else written after the weights are quantized, as the JAX engine's
    ``wq_cache`` does.  ``parallel.kv_quant`` gives every cache this engine
    makes the int8 layout.

    ``dist`` (``launch.mesh.init_tp``) makes this engine one rank of a
    world of ``parallel.dp`` x ``parallel.tp``: ``params`` default to this
    rank's shard of the seed's model (the same in every data replica), and
    given ones must be a shard (``bridge.params_from_jax`` with the same
    ``dist``).  Every rank seeds its sampling generator alike, so
    stochastic draws agree across the ranks too."""

    def __init__(self, cfg: ModelConfig, *, parallel: ParallelConfig = ParallelConfig(),
                 sampling: SamplingConfig = SamplingConfig(), max_len: int = 128,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 device="cuda", wq_cache: Optional[str] = None, dist: Dist = Dist()):
        M.check_supported(cfg, parallel, wq_cache=wq_cache)
        self.ctx = M.ModelCtx.make(cfg, parallel, dist)
        self.dist = dist
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # fp32 products (the lm_head) in full fp32, as the reference does
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.parallel, self.sampling = cfg, parallel, sampling
        self.caps = ArchCapabilities.from_config(cfg)
        # the slot cache's attention layers are a sliding-window ring
        self.ring = M.attention_window(cfg) > 0
        self.max_len = max_len
        wq = parallel.weight_quant != "none" and wq_cache is not None
        loaded = params is None and wq and checkpoint.has_quantized(wq_cache)
        if loaded:
            params = checkpoint.load_quantized(wq_cache, cfg, parallel, device=self.device)
        elif params is None:
            params = M.init_params(cfg, parallel, seed=seed, device=self.device, dist=dist)
        self.params = M.quantize_params(params, parallel)
        if wq and not loaded:
            checkpoint.save_quantized(self.params, cfg, parallel, wq_cache)
        head = self.params.get("lm_head")
        if head is None:                    # tied: the table's transpose
            self.head_f32 = self.params["embed"]["table"][0].float().t()
        elif isinstance(head, QuantWeight):
            self.head_f32 = None
        else:
            self.head_f32 = head[0].float() if cfg.n_codebooks == 1 else head.float()
        self.prefix = cfg.frontend.prefix_len if cfg.frontend is not None else 0
        # the data axis splits the batch (slots, pools, a wave's rows) unless
        # it splits the wave cache's sequence
        self.row_shard = dist.dp > 1 and not parallel.kv_seq_shard
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        # called with no arguments before every slot step (decode, mixed,
        # verify) launches anything: an exception raised here leaves the
        # caches as they were, so the caller may issue the step again.  A
        # scheduler with a fault plan installs it; None costs nothing.
        self.dispatch_hook: Optional[Callable[[], None]] = None

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        """``model.forward`` on this engine's weights and rank (its local
        logits); ``seq_sharded`` where the JAX engine shards the sequence."""
        return M.forward(self.params, tokens, self.cfg, head_f32=self.head_f32, ctx=self.ctx,
                         **kw)

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(b, V or local_vocab) logits -> token ids (b,), or (b, ncb, V) ->
        frames (b, ncb), the same on every rank (``parallel.topk_sync``
        picks the paper's top-k before the gather or the full-row
        gather)."""
        return sample_tokens(logits, self.sampling, self.generator, self.ctx.plan, self.dist,
                             self.parallel.topk_sync)

    def _kv_kw(self) -> dict:
        return dict(kv_quant=self.parallel.kv_quant, kv_heads=self.ctx.plan.local_kv,
                    tp=self.dist.tp)

    def init_caches(self, batch: int) -> Dict[str, torch.Tensor]:
        """A wave cache of ``batch`` rows: under ``kv_seq_shard`` this data
        rank's slice of the sequence."""
        dp = self.dist.dp if self.parallel.kv_seq_shard else 1
        return M.init_caches(self.cfg, batch, self.max_len, device=self.device,
                             kv_seq_shard_dp=dp, **self._kv_kw())

    def zero_features(self, b: int) -> Optional[torch.Tensor]:
        """The stub encoder's output where none is given: zeros (b, prefix,
        feature_dim) fp32, as the JAX engine feeds; None without a
        frontend."""
        f = self.cfg.frontend
        if f is None:
            return None
        return torch.zeros((b, f.prefix_len, f.feature_dim), dtype=torch.float32,
                           device=self.device)

    def prefill(self, tokens: torch.Tensor, caches,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prompt step: writes the cache (``features`` projected in front of
        the tokens, for a config with a frontend), samples from the LAST
        position's logits (a pad position for right-padded short rows, as
        in the JAX package) -> next token ids (b,) or frames (b, ncb)."""
        logits = self.forward(tokens, caches=caches, last_only=True, seq_sharded=True,
                              features=features)
        return self.sample(logits[:, -1])

    def decode(self, tok: torch.Tensor, caches, cur_pos: int) -> torch.Tensor:
        """One decode step for the whole batch at the shared position."""
        logits = self.forward(tok[:, None], caches=caches, cur_pos=cur_pos)
        return self.sample(logits[:, -1])

    def check_replicated(self, done, counters: Optional[Dict] = None) -> None:
        """The end of a run over more than one rank: every rank of the world
        must have served the same streams with the same outcomes (one hash
        of the finished requests' tokens and finish reasons, and of the
        scheduler's control ``counters``, all-gathered over the model
        group, then over the data group, tag ``stream_check``); raises on a
        mismatch: a rank whose control plane parted fails the run."""
        if self.dist.tp == 1 and self.dist.dp == 1:
            return
        h = hashlib.sha256()
        for r in sorted(done, key=lambda r: r.rid):
            h.update(np.int64(r.rid).tobytes() + np.asarray(r.output, np.int64).tobytes()
                     + str(r.finish_reason).encode())
        if counters is not None:
            h.update(json.dumps(counters, sort_keys=True).encode())
        mine = torch.tensor([int.from_bytes(h.digest()[:8], "little", signed=True)],
                            dtype=torch.int64, device=self.device)
        hashes = cc.all_gather(mine, self.dist, 0, tag="stream_check")
        hashes = cc.data_all_gather(hashes, self.dist, tag="stream_check").tolist()
        if len(set(hashes)) != 1:
            raise RuntimeError(f"the ranks served different streams (hashes {hashes})")

    # -- the data axis -------------------------------------------------------

    def _rows(self, B: int) -> slice:
        """This replica's slots of a B-slot engine (B a multiple of dp)."""
        bl = B // self.dist.dp
        return slice(self.dist.data_rank * bl, (self.dist.data_rank + 1) * bl)

    def _gather_rows(self, *arrays):
        """Each replica's host arrays (B_local, ...) -> the world's (B, ...)
        int64, in one all-gather over the data group (tag ``dp_tokens``)."""
        parts = [np.asarray(a).astype(np.int64).reshape(len(a), -1) for a in arrays]
        t = torch.from_numpy(np.concatenate(parts, axis=1))
        if self.dist.backend == "nccl":
            t = t.to(self.device)
        got = cc.data_all_gather(t, self.dist, tag="dp_tokens").cpu().numpy()
        out, c = [], 0
        for a, part in zip(arrays, parts):
            out.append(got[:, c:c + part.shape[1]].reshape(-1, *np.shape(a)[1:]))
            c += part.shape[1]
        return out

    def _check_slots(self, n_slots: int, n_blocks: int = 0) -> None:
        if self.parallel.kv_seq_shard:
            raise ValueError("slot engine is incompatible with kv_seq_shard")
        dp = self.dist.dp
        if n_slots % dp:
            raise ValueError(f"n_slots {n_slots} must divide dp {dp}")
        if n_blocks % dp:
            raise ValueError(f"n_blocks {n_blocks} must divide dp {dp}")

    # -- slot engine (continuous batching) -----------------------------------
    #
    # Every row of a slot cache is an independent slot at its own position.
    # Admission prefills only the admitted slots, in place: the rows it
    # computes are the admitted ones (the JAX package computes the full
    # width and keeps the admitted rows with merge_slots; each row is
    # independent, so the result for an admitted row is the same -- except
    # in an MoE layer past 256 tokens, where the other rows ride along:
    # ``_layout``).  Decode runs all slots; finished and empty slots are
    # masked inside the step.

    def init_slot_caches(self, n_slots: int, *,
                         ring_slack: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """A sliding-window ring holds ``window + ring_slack`` entries
        (default ``parallel.spec_k``; a scheduler passes its own spec_k), so
        that a verify chunk of spec_k drafts never wraps onto live window
        entries (the JAX package's ``ring_slack``)."""
        self._check_slots(n_slots)
        slack = self.parallel.spec_k if ring_slack is None else ring_slack
        return M.init_caches(self.cfg, n_slots // self.dist.dp, self.max_len,
                             device=self.device, per_slot=True, ring_slack=slack,
                             **self._kv_kw())

    def init_paged_caches(self, n_slots: int, n_blocks: int,
                          block_size: int) -> Dict[str, torch.Tensor]:
        """The paged cache of ``n_slots`` slots over a pool of ``n_blocks``:
        at dp > 1 this replica's slots and its shard's pool of n_blocks /
        dp blocks (local block 0 its null block)."""
        self._check_slots(n_slots, n_blocks)
        dp = self.dist.dp
        return M.init_caches(self.cfg, n_slots // dp, self.max_len, device=self.device,
                             paged=(n_blocks // dp, block_size), **self._kv_kw())

    def _layout(self, tokens, rows: np.ndarray):
        """The ``RowLayout`` of a prefill or chunk that computes ``rows`` of
        the (B, s) ``tokens``, where the reference computes all B: needed
        by an MoE model once B * s passes 256 tokens (``moe.capacity``:
        then which assignments drop depends on every row), else None."""
        tokens = np.asarray(tokens)
        B, s = tokens.shape[:2]
        if self.cfg.moe is None or len(rows) == B or B * s <= 256:
            return None
        others = np.setdiff1d(np.arange(B), rows)
        dev = self.device
        return RowLayout(torch.as_tensor(tokens[others], dtype=torch.long, device=dev),
                         kvcache.device_ints(rows, dev), kvcache.device_ints(others, dev))

    def _admit_rows(self, tokens, admit, plens, **kw) -> np.ndarray:
        """Prefill the admitted rows of ``tokens`` (B, Lp[, ncb]) behind the
        zero features' prefix (a config with a frontend) and sample each
        one's first token from its own last real prompt position -> (B,)
        host tokens, or (B, ncb) frames (0 on rows not admitted)."""
        tokens = np.asarray(tokens)
        rows = np.flatnonzero(np.asarray(admit))
        tok = torch.as_tensor(tokens[rows], dtype=torch.long, device=self.device)
        ext = kvcache.device_ints(np.asarray(plens)[rows] + self.prefix, self.device)
        lmask = torch.arange(self.prefix + tok.shape[1], device=self.device)[None, :] < ext[:, None]
        logits = self.forward(tok, last_only=True, length_mask=lmask, seq_sharded=True,
                              layout=self._layout(tokens, rows),
                              features=self.zero_features(len(rows)), **kw)
        out = np.zeros((len(admit), *tokens.shape[2:]), np.int32)
        out[rows] = self.land(self.sample(logits[:, -1]))
        return out

    @torch.inference_mode()
    def prefill_into_slots(self, caches, tokens, admit, plens) -> np.ndarray:
        """Admit requests in flight: prefill ``tokens`` (B, Lp) into the
        slots flagged by ``admit`` (B,) of a live slot cache, right-padded to
        ``plens``; other slots keep their bytes.  The length mask keeps the
        padding out of the RG-LRU state and conv tails.  A frontend's
        prefix stands before every prompt: each slot's cache then holds
        prefix + plen positions.  Returns each admitted slot's first
        sampled token (B,), or frame (B, ncb), on the host."""
        if self.row_shard:
            sl = self._rows(len(admit))
            loc = np.asarray(admit)[sl]
            out = (self._prefill_into_slots(caches, np.asarray(tokens)[sl], loc,
                                            np.asarray(plens)[sl]) if loc.any()
                   else np.zeros((len(loc), *np.shape(tokens)[2:]), np.int32))
            return self._gather_rows(out)[0].astype(np.int32)
        return self._prefill_into_slots(caches, tokens, admit, plens)

    def _prefill_into_slots(self, caches, tokens, admit, plens) -> np.ndarray:
        kvcache.reset_slots(caches, admit)
        slots = kvcache.device_ints(np.flatnonzero(np.asarray(admit)), self.device)
        tok = self._admit_rows(tokens, admit, plens, caches=caches, slots=slots)
        kvcache.mask_prompt_padding(caches, np.asarray(plens) + self.prefix, admit)
        return tok

    @torch.inference_mode()
    def prefill_into_slots_paged(self, caches, tokens, admit, plens, starts, total_lens,
                                 block_tables) -> np.ndarray:
        """Paged admission.  ``tokens`` (B, Lp) hold each row's prompt
        SUFFIX (the whole prompt when nothing is cached), ``starts`` (B,)
        its absolute offset, ``total_lens`` = starts + plens, and
        ``block_tables`` (B, nbps) the slots' tables, of which only the
        admitted rows are read: the other slots' blocks are never written.
        With any cached prefix the suffix attends each slot's view through
        the table (the paged flash-prefill kernel); without one it attends
        its own fresh K/V (the flash-prefill kernel), as in the dense slot
        engine."""
        if self.row_shard:
            sl = self._rows(len(admit))
            loc = np.asarray(admit)[sl]
            out = (self._prefill_into_slots_paged(
                caches, np.asarray(tokens)[sl], loc, np.asarray(plens)[sl],
                np.asarray(starts)[sl], np.asarray(total_lens)[sl],
                np.asarray(block_tables)[sl]) if loc.any() else np.zeros(len(loc), np.int32))
            return self._gather_rows(out)[0].astype(np.int32)
        return self._prefill_into_slots_paged(caches, tokens, admit, plens, starts, total_lens,
                                              block_tables)

    def _prefill_into_slots_paged(self, caches, tokens, admit, plens, starts, total_lens,
                                  block_tables) -> np.ndarray:
        rows = np.flatnonzero(np.asarray(admit))
        start = np.asarray(starts)[rows]
        kvcache.reset_slots(caches, admit, paged=True)
        tok = self._admit_rows(
            tokens, admit, plens, caches=caches, slots=kvcache.device_ints(rows, self.device),
            block_tables=kvcache.device_ints(np.asarray(block_tables)[rows], self.device,
                                             torch.int32),
            start_pos=kvcache.device_ints(start, self.device) if start.any() else None)
        kvcache.set_slot_positions(caches, total_lens, admit)
        return tok

    @staticmethod
    def land(*tensors):
        """Device tensors -> host numpy, waiting for the work that produces
        them: the slot engine's one synchronisation per call."""
        out = [t.cpu().numpy() for t in tensors]
        return out[0] if len(out) == 1 else out

    def _decode_step(self, caches, tok, pos, done, rem, eos, bt, write_rows=None):
        """One masked decode step over all slots, on device tensors: a
        finished row (``done`` or no budget left) keeps its token (frame)
        and position; a frame's EOS reads codebook 0.  Every row writes
        its token at its position unless ``write_rows`` names the rows
        that do.  -> (tok, pos, done, rem)."""
        logits = self.forward(tok[:, None], caches=caches, cur_pos=pos, block_tables=bt,
                              write_rows=write_rows)
        nxt = self.sample(logits[:, -1])
        active = ~done & (rem > 0)
        tok = torch.where(active if tok.dim() == 1 else active[:, None], nxt, tok)
        pos = torch.where(active, pos + 1, pos)
        hit_eos = active & (eos >= 0) & ((tok if tok.dim() == 1 else tok[:, 0]) == eos)
        rem = torch.where(active, rem - 1, rem)
        return tok, pos, done | hit_eos | (rem <= 0), rem

    def _predispatch(self) -> None:
        """The fault boundary (``dispatch_hook``), before a slot step
        launches anything."""
        if self.dispatch_hook is not None:
            self.dispatch_hook()

    def _upload(self, x, dtype=np.int64) -> torch.Tensor:
        """Host ints -> a fresh device tensor of ``dtype``, without waiting:
        on the card through a pinned buffer copied on the stream (a copy
        from pageable memory would wait for every kernel queued before it);
        the caching host allocator keeps the buffer until its copy has
        run.  The caller may change ``x`` at once."""
        a = torch.from_numpy(np.array(x, dtype=dtype))
        if self.device.type != "cuda":
            return a
        return a.pin_memory().to(self.device, non_blocking=True)

    def _slot_state(self, tok, pos, done, remaining, eos, block_tables):
        """Host slot state -> device (tok, pos, done, rem, eos) and the block
        table (None for the dense cache), in one copy each; ``tok`` (B,) or
        frames (B, ncb)."""
        tok = np.asarray(tok)
        state = self._upload(np.concatenate([tok.reshape(-1), pos, done, remaining, eos]))
        tok_d, rest = state[:tok.size].reshape(tok.shape), state[tok.size:]
        pos_d, done_d, rem_d, eos_d = rest.reshape(4, -1)
        bt = None if block_tables is None else self._upload(block_tables, np.int32)
        return (tok_d, pos_d, done_d.bool(), rem_d, eos_d), bt

    @torch.inference_mode()
    def dispatch_decode(self, caches, tok, pos, done, remaining, eos, *, n: int = 1,
                        block_tables=None, active=None) -> DecodeBlock:
        """Queue ``n`` masked decode steps over all slots, as a Python loop
        whose tokens and state stay on the device, and a copy of the block's
        outputs into pinned host memory behind an event; return without
        waiting (``land_decode`` waits).  Finished rows (``done`` or no
        budget left) keep their token and position and rewrite their frozen
        index, row-locally.  ``tok``, ``pos``, ``done`` and ``remaining``
        are host arrays, or the previous block's device state
        (``DecodeBlock.state``); ``eos`` and ``block_tables`` (B, nbps; the
        cache is paged) come from the host, uploaded without waiting.

        At dp > 1 the block runs this replica's rows: host arrays are the
        world's (B rows), device state is the replica's own previous block.
        ``active`` (host, B rows), where given, is a superset of the rows
        still decoding (the scheduler's prediction); a replica none of
        whose rows is in it launches no step (a masked step leaves a frozen
        row as it was) and only copies its state out.  ``land_decode``
        gathers the world's outputs."""
        self._predispatch()
        if self.row_shard:
            return self._dispatch_rows(caches, tok, pos, done, remaining, eos, n, block_tables,
                                       active)
        return self._dispatch_local(caches, tok, pos, done, remaining, eos, n, block_tables)

    def _dispatch_rows(self, caches, tok, pos, done, remaining, eos, n, block_tables, active):
        sl = self._rows(len(eos))
        if not isinstance(tok, torch.Tensor):
            if active is None:
                active = (~np.asarray(done, bool)) & (np.asarray(remaining) > 0)
            tok, pos, done, remaining = (np.asarray(x)[sl] for x in (tok, pos, done, remaining))
        bt = None if block_tables is None else np.asarray(block_tables)[sl]
        return self._dispatch_local(caches, tok, pos, done, remaining, np.asarray(eos)[sl], n,
                                    bt, run=active is None or bool(np.asarray(active)[sl].any()))

    def _dispatch_local(self, caches, tok, pos, done, remaining, eos, n, block_tables,
                        run: bool = True):
        if isinstance(tok, torch.Tensor):
            tok_d, pos_d, done_d, rem_d = tok, pos, done, remaining
            eos_d = self._upload(eos)
            bt = None if block_tables is None else self._upload(block_tables, np.int32)
        else:
            (tok_d, pos_d, done_d, rem_d, eos_d), bt = self._slot_state(
                tok, pos, done, remaining, eos, block_tables)
        toks = [tok_d] * n if not run else []
        for _ in range(n if run else 0):
            tok_d, pos_d, done_d, rem_d = self._decode_step(caches, tok_d, pos_d, done_d,
                                                            rem_d, eos_d, bt)
            toks.append(tok_d)
        out = torch.cat([torch.stack(toks).reshape(-1), pos_d, done_d.long(), rem_d])
        event = None
        if out.is_cuda:
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            out = host
        return DecodeBlock(tok_d, pos_d, done_d, rem_d, n, out, event)

    def land_decode(self, block: DecodeBlock):
        """Wait for a dispatched block's host copy -> host (toks (n, B) or
        frames (n, B, ncb), pos, done, remaining); at dp > 1 the replicas'
        rows gathered over the data group (tag ``dp_tokens``)."""
        if block.event is not None:
            block.event.synchronize()
        out = block.host.numpy()
        k = block.n * block.tok.numel()
        state = out[k:].reshape(3, -1)
        toks = out[:k].reshape(block.n, *block.tok.shape)
        pos, done, remaining = state
        if self.row_shard:
            toks, pos, done, remaining = self._gather_rows(np.moveaxis(toks, 0, 1), pos, done,
                                                           remaining)
            toks = np.moveaxis(toks, 1, 0)
        return (toks.astype(np.int32), pos.astype(np.int32), done.astype(bool),
                remaining.astype(np.int32))

    def decode_slots(self, caches, tok, pos, done, remaining, eos, *, n: int = 1,
                     block_tables=None):
        """``dispatch_decode`` landed at once: host (toks (n, B) or frames
        (n, B, ncb), pos, done, remaining) after ``n`` masked steps."""
        return self.land_decode(self.dispatch_decode(caches, tok, pos, done, remaining, eos,
                                                     n=n, block_tables=block_tables))

    # -- chunked admission and speculative decoding --------------------------
    #
    # A chunk (``start_pos`` per row) writes at each row's own offset and
    # attends the row's cache from position 0: over a dense slot cache the
    # rows' stripes (flash_verify up to VERIFY_WIDTH wide, flash_prefill
    # above), over the paged pool the rows' views through their tables
    # (paged_flash_prefill).  Only the rows that take part are computed, and
    # only their cache entries are written: what the JAX package's
    # merge_slots keeps.

    def _chunk_kw(self, caches, rows: np.ndarray, starts: np.ndarray, width: int,
                  block_tables, lens: Optional[np.ndarray] = None) -> dict:
        """forward() arguments of a chunk over slots ``rows`` starting at
        ``starts`` with ``lens`` real tokens each (host arrays, one entry
        per row; default the whole width)."""
        kw = {"start_pos": kvcache.device_ints(starts, self.device)}
        if block_tables is None:
            kw["slots"] = kvcache.device_ints(rows, self.device)
            kw["chunk_writes"] = attn.chunk_writes(rows, starts, width, caches["pos"].shape[1],
                                                   self.device, ring=self.ring, lens=lens)
        else:
            kw["block_tables"] = kvcache.device_ints(np.asarray(block_tables)[rows],
                                                     self.device, torch.int32)
        return kw

    @torch.inference_mode()
    def mixed_step(self, caches, ctokens, admit, clens, starts, totals, tok, pos, done,
                   remaining, eos, *, block_tables=None):
        """One fused chunked-admission step (``Engine.mixed_step`` and
        ``mixed_step_paged`` of the JAX package).

        The chunk half prefills one chunk of ``ctokens`` (B, C) for every
        slot in ``admit``: row b's ``clens[b]`` real tokens at positions
        ``starts[b]`` onward, after which its position row reads valid over
        [0, ``totals[b]``); each admitted row samples its next token from
        its last real chunk position (the host keeps it only where the
        chunk completed the prompt).  The decode half is one masked decode
        step of every slot, and runs only when some slot is decode-active
        (not done, budget left); admitting slots ride it frozen, and their
        stale decode write is kept out of the cache.  With
        ``block_tables`` (B, nbps) the cache is paged: the chunk writes
        through the admitted rows' tables only, the decode half through
        all of them.  Over a dense slot ring a request's first chunk (at
        offset 0) resets its slot's position row first, since the chunk
        attends the ring's pre-write entries by it.  One host copy at the
        end.  Returns host (ptok (B,), nxt (B,), pos, done, remaining) and
        whether the decode half ran.  At dp > 1 each replica runs its rows'
        halves (a half with no row of its shard is skipped) and the outputs
        are gathered; whether the decode half ran is the world's answer."""
        self._predispatch()
        admit = np.asarray(admit, bool)
        decoded = bool(((~np.asarray(done, bool)) & (np.asarray(remaining) > 0)).any())
        if not self.row_shard:
            return (*self._mixed_local(caches, ctokens, admit, clens, starts, totals, tok, pos,
                                       done, remaining, eos, block_tables), decoded)
        sl = self._rows(len(admit))
        loc = [np.asarray(x)[sl] for x in (ctokens, admit, clens, starts, totals, tok, pos,
                                           done, remaining, eos)]
        bt = None if block_tables is None else np.asarray(block_tables)[sl]
        if loc[1].any() or ((~loc[7].astype(bool)) & (loc[8] > 0)).any():
            out = self._mixed_local(caches, *loc, bt)
        else:
            out = (np.zeros(len(loc[1]), np.int32), *loc[5:9])
        ptok, nxt, pos, done, rem = self._gather_rows(*out)
        return (ptok.astype(np.int32), nxt.astype(np.int32), pos.astype(np.int32),
                done.astype(bool), rem.astype(np.int32), decoded)

    def _chunk_half(self, caches, ctokens, admit, clens, starts, totals,
                    block_tables) -> torch.Tensor:
        """The chunk half of a mixed step, or a chunk-only step: one chunk of
        the rows in ``admit`` (none: nothing runs) -> the device tokens (B,)
        each admitted row sampled after its last real chunk position."""
        admit = np.asarray(admit, bool)
        rows = np.flatnonzero(admit)
        dev = self.device
        ptok = torch.zeros(len(admit), dtype=torch.long, device=dev)
        if not rows.size:
            return ptok
        C = np.asarray(ctokens).shape[1]
        ring = self.ring and block_tables is None
        if ring:
            kvcache.reset_slots(caches, admit & (np.asarray(starts) == 0))
        tok_c = torch.as_tensor(np.asarray(ctokens)[rows], dtype=torch.long, device=dev)
        clens_r = np.asarray(clens)[rows]
        clens_d = kvcache.device_ints(clens_r, dev)
        lmask = torch.arange(C, device=dev)[None, :] < clens_d[:, None]
        logits = self.forward(tok_c, caches=caches, last_only=True, length_mask=lmask,
                              seq_sharded=True, layout=self._layout(ctokens, rows),
                              **self._chunk_kw(caches, rows, np.asarray(starts)[rows], C,
                                               block_tables, clens_r))
        ptok[kvcache.device_ints(rows, dev)] = self.sample(logits[:, -1])
        kvcache.set_slot_positions(caches, totals, admit, ring=ring)
        return ptok

    def _mixed_local(self, caches, ctokens, admit, clens, starts, totals, tok, pos, done,
                     remaining, eos, block_tables):
        admit = np.asarray(admit, bool)
        ptok = self._chunk_half(caches, ctokens, admit, clens, starts, totals, block_tables)
        (tok_d, pos_d, done_d, rem_d, eos_d), bt = self._slot_state(
            tok, pos, done, remaining, eos, block_tables)
        if ((~np.asarray(done, bool)) & (np.asarray(remaining) > 0)).any():
            tok_d, pos_d, done_d, rem_d = self._decode_step(
                caches, tok_d, pos_d, done_d, rem_d, eos_d, bt,
                write_rows=kvcache.device_ints(np.flatnonzero(~admit), self.device))
        out = self.land(torch.stack([ptok, tok_d, pos_d, done_d.long(), rem_d]))
        return (out[0].astype(np.int32), out[1].astype(np.int32), out[2].astype(np.int32),
                out[3].astype(bool), out[4].astype(np.int32))

    @torch.inference_mode()
    def chunk_slots_paged(self, caches, ctokens, admit, clens, starts, totals, *,
                          block_tables):
        """One chunk-only step over the paged pool (the prefill pool's step
        of disaggregated serving, ``chunk_slots_paged`` of the JAX
        package): ``mixed_step`` without its decode half.  The chunk writes
        through the admitted rows' tables only.  -> host ptok (B,); at dp >
        1 a replica with no admitted row launches nothing."""
        self._predispatch()
        admit = np.asarray(admit, bool)
        if self.row_shard:
            sl = self._rows(len(admit))
            loc = [np.asarray(x)[sl] for x in (ctokens, admit, clens, starts, totals,
                                               block_tables)]
            out = (self.land(self._chunk_half(caches, *loc)) if loc[1].any()
                   else np.zeros(len(loc[1]), np.int64))
            return self._gather_rows(out)[0].astype(np.int32)
        return self.land(self._chunk_half(caches, ctokens, admit, clens, starts, totals,
                                          block_tables)).astype(np.int32)

    @torch.inference_mode()
    def migrate_blocks(self, caches, src, dst, land, totals) -> None:
        """Copy pool blocks ``src`` -> ``dst`` (GLOBAL ids, shard *
        blocks_per_shard + local, as the JAX package's ``make_migrate_step``
        takes them), every pool leaf's rows (an int8 cache's scales too),
        then land the slots flagged by ``land`` (B,): their position rows
        read valid over [0, ``totals[b]``).  Every other row keeps its
        bytes.  A copy within one shard is a local copy; across shards the
        source replica sends the blocks, packed into one buffer a (source,
        destination) pair, to the destination replica (``data_send``, tag
        ``migrate``, this model rank's heads), every rank walking the pairs
        in the same order."""
        keys = [k for k in (*kvcache.POOL_KEYS, *kvcache.SCALE_KEYS) if k in caches]
        per = caches[keys[0]].shape[1]
        d = self.dist.data_rank
        pairs: Dict[tuple, list] = {}
        for a, b in zip(src, dst):
            pairs.setdefault((int(a) // per, int(b) // per), []).append((int(a) % per,
                                                                         int(b) % per))
        for (ss, ds), lst in sorted(pairs.items()):
            if d not in (ss, ds):
                continue
            si, di = (kvcache.device_ints([p[i] for p in lst], self.device) for i in (0, 1))
            if ss == ds:
                for k in keys:
                    caches[k][:, di] = caches[k][:, si]
            elif ss == d:
                cc.data_send(torch.cat([caches[k][:, si].contiguous().view(torch.uint8)
                                        .reshape(-1) for k in keys]), self.dist, ds,
                             tag="migrate")
            else:
                shapes = [(caches[k].shape[0], len(lst), *caches[k].shape[2:]) for k in keys]
                sizes = [math.prod(sh) * caches[k].element_size() for k, sh in zip(keys, shapes)]
                got = cc.data_recv((sum(sizes),), torch.uint8, self.device, self.dist, ss)
                for k, sh, part in zip(keys, shapes, torch.split(got, sizes)):
                    caches[k][:, di] = part.view(caches[k].dtype).reshape(sh)
        land = np.asarray(land, bool)
        totals = np.asarray(totals)
        if self.row_shard:
            sl = self._rows(len(land))
            land, totals = land[sl], totals[sl]
        if land.any():
            kvcache.set_slot_positions(caches, totals, land)

    @torch.inference_mode()
    def verify_slots(self, caches, vtokens, pos, done, remaining, eos, *, block_tables=None):
        """One fused speculative verify step (``Engine.verify_slots`` and
        ``verify_slots_paged`` of the JAX package).

        ``vtokens`` (B, K+1) holds each slot's pending token and K drafts.
        Every active slot (not done, budget left) runs them as a width-(K+1)
        chunk at its frontier ``pos``: all K+1 positions sample a target in
        one forward; draft j+1 is accepted iff it equals target j, and the
        slot emits the accepted run plus the target after it, cut at its
        first EOS and its budget.  Its position row is then rewound to
        exactly the emitted extent.  Frozen slots are neither computed nor
        written.  With ``block_tables`` the cache is paged (the tables of
        the active rows route both the chunk's writes and its reads).  One
        host copy at the end.  Returns host (targets (B, K+1), n_emit (B,),
        nxt (B,), pos, done, remaining).  At dp > 1 each replica verifies
        its active rows and the outputs are gathered."""
        self._predispatch()
        if self.row_shard:
            sl = self._rows(len(pos))
            bt = None if block_tables is None else np.asarray(block_tables)[sl]
            out = self._verify_local(caches, *(np.asarray(x)[sl] for x in (
                vtokens, pos, done, remaining, eos)), bt)
            targets, n_emit, nxt, pos, done, remaining = self._gather_rows(*out)
            return (targets.astype(np.int32), n_emit.astype(np.int32), nxt.astype(np.int32),
                    pos.astype(np.int32), done.astype(bool), remaining.astype(np.int32))
        return self._verify_local(caches, vtokens, pos, done, remaining, eos, block_tables)

    def _verify_local(self, caches, vtokens, pos, done, remaining, eos, block_tables):
        vtokens = np.asarray(vtokens)
        pos, done = np.asarray(pos, np.int32), np.asarray(done, bool)
        remaining, eos = np.asarray(remaining, np.int32), np.asarray(eos, np.int32)
        B, K1 = vtokens.shape
        rows = np.flatnonzero(~done & (remaining > 0))
        targets = np.zeros((B, K1), np.int32)
        n_emit = np.zeros((B,), np.int32)
        nxt = vtokens[:, 0].astype(np.int32)
        if rows.size:
            dev = self.device
            vt = torch.as_tensor(vtokens[rows], dtype=torch.long, device=dev)
            logits = self.forward(vt, caches=caches, seq_sharded=True,
                                  **self._chunk_kw(caches, rows, pos[rows], K1, block_tables))
            tg = self.sample(logits.reshape(len(rows) * K1, -1)).reshape(len(rows), K1)
            pos_r, rem_r, eos_r = kvcache.device_ints(
                np.stack([pos[rows], remaining[rows], eos[rows]]), dev)
            acc = (vt[:, 1:] == tg[:, :-1]).long().cumprod(dim=1).sum(dim=1)
            idx = torch.arange(K1, device=dev)
            is_eos = (eos_r[:, None] >= 0) & (tg == eos_r[:, None])
            j_eos = torch.where(is_eos, idx[None, :], K1).min(dim=1).values
            e = torch.minimum(torch.minimum(acc + 1, j_eos + 1), rem_r)
            kvcache.rewind_slots(caches, kvcache.device_ints(rows, dev), pos_r + e,
                                 ring=self.ring and block_tables is None)
            last = tg.gather(1, (e - 1).clamp(0, K1 - 1)[:, None])[:, 0]
            out = self.land(torch.cat([tg.reshape(-1), e, j_eos, last]))
            c = len(rows)
            targets[rows] = out[:c * K1].reshape(c, K1)
            e_h, j_h = out[c * K1:c * K1 + c], out[c * K1 + c:c * K1 + 2 * c]
            n_emit[rows] = e_h
            nxt[rows] = out[c * K1 + 2 * c:]
            done = done.copy()
            done[rows] |= (j_h < e_h) | (remaining[rows] - e_h <= 0)
            pos = pos + n_emit
            remaining = remaining - n_emit
        return targets, n_emit, nxt, pos, done, remaining

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int,
                 features: Optional[np.ndarray] = None) -> np.ndarray:
        """prompts (b, prompt_len[, ncb]) int -> generated tokens (b,
        max_new[, ncb]) int32.  A config with a frontend projects
        ``features`` (b, prefix, feature_dim), zeros when not given, in
        front of the prompts: decode starts at prompt_len + prefix.  At dp >
        1 this replica serves its share of the rows (ceil(b / dp), the last
        replicas fewer or none) and the outputs are gathered over the data
        group; under ``kv_seq_shard`` every replica serves all of them over
        its slice of the cache."""
        plen = prompts.shape[1]
        if self.prefix + plen + max_new > self.max_len:
            raise ValueError(f"prefix {self.prefix} + prompt_len {plen} + max_new {max_new} "
                             f"exceeds max_len {self.max_len}")
        if not self.row_shard:
            return self._generate(prompts, max_new, features)
        b = len(prompts)
        bl = -(-b // self.dist.dp)
        lo, hi = min(b, self.dist.data_rank * bl), min(b, (self.dist.data_rank + 1) * bl)
        out = np.zeros((bl, max_new, *np.shape(prompts)[2:]), np.int32)
        if hi > lo:
            out[:hi - lo] = self._generate(prompts[lo:hi], max_new,
                                           None if features is None else features[lo:hi])
        return self._gather_rows(out)[0][:b].astype(np.int32)

    def _generate(self, prompts: np.ndarray, max_new: int,
                  features: Optional[np.ndarray] = None) -> np.ndarray:
        b, plen = prompts.shape[:2]
        caches = self.init_caches(b)
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        if features is not None and self.cfg.frontend is not None:
            features = torch.as_tensor(np.asarray(features), dtype=torch.float32,
                                       device=self.device)
        else:
            features = self.zero_features(b)
        tok = self.prefill(tokens, caches, features)
        outs = [tok]
        start = plen + self.prefix
        for cur in range(start, start + max_new - 1):
            tok = self.decode(tok, caches, cur)
            outs.append(tok)
        return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()
