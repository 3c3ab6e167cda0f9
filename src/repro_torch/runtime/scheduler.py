"""Request scheduling over the engine (``repro.runtime.scheduler``):
``Request``, the drain-and-restart ``WaveScheduler``, and continuous
batching over slots with a dense (``ContinuousScheduler``) or a paged
(``PagedContinuousScheduler``) KV cache.

A wave takes up to ``batch_size`` queued requests, right-pads their prompts
to the longest one, runs one prefill and decodes every row to the wave's
largest ``max_new``; each request then keeps its own ``max_new`` tokens, cut
after its EOS.

A multi-codebook arch (musicgen-medium) serves (prompt_len, ncb) prompts
and emits (n, ncb) frames; codebook 0 carries the EOS stream
(``tok_scalar``).  A frontend arch (internvl2-26b, musicgen-medium) puts
its fixed prefix in front of every prompt: every cache extent and position
counts it.

The continuous schedulers run the JAX package's blocking loop: retire
finished slots, admit arrived requests into free slots, then step.  With
``prefill_chunk`` set (the default, 256) every admitted prompt streams
through fused mixed steps, one chunk per step while the other slots
decode one token; with 0 it is admitted whole by one bucketed prefill.
With ``spec_k`` set, a step verifies ``spec_k`` n-gram drafts per active
slot and emits 1..spec_k+1 tokens; otherwise decode runs in fused blocks
of masked steps.  Not ported yet: the overlapped loop, fault plans,
priority classes and reserves, and disaggregated serving.

Under tensor parallelism every rank runs its own scheduler over the same
requests; its decisions depend on the requests and the sampled tokens
only, which are the same on every rank, so the ranks make the same engine
calls.  A run ends by checking that every rank served the same streams
(``Engine.check_replicated``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.runtime import kvcache
from repro_torch.runtime.drafter import NgramDrafter
from repro_torch.runtime.engine import Engine

MIN_BUCKET = 8      # smallest admission width: prompts pad to a power of two >= this


def tok_scalar(tok) -> int:
    """The token id EOS checks read: the token itself, or codebook 0 of a
    multi-codebook frame (the primary stream in every config here)."""
    a = np.asarray(tok)
    return int(a if a.ndim == 0 else a.reshape(-1)[0])


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) or (prompt_len, ncb)
    max_new: int
    eos_id: Optional[int] = None
    arrival_step: int = 0         # virtual-clock arrival (decode steps)
    submitted_at: float = field(default_factory=time.monotonic)
    output: Optional[np.ndarray] = None
    stats: Dict = field(default_factory=dict)
    finish_reason: Optional[str] = None   # "stop" (EOS) | "length" (budget)


class WaveScheduler:
    def __init__(self, engine: Engine, batch_size: int, pad_id: int = 0):
        self.engine = engine
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._next_id = 0

    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None,
               arrival_step: int = 0) -> int:
        """Queue a request; waves ignore ``arrival_step`` (they drain the
        queue in order), which the continuous schedulers read."""
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, np.asarray(prompt), max_new, eos_id, arrival_step))
        return rid

    def run(self) -> List[Request]:
        """Drain the queue; returns completed requests in completion order."""
        while self.queue:
            wave, self.queue = self.queue[:self.batch_size], self.queue[self.batch_size:]
            self._run_wave(wave)
        self.engine.check_replicated(self.done)
        return self.done

    def _run_wave(self, wave: List[Request]) -> None:
        plen = max(len(r.prompt) for r in wave)
        max_new = max(r.max_new for r in wave)
        ncb = self.engine.cfg.n_codebooks
        shape = (len(wave), plen) if ncb == 1 else (len(wave), plen, ncb)
        prompts = np.full(shape, self.pad_id, dtype=np.int32)
        for i, r in enumerate(wave):
            # left-aligned; short prompts are right-padded (positions aligned)
            prompts[i, :len(r.prompt)] = r.prompt
        t0 = time.monotonic()
        out = self.engine.generate(prompts, max_new)       # (b, max_new[, ncb])
        dt = time.monotonic() - t0
        cut = []
        for i, r in enumerate(wave):
            toks = out[i, :r.max_new]
            if r.eos_id is not None:
                hits = np.nonzero((toks if toks.ndim == 1 else toks[:, 0]) == r.eos_id)[0]
                if hits.size:
                    toks = toks[:hits[0] + 1]
            cut.append(toks)
        # throughput from tokens actually delivered (EOS-cut, per-request
        # max_new), not the padded wave the step loop ran
        emitted = sum(len(t) for t in cut)
        for r, toks in zip(wave, cut):
            r.output = toks
            r.finish_reason = ("stop" if r.eos_id is not None and len(toks)
                               and tok_scalar(toks[-1]) == r.eos_id else "length")
            r.stats = {
                "wave_batch": len(wave),
                "queue_s": t0 - r.submitted_at,
                "wave_s": dt,
                "emitted": len(toks),
                "tok_per_s": emitted / dt if dt > 0 else float("inf"),
            }
            self.done.append(r)


def percentile_summary(vals) -> Optional[Dict[str, float]]:
    """mean / p50 / p95 / max of a sample (interpolated percentiles), or
    None for an empty one."""
    v = np.asarray(list(vals), np.float64)
    if v.size == 0:
        return None
    return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)), "max": float(v.max())}


@dataclass
class _Slot:
    req: Optional[Request] = None
    toks: List = field(default_factory=list)
    admitted_step: int = 0
    # chunked admission in progress: absolute offset of the next prefill
    # chunk (None = not chunking)
    chunk_next: Optional[int] = None
    # spec-decode drafting history: prompt + generated tokens, preallocated
    # so that each step appends only what it emitted
    hist: Optional[np.ndarray] = None
    hist_len: int = 0


class ContinuousScheduler:
    """Slot-based continuous batching over ``Engine``'s slot engine.

    The loop per round: retire finished slots, admit arrived requests into
    free slots, then step: a fused mixed step while any slot is mid-prefill
    (chunked admission), else a verify step (``spec_k`` > 0) or a block of
    up to ``block_steps`` masked decode steps.  ``prefill_chunk``,
    ``spec_k`` and ``spec_ngram`` default to the engine's
    ``ParallelConfig``; a chunk of 0 admits whole prompts by one bucketed
    prefill.  An arch whose capability record blocks chunked prefill or
    spec decode (recurrent state) falls back to whole-prompt admission and
    plain decode when the value is the config's default, and raises the
    record's error when it was asked for here.  A sliding-window arch caps
    prompts (and buckets) at its window.  A multi-codebook arch's slots hold
    (ncb,) frames, and a frontend arch's positions start after its prefix
    (the engine's slot prefill projects zero features itself).
    """

    def __init__(self, engine: Engine, n_slots: int, pad_id: int = 0, block_steps: int = 8,
                 *, prefill_chunk: Optional[int] = None, spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None):
        self.engine = engine
        self.B = n_slots
        self.pad_id = pad_id
        self.block_steps = block_steps
        caps = engine.caps
        # a ring keeps only the last window tokens: a bucket padded past the
        # window would push real prompt history out of it
        self.prompt_limit = engine.max_len
        if caps.max_prompt is not None:
            self.prompt_limit = min(self.prompt_limit, caps.max_prompt)
        par = engine.parallel
        chunk = par.prefill_chunk if prefill_chunk is None else prefill_chunk
        if chunk and not caps.supports("chunked"):
            if prefill_chunk is not None:
                caps.require("chunked")
            chunk = 0
        self.chunk = min(int(chunk), self.prompt_limit) if chunk else 0
        sk = par.spec_k if spec_k is None else spec_k
        if sk and not caps.supports("spec"):
            if spec_k is not None:
                caps.require("spec")
            sk = 0
        self.spec_k = max(0, int(sk))
        self.spec_ngram = int(par.spec_ngram if spec_ngram is None else spec_ngram)
        self.drafter = NgramDrafter(self.spec_k, ngram_max=self.spec_ngram) if self.spec_k else None
        self.vocab = engine.cfg.vocab_size
        self.ncb = engine.cfg.n_codebooks
        self._prefix = engine.prefix
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._next_id = 0
        self.caches = None
        self.slots = [_Slot() for _ in range(n_slots)]
        self.step_count = 0               # virtual clock: decode steps so far
        self.tok = np.zeros((n_slots,) if self.ncb == 1 else (n_slots, self.ncb), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.dones = np.ones((n_slots,), bool)
        self.remaining = np.zeros((n_slots,), np.int32)
        self.eos = np.full((n_slots,), -1, np.int32)
        self.stats = {
            "decode_steps": 0, "slot_steps": 0, "active_slot_steps": 0,
            "emitted": 0, "admission_rounds": 0, "in_flight_admissions": 0,
            "prefill_calls": 0, "prefill_tokens": 0, "quarantined": 0,
            "prefill_chunks": 0, "chunked_admissions": 0,
            # mixed steps whose decode half ran (some slot was decode-active)
            "mixed_decode_steps": 0,
        }
        if self.spec_k:
            self.stats.update({"spec_steps": 0, "spec_slot_steps": 0, "spec_proposed": 0,
                               "spec_accepted": 0, "spec_emitted": 0})
        # decode inter-token latency samples (seconds/step, during
        # admission), the most recent window
        self._itl: "deque" = deque(maxlen=65536)
        self._last_step_t: Optional[float] = None
        self._admission_mark = False

    # -- submission -------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None,
               arrival_step: int = 0) -> int:
        prompt = np.asarray(prompt)
        if self._prefix + len(prompt) + max_new > self.engine.max_len:
            raise ValueError(f"request needs {self._prefix + len(prompt)}+{max_new} positions "
                             f"> max_len {self.engine.max_len}")
        if len(prompt) > self.prompt_limit:
            raise ValueError(
                f"prompt len {len(prompt)} exceeds the sliding-window cache "
                f"({self.prompt_limit}); longer-than-window prompts are not "
                f"admissible in-flight yet — use WaveScheduler")
        if len(prompt) < 2:
            raise ValueError("prompts must have >= 2 tokens")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, prompt, max_new, eos_id, arrival_step))
        return rid

    # -- internals --------------------------------------------------------
    def _finish(self, r: Request) -> None:
        """Every retirement ends here; ``finished_step`` stamps it on the
        virtual decode-step clock."""
        r.stats["finished_step"] = self.step_count
        self.done.append(r)

    def _retire(self) -> None:
        now = time.monotonic()
        for i, s in enumerate(self.slots):
            # mid-prefill slots ride with done=True but are not finished
            if s.req is not None and self.dones[i] and s.chunk_next is None:
                r = s.req
                r.output = np.asarray(s.toks, dtype=np.int32)
                if r.finish_reason is None:
                    r.finish_reason = ("stop" if (r.eos_id is not None and s.toks
                                                  and tok_scalar(s.toks[-1]) == r.eos_id)
                                       else "length")
                r.stats.update({"emitted": len(s.toks), "finished_at": now,
                                "decode_steps_held": self.step_count - s.admitted_step})
                self.slots[i] = _Slot()
                self._finish(r)

    def _bucket(self, plen: int) -> int:
        """Pow-2 prompt bucket (at least ``MIN_BUCKET``, at most what the
        cache holds behind a frontend's prefix)."""
        b = MIN_BUCKET
        while b < plen:
            b *= 2
        return min(b, self.prompt_limit - self._prefix)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.req is None]

    def _admissible(self) -> List[Request]:
        """Arrived queue entries, first come first served."""
        return [r for r in self.queue if r.arrival_step <= self.step_count]

    def _in_flight(self) -> bool:
        return any(s.req is not None and (not self.dones[i] or s.chunk_next is not None)
                   for i, s in enumerate(self.slots))

    def _assign(self, pairs) -> None:
        """Dequeue the chosen requests and seat them in their slots."""
        now = time.monotonic()
        for slot, r in pairs:
            self.queue.remove(r)
            self.slots[slot] = _Slot(req=r, admitted_step=self.step_count)
            r.stats["queue_s"] = now - r.submitted_at
            r.stats["admitted_step"] = self.step_count

    def _admit(self) -> int:
        free = self._free_slots()
        arrived = self._admissible()
        if not free or not arrived:
            return 0
        pairs = list(zip(free, arrived))
        in_flight = self._in_flight()
        self._assign(pairs)
        self.stats["admission_rounds"] += 1
        if in_flight:
            self.stats["in_flight_admissions"] += len(pairs)
        if self.chunk:
            self._start_chunks(pairs, {r.rid: 0 for _, r in pairs})
        else:
            self._prefill_short(pairs)
        return len(pairs)

    def _start_chunks(self, pairs, starts_of) -> None:
        """Chunked admission: every prompt streams through the mixed step
        from ``starts_of[rid]`` (past a cached prefix), long ones chunk by
        chunk; the slot rides the decode half frozen until its last chunk."""
        for slot, r in pairs:
            self.slots[slot].chunk_next = starts_of[r.rid]
            self.dones[slot] = True
            self.remaining[slot] = 0
            if len(r.prompt) - starts_of[r.rid] > self.chunk:
                self.stats["chunked_admissions"] += 1

    def _prefill_short(self, pairs) -> None:
        """Whole-prompt admission: one bucketed prefill of every admitted
        prompt, right-padded."""
        Lp = self._bucket(max(len(r.prompt) for _, r in pairs))
        shape = (self.B, Lp) if self.ncb == 1 else (self.B, Lp, self.ncb)
        tokens = np.full(shape, self.pad_id, np.int32)
        admit = np.zeros((self.B,), bool)
        plens = np.ones((self.B,), np.int32)
        for slot, r in pairs:
            tokens[slot, :len(r.prompt)] = r.prompt
            admit[slot] = True
            plens[slot] = len(r.prompt)
        new_tok = self.engine.prefill_into_slots(self.caches, tokens, admit, plens)
        self.stats["prefill_tokens"] += int(plens[admit].sum())
        self.stats["prefill_calls"] += 1
        self._admission_mark = True
        self._finish_admission(pairs, admit, new_tok)

    def _finish_admission(self, pairs, admit, new_tok) -> None:
        """Record each admitted request's first token (frame) and arm its
        decode state: its position follows the prefix and the prompt."""
        self.tok = np.where(admit if self.ncb == 1 else admit[:, None], new_tok, self.tok)
        for slot, r in pairs:
            t = tok_scalar(new_tok[slot])
            self.slots[slot].toks.append(t if self.ncb == 1 else new_tok[slot].copy())
            self.pos[slot] = len(r.prompt) + self._prefix
            self.remaining[slot] = r.max_new - 1
            self.eos[slot] = -1 if r.eos_id is None else r.eos_id
            self.dones[slot] = r.max_new <= 1 or (r.eos_id is not None and t == r.eos_id)
            r.stats["ttft_s"] = time.monotonic() - r.submitted_at
            self.stats["emitted"] += 1

    def _run_decode(self, n: int):
        """Engine call for one block (the paged backend adds its tables)."""
        return self.engine.decode_slots(self.caches, self.tok, self.pos, self.dones,
                                        self.remaining, self.eos, n=n)

    def _ensure_capacity(self, n: int) -> None:
        """Pre-decode capacity hook (paged backend: block allocation)."""

    def _decode_block(self, n: int) -> None:
        self._ensure_capacity(n)
        self._apply_decode(*self._run_decode(n), n)

    def _apply_decode(self, toks, pos, done, remaining, n: int) -> None:
        """Host bookkeeping for ``n`` decode steps (toks (n, B) or frames
        (n, B, ncb)): replay the device's masking rule to tell real
        emissions from frozen-slot repeats; the final state is the
        device's."""
        cur_done = self.dones.copy()
        cur_rem = self.remaining.copy()
        emitted = 0
        for s in range(n):
            for i, slot in enumerate(self.slots):
                if slot.req is None or cur_done[i] or cur_rem[i] <= 0:
                    continue
                t = tok_scalar(toks[s, i])
                slot.toks.append(t if self.ncb == 1 else toks[s, i].copy())
                cur_rem[i] -= 1
                if cur_rem[i] == 0 or (self.eos[i] >= 0 and t == self.eos[i]):
                    cur_done[i] = True
                self.stats["emitted"] += 1
                self.stats["active_slot_steps"] += 1
                emitted += 1
        self.tok = toks[-1].copy()
        self.pos = np.array(pos)
        self.dones = np.array(done)
        self.remaining = np.array(remaining)
        self.step_count += n
        self.stats["decode_steps"] += n
        self.stats["slot_steps"] += n * self.B
        self._note_itl(n, emitted)

    def _note_itl(self, n: int, emissions: int = 0, tokens_per_slot=None) -> None:
        """One inter-token latency sample per emitted token: the block's
        per-step share of the time since the last stamp, tagged when the
        interval absorbed admission work (a prefill or a chunk).  A verify
        step's slot that emitted e tokens in a T-second step gives e samples
        of T / e (``tokens_per_slot``)."""
        now = time.monotonic()
        if self._last_step_t is not None:
            dt = (now - self._last_step_t) / n
            if tokens_per_slot is None:
                self._itl.extend([(dt, self._admission_mark)] * emissions)
            else:
                for e in tokens_per_slot:
                    self._itl.extend([(dt / e, self._admission_mark)] * e)
        self._last_step_t = now
        self._admission_mark = False

    def _abort_slot(self, i: int, error: str) -> None:
        """Retire slot ``i``'s request now with finish_reason "error",
        releasing what it holds; no other slot's stream is touched."""
        s = self.slots[i]
        r = s.req
        self._release_slot(i)
        r.output = np.asarray(s.toks, dtype=np.int32)
        r.finish_reason = "error"
        r.stats.update({"error": error, "emitted": len(s.toks), "finished_at": time.monotonic(),
                        "decode_steps_held": self.step_count - s.admitted_step})
        self.slots[i] = _Slot()
        self.tok[i] = 0
        self.dones[i] = True
        self.remaining[i] = 0
        self.stats["quarantined"] += 1
        self._finish(r)

    def _release_slot(self, i: int) -> None:
        """Storage release for slot ``i`` (paged: blocks and refcounts); the
        dense cache owns nothing per slot."""

    # -- speculative decoding (fused multi-token verify steps) ---------------
    def _active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.req is not None and not self.dones[i] and self.remaining[i] > 0]

    def _slot_history(self, i: int) -> np.ndarray:
        """Slot i's prompt + generated tokens for the drafter, kept up to
        date incrementally."""
        s = self.slots[i]
        plen = len(s.req.prompt)
        if s.hist is None:
            s.hist = np.empty(plen + s.req.max_new + 1, np.int32)
            s.hist[:plen] = np.asarray(s.req.prompt, np.int32).ravel()
            s.hist_len = plen
        total = plen + len(s.toks)
        if s.hist_len < total:
            s.hist[s.hist_len:total] = s.toks[s.hist_len - plen:]
            s.hist_len = total
        return s.hist[:s.hist_len]

    def _ensure_spec_capacity(self) -> None:
        """Pre-verify capacity hook (paged: blocks for spec_k + 1 writes)."""

    def _run_verify(self, vtok):
        return self.engine.verify_slots(self.caches, vtok, self.pos, self.dones,
                                        self.remaining, self.eos)

    def _post_verify(self, active: List[int]) -> None:
        """Post-verify hook (paged: free the blocks past the rewound
        frontier)."""

    def _spec_step(self) -> None:
        """Draft spec_k tokens per active slot from its own history, verify
        them all plus one more position in one step, emit each slot's
        accepted run (1..spec_k+1 tokens).  Verify steps are not fused into
        blocks: each step's drafts need the previous step's tokens."""
        K = self.spec_k
        self._ensure_spec_capacity()       # may preempt: collect slots after
        active = self._active_slots()
        if not active:
            return
        vtok = np.zeros((self.B, K + 1), np.int32)
        vtok[:, 0] = self.tok
        vtok[active, 1:] = self.drafter.propose_many([self._slot_history(i) for i in active])
        targets, n_emit, nxt, pos, done, remaining = self._run_verify(vtok)
        counts = []
        for i in active:
            e = int(n_emit[i])
            self.slots[i].toks.extend(int(t) for t in targets[i, :e])
            counts.append(e)
            # accepted drafts: the leading run the model verified, whatever
            # an EOS or the budget cut from the emitted run
            acc = int(np.cumprod(vtok[i, 1:] == targets[i, :-1]).sum())
            self.stats["emitted"] += e
            self.stats["active_slot_steps"] += 1
            self.stats["spec_slot_steps"] += 1
            self.stats["spec_emitted"] += e
            self.stats["spec_accepted"] += acc
        self.tok = np.array(nxt)
        self.pos = np.array(pos)
        self.dones = np.array(done)
        self.remaining = np.array(remaining)
        self.step_count += 1
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += self.B
        self.stats["spec_steps"] += 1
        self.stats["spec_proposed"] += K * len(active)
        self._note_itl(1, tokens_per_slot=counts)
        self._post_verify(active)

    # -- chunked admission (fused mixed prefill/decode steps) -----------------
    def _prefilling(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.req is not None and s.chunk_next is not None]

    def _pre_mixed(self) -> None:
        """Pre-step capacity hook (paged: the decode half's blocks)."""

    def _run_mixed(self, tokens, admit, clens, starts, totals):
        return self.engine.mixed_step(self.caches, tokens, admit, clens, starts, totals,
                                      self.tok, self.pos, self.dones, self.remaining, self.eos)

    def _post_chunks(self, slots_p: List[int]) -> None:
        """Hook after each chunk lands (paged: publish completed prefix
        blocks)."""

    def _mixed_step(self) -> None:
        """One fused step: every mid-prefill slot advances one chunk while
        every decode-active slot decodes one token, so a long prompt stalls
        decode by at most one chunk's compute per token."""
        C = self.chunk
        self._pre_mixed()                  # may preempt: assemble after
        slots_p = self._prefilling()
        if not slots_p:
            return
        tokens = np.full((self.B, C), self.pad_id, np.int32)
        admit = np.zeros((self.B,), bool)
        clens = np.ones((self.B,), np.int32)
        starts = np.zeros((self.B,), np.int32)
        totals = np.ones((self.B,), np.int32)
        emits = []
        for i in slots_p:
            s = self.slots[i]
            off, plen = s.chunk_next, len(s.req.prompt)
            nc = min(C, plen - off)
            tokens[i, :nc] = s.req.prompt[off:off + nc]
            admit[i] = True
            clens[i], starts[i], totals[i] = nc, off, off + nc
            if off + nc == plen:
                emits.append(i)
        ptok, toks, pos, done, remaining, decoded = self._run_mixed(tokens, admit, clens,
                                                                   starts, totals)
        self.stats["mixed_decode_steps"] += decoded
        self._admission_mark = True        # this step carried prefill work
        self._apply_decode(toks[None], pos, done, remaining, 1)
        for i in slots_p:
            self.slots[i].chunk_next += int(clens[i])
            self.stats["prefill_tokens"] += int(clens[i])
            self.stats["prefill_chunks"] += 1
        self.stats["prefill_calls"] += 1
        self._post_chunks(slots_p)
        if emits:
            adm = np.zeros((self.B,), bool)
            adm[emits] = True
            self._finish_admission([(i, self.slots[i].req) for i in emits], adm, ptok)
            for i in emits:
                self.slots[i].chunk_next = None

    def _block_size(self) -> int:
        """Fused block size in {1, 2, 4, ..., block_steps}, stretched to the
        longest active budget: the fewest host round trips; admission waits
        at most one block."""
        active = self.remaining[(~self.dones) & (self.remaining > 0)]
        if active.size == 0:
            return 0
        n = 1
        while n * 2 <= min(self.block_steps, int(active.max())):
            n *= 2
        return n

    def request_summary(self) -> Dict:
        """Latency over the completed requests (TTFT, queue wait), the
        decode inter-token latency overall and in admission windows, the
        finish reasons and, under spec decode, acceptance and tokens per
        verify step."""
        out: Dict = {"requests": len(self.done)}
        for key in ("ttft_s", "queue_s"):
            s = percentile_summary(r.stats[key] for r in self.done if key in r.stats)
            if s is not None:
                out[key] = s
        if self._itl:
            out["decode_itl_s"] = percentile_summary(d for d, _ in self._itl)
            adm = percentile_summary(d for d, a in self._itl if a)
            if adm is not None:
                out["decode_itl_admission_s"] = adm
        if self.stats.get("spec_steps"):
            prop = self.stats["spec_proposed"]
            slot_steps = max(1, self.stats["spec_slot_steps"])
            out["spec"] = {"steps": self.stats["spec_steps"],
                           "acceptance_rate": self.stats["spec_accepted"] / prop if prop else 0.0,
                           "mean_tokens_per_step": self.stats["spec_emitted"] / slot_steps,
                           "mean_accepted_per_step": self.stats["spec_accepted"] / slot_steps}
        reasons: Dict[str, int] = {}
        for r in self.done:
            reasons[r.finish_reason or "length"] = reasons.get(r.finish_reason or "length", 0) + 1
        out["finish_reasons"] = reasons
        return out

    # -- main loop --------------------------------------------------------
    def _init_caches(self) -> None:
        # ring caches get spec_k slack entries so that a verify chunk of
        # spec_k drafts never wraps onto live window history
        self.caches = self.engine.init_slot_caches(self.B, ring_slack=self.spec_k)

    def _serve_round(self) -> bool:
        """One round (retire -> admit -> a mixed step while any slot is
        mid-prefill, else a verify step or a decode block); False when idle
        with nothing queued."""
        self._retire()
        self._admit()
        if self._prefilling():
            self._mixed_step()
            return True
        n = self._block_size()
        if n == 0:
            pending = [r.arrival_step for r in self.queue]
            if not pending:
                return False
            # idle: jump the virtual clock to the next arrival
            self.step_count = max(self.step_count, min(pending))
            return True
        if self.spec_k:
            self._spec_step()
        else:
            self._decode_block(n)
        return True

    def run(self) -> List[Request]:
        """Serve until queue and slots drain; requests in completion order."""
        if self.caches is None:
            self._init_caches()
        while self._serve_round():
            pass
        self._retire()
        self.engine.check_replicated(self.done)
        return self.done


class PagedContinuousScheduler(ContinuousScheduler):
    """Continuous batching over the paged KV backend: the dense loop plus
    host-side block management (``kvcache.BlockAllocator``).

    * block-aware admission: a request is admitted only when free blocks
      cover its whole prompt; full blocks of a prefix already resident are
      referenced instead of recomputed, and only the suffix is prefilled;
    * incremental allocation: decode claims a slot's next block only when
      its position crosses a block boundary;
    * preempt-to-requeue: when the pool runs out mid-decode, the most
      recently admitted request is evicted (blocks freed, requeued at the
      head, recomputed on readmission);
    * prefix reuse: a prompt's full blocks are published after its prefill
      (under chunked admission, as each chunk completes them) and evicted
      with their last reference;
    * spec decode: a verify step claims blocks for its spec_k + 1 writes
      first and frees those past the rewound frontier after.

    ``n_blocks`` defaults to the dense footprint (n_slots x blocks per slot
    + the null block); smaller overcommits the pool against short requests.
    An attention-free model (mamba2-1.3b) has no pools: its requests take
    no blocks and share no prefix (recurrent state cannot be grafted from
    another slot's history), and each slot carries its state, as in the
    reference.
    """

    def __init__(self, engine: Engine, n_slots: int, pad_id: int = 0, block_steps: int = 8,
                 *, prefill_chunk: Optional[int] = None, spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None, block_size: Optional[int] = None,
                 n_blocks: Optional[int] = None, prefix_cache: bool = True):
        # paged is a hard backend choice, no silent fallback: the registry
        # raises its error for ring archs
        engine.caps.require("paged")
        super().__init__(engine, n_slots, pad_id, block_steps, prefill_chunk=prefill_chunk,
                         spec_k=spec_k, spec_ngram=spec_ngram)
        kinds = set(engine.cfg.layer_pattern)
        self.has_attn = bool(kinds & {"attn", "local_attn"})
        self.bs = block_size or engine.parallel.kv_block_size
        self.view_blocks = -(-engine.max_len // self.bs)
        self.n_blocks = (n_blocks or engine.parallel.kv_pool_blocks
                         or n_slots * self.view_blocks + 1)
        self.alloc = kvcache.BlockAllocator(self.n_blocks, self.bs)
        self.prefix_cache = prefix_cache and kinds <= {"attn", "local_attn"}
        # per-slot block table; unallocated entries point at the null block
        self.bt = np.zeros((n_slots, self.view_blocks), np.int32)
        self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
        self.stats.update({"prefill_tokens_saved": 0, "preemptions": 0,
                           "shared_block_hits": 0, "blocks_hwm": 0, "blocks_in_use": 0,
                           "deferred_admissions": 0, "prefix_prefill_calls": 0})

    def _note_usage(self) -> None:
        used = self.alloc.used_count()
        self.stats["blocks_in_use"] = used
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"], used)

    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None,
               arrival_step: int = 0) -> int:
        need = -(-(len(prompt) + max_new) // self.bs)
        if self.has_attn and need > self.n_blocks - 1:
            raise ValueError(f"request needs {need} blocks > pool {self.n_blocks - 1}")
        return super().submit(prompt, max_new, eos_id, arrival_step)

    def _init_caches(self) -> None:
        self.caches = self.engine.init_paged_caches(self.B, self.n_blocks, self.bs)

    # -- block management -------------------------------------------------
    def _release_slot(self, i: int) -> None:
        if self.slot_blocks[i]:
            self.alloc.free(self.slot_blocks[i])
            self.slot_blocks[i] = []
        self.bt[i, :] = kvcache.NULL_BLOCK
        self._note_usage()

    def _retire(self) -> None:
        for i, s in enumerate(self.slots):
            if s.req is not None and self.dones[i] and s.chunk_next is None:
                self._release_slot(i)
        super()._retire()

    def _preempt_youngest(self) -> bool:
        """Evict the most recently admitted running request: free its
        blocks and requeue it at the head (recomputed on readmission).  Its
        tokens so far are discarded and the emitted counter rolls back.  A
        slot mid-prefill is a candidate too; its chunk progress is dropped."""
        cand = [i for i, s in enumerate(self.slots)
                if s.req is not None and ((not self.dones[i] and self.remaining[i] > 0)
                                          or s.chunk_next is not None)]
        if not cand:
            return False
        i = max(cand, key=lambda j: (self.slots[j].admitted_step, self.slots[j].req.rid))
        req = self.slots[i].req
        self.stats["emitted"] -= len(self.slots[i].toks)
        self._release_slot(i)
        self.slots[i] = _Slot()
        self.dones[i] = True
        self.remaining[i] = 0
        req.stats["preempted"] = req.stats.get("preempted", 0) + 1
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1
        return True

    def _grow_slot(self, i: int, n_needed: int) -> bool:
        """Extend slot i's table to ``n_needed`` blocks; False if the pool
        cannot supply them."""
        have = len(self.slot_blocks[i])
        if n_needed <= have:
            return True
        fresh = self.alloc.alloc(n_needed - have)
        if fresh is None:
            return False
        self.bt[i, have:have + len(fresh)] = fresh
        self.slot_blocks[i].extend(fresh)
        self._note_usage()
        return True

    def _ensure_capacity(self, n: int) -> None:
        """Before a block of ``n`` decode steps every active slot must own
        the blocks of its writes at pos .. pos + min(n, remaining) - 1 (a
        slot that finishes mid-block freezes; its frozen rewrites stay in
        its blocks or go to the null block).  When the pool is short, the
        youngest request is preempted and the slot checked again."""
        if not self.has_attn:       # recurrent-only: nothing to own
            return
        i = 0
        while i < len(self.slots):
            s = self.slots[i]
            if s.req is None or self.dones[i] or self.remaining[i] <= 0:
                i += 1
                continue
            steps = min(n, int(self.remaining[i]))
            if self._grow_slot(i, -(-(int(self.pos[i]) + steps) // self.bs)):
                i += 1
                continue
            if not self._preempt_youngest():
                # no block and nothing to evict: abort this request only
                self._abort_slot(i, "paged pool exhausted with nothing to preempt")
                i += 1
            # else re-check slot i (it may itself have been evicted)

    def _run_decode(self, n: int):
        return self.engine.decode_slots(self.caches, self.tok, self.pos, self.dones,
                                        self.remaining, self.eos, n=n, block_tables=self.bt)

    # -- admission --------------------------------------------------------
    def _admit(self) -> int:
        free = self._free_slots()
        arrived = self._admissible()
        if not free or not arrived:
            return 0
        in_flight = self._in_flight()
        # FIFO until the first request whose blocks do not fit
        pairs, starts_of = [], {}
        for r, slot in zip(arrived, free):
            if not self.has_attn:   # recurrent-only: no blocks to reserve
                starts_of[r.rid] = 0
                pairs.append((slot, r))
                continue
            plen = len(r.prompt)
            shared, n_cached = [], 0
            if self.prefix_cache:
                shared, n_cached = self.alloc.match_prefix(r.prompt)
                while n_cached > plen - 1:   # keep >= 1 suffix token to run
                    shared = shared[:-1]
                    n_cached -= self.bs
            fresh = self.alloc.alloc(-(-plen // self.bs) - len(shared))
            if fresh is None:
                self.stats["deferred_admissions"] += 1
                break
            if shared:
                self.alloc.incref(shared)
                self.stats["shared_block_hits"] += len(shared)
            blocks = shared + fresh
            self.slot_blocks[slot] = blocks
            self.bt[slot, :] = kvcache.NULL_BLOCK
            self.bt[slot, :len(blocks)] = blocks
            starts_of[r.rid] = n_cached
            pairs.append((slot, r))
        if not pairs:
            return 0
        self._note_usage()
        self._assign(pairs)
        for _, r in pairs:
            r.stats["prefill_tokens_saved"] = starts_of[r.rid]
            self.stats["prefill_tokens_saved"] += starts_of[r.rid]
        self.stats["admission_rounds"] += 1
        if in_flight:
            self.stats["in_flight_admissions"] += len(pairs)
        if self.chunk:
            self._start_chunks(pairs, starts_of)
        else:
            self._prefill_suffix(pairs, starts_of)
        return len(pairs)

    def _prefill_suffix(self, pairs, starts_of) -> None:
        """Whole-suffix paged admission: one bucketed prefill of the
        admitted slots through their block tables."""
        Lp = self._bucket(max(len(r.prompt) - starts_of[r.rid] for _, r in pairs))
        tokens = np.full((self.B, Lp), self.pad_id, np.int32)
        admit = np.zeros((self.B,), bool)
        plens = np.ones((self.B,), np.int32)
        starts = np.zeros((self.B,), np.int32)
        totals = np.ones((self.B,), np.int32)
        for slot, r in pairs:
            suffix = r.prompt[starts_of[r.rid]:]
            tokens[slot, :len(suffix)] = suffix
            admit[slot] = True
            plens[slot] = len(suffix)
            starts[slot] = starts_of[r.rid]
            totals[slot] = len(r.prompt)
            self.stats["prefill_tokens"] += len(suffix)
        # the engine computes and writes the admitted rows only, through
        # their own table rows: a live slot's blocks are never written
        new_tok = self.engine.prefill_into_slots_paged(self.caches, tokens, admit, plens,
                                                       starts, totals, self.bt)
        self.stats["prefill_calls"] += 1
        self.stats["prefix_prefill_calls"] += int(starts.any())
        self._admission_mark = True
        if self.prefix_cache:   # publish the fresh full prompt blocks for reuse
            for slot, r in pairs:
                self.alloc.register_prefix(r.prompt,
                                           self.slot_blocks[slot][:len(r.prompt) // self.bs])
        self._finish_admission(pairs, admit, new_tok)

    # -- speculative decoding and chunked admission hooks --------------------
    def _ensure_spec_capacity(self) -> None:
        # a verify step writes spec_k + 1 tokens per active slot, accepted or
        # not: every slot needs the blocks of the worst case first
        self._ensure_capacity(self.spec_k + 1)

    def _run_verify(self, vtok):
        # the engine computes, writes and reads the active rows only, each
        # through its own table row: a frozen slot's blocks are never touched
        return self.engine.verify_slots(self.caches, vtok, self.pos, self.dones,
                                        self.remaining, self.eos, block_tables=self.bt)

    def _post_verify(self, active: List[int]) -> None:
        # the paged half of the rewind: blocks claimed for draft positions
        # past the accepted frontier hold only rejected drafts; [0, pos) is
        # valid and the entry at pos is the next step's to write
        for i in active:
            keep = -(-int(self.pos[i]) // self.bs)
            blocks = self.slot_blocks[i]
            if len(blocks) > keep:
                self.alloc.free(blocks[keep:])
                self.bt[i, keep:len(blocks)] = kvcache.NULL_BLOCK
                self.slot_blocks[i] = blocks[:keep]
        self._note_usage()

    def _pre_mixed(self) -> None:
        # the decode half writes one token per active slot (may preempt)
        self._ensure_capacity(1)

    def _run_mixed(self, tokens, admit, clens, starts, totals):
        # the chunk writes through the admitting rows' tables only, the
        # decode half through every slot's
        return self.engine.mixed_step(self.caches, tokens, admit, clens, starts, totals,
                                      self.tok, self.pos, self.dones, self.remaining, self.eos,
                                      block_tables=self.bt)

    def _post_chunks(self, slots_p: List[int]) -> None:
        # each chunk completes chunk_next // block_size full blocks, which
        # admissions arriving while the rest streams in can share at once
        if not self.prefix_cache:
            return
        for i in slots_p:
            s = self.slots[i]
            n_full = s.chunk_next // self.bs
            if n_full:
                self.alloc.register_prefix(s.req.prompt, self.slot_blocks[i][:n_full])
