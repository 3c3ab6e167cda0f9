"""Request scheduling over the engine (``repro.runtime.scheduler``):
``Request``, the drain-and-restart ``WaveScheduler``, continuous batching
over slots with a dense (``ContinuousScheduler``) or a paged
(``PagedContinuousScheduler``) KV cache, and disaggregated prefill/decode
pools with KV-block migration (``DisaggScheduler``).

A wave takes up to ``batch_size`` queued requests, right-pads their prompts
to the longest one, runs one prefill and decodes every row to the wave's
largest ``max_new``; each request then keeps its own ``max_new`` tokens, cut
after its EOS.

A multi-codebook arch (musicgen-medium) serves (prompt_len, ncb) prompts
and emits (n, ncb) frames; codebook 0 carries the EOS stream
(``tok_scalar``).  A frontend arch (internvl2-26b, musicgen-medium) puts
its fixed prefix in front of every prompt: every cache extent and position
counts it.

The continuous schedulers run the JAX package's loop: retire finished
slots, admit arrived requests into free slots, then step.  With
``prefill_chunk`` set (the default, 256) every admitted prompt streams
through fused mixed steps, one chunk per step while the other slots
decode one token; with 0 it is admitted whole by one bucketed prefill.
With ``spec_k`` set, a step verifies ``spec_k`` n-gram drafts per active
slot and emits 1..spec_k+1 tokens; otherwise decode runs in fused blocks
of masked steps.

The serving control plane is the JAX package's too:

* **overlap** (``overlap_decode``): decode block N+1 is dispatched on
  block N's device outputs before N lands (``Engine.dispatch_decode``);
  the host state advances on a prediction that only a landed EOS can
  break, rolled back at the landing.  Admission, chunks and verify steps
  drain the pipeline first.  Greedy streams, retire order and the (rid,
  token) emission order equal the blocking loop's.
* **faults** (``fault_plan``, ``runtime/faults.py``): a step failure
  raised before the step launches anything is retried from the exact
  pre-step state with exponential backoff, then quarantines its blamed
  slot; a poisoned token quarantines its slot; an injected allocation
  denial preempts; nothing of another slot's stream changes.  Deadlines
  (``deadline_s``) retire a request with finish_reason "timeout".
* **priority classes** (``interactive`` | ``standard`` | ``batch``):
  admission orders arrivals by class, reserves keep slots (and paged
  blocks) for interactive admissions, preemption evicts the lowest class
  first, and the degradation ladder (``runtime/overload.py``) sheds batch,
  suspends spec decode and tightens admission under sustained overload.
  Every lever changes which requests run and when, never their tokens.

Over a world of ranks (tensor parallelism, the data axis) every rank runs
its own scheduler over the same requests; its decisions depend on the
requests, the sampled tokens and the virtual clock, which are the same on
every rank (at dp > 1 the engine gathers each block's tokens over the data
group when it lands), so the ranks make the same engine calls.  What
reads the wall clock, and what reaches one rank only, world rank 0
decides once a round and broadcasts in a round record
(``runtime/control.py``), which every rank applies at the head of the
round (``_round_prologue``): the deadlines that passed, the ladder's ITL
signal, the frontend's accepted requests and door sheds, the drain.
Every round of a world of more than one rank makes a record; a world of
one rank makes none.  So the
whole control plane serves at any tp and dp: overlap, fault plans (a
``delay`` clause sleeps on rank 0 only), deadlines, priority classes with
the ladder and the frontend.  A run ends by checking that every rank
served the same streams with the same outcomes and control counters
(``Engine.check_replicated``).  At dp > 1 the slots split evenly over the
data shards, and the paged pool into one block namespace a shard
(``_shard_of``): a slot's blocks come from its shard's pool.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.models import model as M
from repro_torch.runtime import kvcache
from repro_torch.runtime.control import ControlChannel, RoundRecord
from repro_torch.runtime.drafter import NgramDrafter
from repro_torch.runtime.engine import DecodeBlock, Engine
from repro_torch.runtime.faults import FaultPlan, MigrationFault, TransientStepError
from repro_torch.runtime.overload import OverloadController

MIN_BUCKET = 8      # smallest admission width: prompts pad to a power of two >= this

# Priority classes, best first.  Rank 0 (interactive) admits first, is
# never shed by the degradation ladder and is protected by the reserves;
# rank 2 (batch) is shed first and preempted first.
PRIORITY_CLASSES = ("interactive", "standard", "batch")
PRIORITY_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}


def check_priority(priority: str) -> str:
    if priority not in PRIORITY_RANK:
        raise ValueError(f"unknown priority class {priority!r}; expected one of "
                         f"{PRIORITY_CLASSES}")
    return priority


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
    # why it retired: "stop" (EOS) | "length" (budget) | "error"
    # (quarantined: poisoned output, persistent step failure, pool
    # exhaustion) | "timeout" (deadline) | "shed" (by the degradation
    # ladder at admission: empty output, never held a slot)
    finish_reason: Optional[str] = None
    # wall-clock deadline in seconds from submission: past it the request
    # retires with finish_reason "timeout", keeping what it emitted
    deadline_s: Optional[float] = None
    priority: str = "standard"    # PRIORITY_CLASSES


class WaveScheduler:
    def __init__(self, engine: Engine, batch_size: int, pad_id: int = 0):
        self.engine = engine
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._next_id = 0

    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None,
               arrival_step: int = 0, priority: str = "standard") -> int:
        """Queue a request; waves ignore ``arrival_step`` (they drain the
        queue in order), which the continuous schedulers read, and record
        ``priority`` without scheduling by it (the pessimistic baseline)."""
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, np.asarray(prompt), max_new, eos_id, arrival_step,
                                  priority=check_priority(priority)))
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
class _Pending:
    """A dispatched decode block not landed yet (the overlapped loop): the
    engine's ``DecodeBlock`` and the host context its landing replays the
    emissions against, as the blocking loop would have: the slot objects
    and eos ids at dispatch and the predicted-active mask (a superset of
    the device's: an EOS freezes a slot earlier than predicted)."""

    block: DecodeBlock
    n: int                        # fused steps in the block
    base_step: int                # engine step of the block's first row
    slots: List                   # slot objects at dispatch
    eos: np.ndarray               # per-slot eos ids at dispatch
    active: np.ndarray            # predicted-active mask at dispatch
    adm_mark: bool                # the admission mark this block took over
    dispatch_t: float = 0.0       # host clock when the dispatch returned


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
    up to ``block_steps`` masked decode steps (``responsive_blocks``: cut at
    the shortest active budget while arrivals wait).  ``prefill_chunk``,
    ``spec_k`` and ``spec_ngram`` default to the engine's
    ``ParallelConfig``; a chunk of 0 admits whole prompts by one bucketed
    prefill.  An arch whose capability record blocks chunked prefill or
    spec decode (recurrent state) falls back to whole-prompt admission and
    plain decode when the value is the config's default, and raises the
    record's error when it was asked for here.  A sliding-window arch caps
    prompts (and buckets) at its window.  A multi-codebook arch's slots hold
    (ncb,) frames, and a frontend arch's positions start after its prefix
    (the engine's slot prefill projects zero features itself).

    The control plane's options (``overlap``, ``fault_plan``,
    ``max_step_retries``, ``retry_backoff_s``, ``reserve_slots``,
    ``reserve_blocks``, the SLO targets and the ladder's knobs) default to
    the ``ParallelConfig`` fields of the same names; ``overload_opts``
    merges over the ladder's and its "enabled" key turns it on or off.
    ``on_token(rid, token)`` streams each emission, ``on_finish(request)``
    each retirement; ``serve_step`` runs one round for an external driver.
    In a world of ranks, a request that reached world rank 0 only (the
    frontend's) is submitted there and then ``announce_submit``-ed: the
    next round's record submits it on every other rank; ``stop_followers``
    ends the other ranks' loops (``control_stopped``).
    """

    def __init__(self, engine: Engine, n_slots: int, pad_id: int = 0, block_steps: int = 8,
                 *, prefill_chunk: Optional[int] = None, spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None, responsive_blocks: bool = False,
                 on_token: Optional[Callable[[int, int], None]] = None,
                 overlap: Optional[bool] = None, fault_plan: Optional[str] = None,
                 max_step_retries: Optional[int] = None,
                 retry_backoff_s: Optional[float] = None,
                 slo_targets: Optional[Dict[str, float]] = None,
                 reserve_slots: Optional[int] = None, reserve_blocks: Optional[int] = None,
                 overload_opts: Optional[Dict] = None):
        self.engine = engine
        self.B = n_slots
        self.pad_id = pad_id
        self.block_steps = block_steps
        self.responsive_blocks = responsive_blocks
        self.on_token = on_token
        self.on_finish: Optional[Callable[[Request], None]] = None
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
            "prefill_calls": 0, "prefill_tokens": 0,
            "prefill_chunks": 0, "chunked_admissions": 0,
            # mixed steps whose decode half ran (some slot was decode-active)
            "mixed_decode_steps": 0,
            # host/device split, both loops: host_blocked_s sums the waits
            # for decode blocks to land (``_materialize``), host_overlap_s
            # the host time between a block's dispatch and its landing
            "host_blocked_s": 0.0, "host_overlap_s": 0.0, "landings": 0,
            "eos_rollbacks": 0, "dispatch_ahead_steps": 0,
            "max_dispatch_ahead": 0, "shed_requests": 0,
            # failure isolation (request_summary shows them when any is set)
            "step_faults": 0, "step_retries": 0, "quarantined": 0,
            "timeouts": 0, "aborts_exhaustion": 0, "livelock_aborts": 0,
            "migration_faults": 0,
        }
        if self.spec_k:
            self.stats.update({"spec_steps": 0, "spec_slot_steps": 0, "spec_proposed": 0,
                               "spec_accepted": 0, "spec_emitted": 0})
        # faults: the plan (an empty one costs nothing), bounded retry, and
        # the liveness clock the frontend's watchdog reads
        self.faults = FaultPlan.parse(par.fault_plan if fault_plan is None else fault_plan)
        self.max_step_retries = int(par.max_step_retries if max_step_retries is None
                                    else max_step_retries)
        self.retry_backoff_s = float(par.retry_backoff_s if retry_backoff_s is None
                                     else retry_backoff_s)
        self._retry_streak = 0            # consecutive failures of one step
        self._progress_t = time.monotonic()
        self._has_deadlines = False       # some request carries a deadline
        # slots retired by the host (quarantine, timeout) that the device
        # still decodes: a landed done mask is OR-ed with this, so a block
        # dispatched before the retirement cannot bring the slot back
        self._forced_done = np.zeros((n_slots,), bool)
        # the overlapped loop: the pipeline of dispatched blocks, and the
        # exact landed state its landings replay from
        self.overlap = bool(par.overlap_decode if overlap is None else overlap)
        self._pipeline: "deque[_Pending]" = deque()
        self._exact_tok = self._exact_pos = None
        self._exact_dones = self._exact_rem = None
        # decode inter-token latency samples (seconds/step, during
        # admission), the most recent window
        self._itl: "deque" = deque(maxlen=65536)
        self._last_step_t: Optional[float] = None
        self._admission_mark = False
        # tokens emitted per (engine step, active slot): 1, or 1..spec_k+1
        self._tps: "deque[int]" = deque(maxlen=65536)
        # priority classes: per-class per-token SLO targets, the interactive
        # reserves (slots here; blocks read by the paged backend) and the
        # degradation ladder
        self.slo_targets = {"interactive": par.slo_interactive_s,
                            "standard": par.slo_standard_s, "batch": par.slo_batch_s}
        if slo_targets:
            self.slo_targets.update(slo_targets)
        self.reserve_slots = int(par.interactive_reserve_slots if reserve_slots is None
                                 else reserve_slots)
        self.reserve_blocks = int(par.interactive_reserve_blocks if reserve_blocks is None
                                  else reserve_blocks)
        opts = {"enabled": par.overload_degrade, "queue_hi": par.overload_queue_hi,
                "queue_lo": par.overload_queue_lo,
                "slo_s": float(self.slo_targets.get("interactive") or 0.0),
                "itl_hi": par.overload_itl_hi, "itl_lo": par.overload_itl_lo,
                "patience": par.overload_patience, "cooldown": par.overload_cooldown}
        opts.update(overload_opts or {})
        enabled = opts.pop("enabled")
        # what this scheduler turns on is refused where the config's would be
        M.check_supported(engine.cfg, dataclasses.replace(
            par, overlap_decode=self.overlap,
            fault_plan=par.fault_plan if fault_plan is None else fault_plan,
            overload_degrade=bool(enabled)))
        if self.faults:
            engine.dispatch_hook = self._fault_dispatch
            self.faults.sleeps = engine.dist.world_rank == 0
        # the round records of a world of ranks (runtime/control.py)
        self._control = ControlChannel(engine.dist) if engine.dist.world > 1 else None
        self.control_stopped = False
        self.overload_ctl = None
        if enabled:
            if opts["queue_hi"] <= 0:
                opts["queue_hi"] = 2 * n_slots
            if opts["queue_lo"] <= 0:
                opts["queue_lo"] = max(1, n_slots // 2)
            opts["queue_lo"] = min(opts["queue_lo"], opts["queue_hi"])
            self.overload_ctl = OverloadController(**opts)
        self.stats["classes"] = {c: {"served": 0, "shed": 0, "timeout": 0, "error": 0}
                                 for c in PRIORITY_CLASSES}
        self.stats.update({"burst_injected": 0, "overload_transitions": 0, "control_s": 0.0,
                           "spec_off_rounds": 0})
        # recent per-step ITL the ladder reads (wall clock: advisory beside
        # the queue depth on the virtual clock)
        self._itl_recent: "deque[float]" = deque(
            maxlen=self.overload_ctl.window if self.overload_ctl else 32)

    # -- submission -------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None,
               arrival_step: int = 0, deadline_s: Optional[float] = None,
               priority: str = "standard") -> int:
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
        self.queue.append(Request(rid, prompt, max_new, eos_id, arrival_step,
                                  deadline_s=deadline_s, priority=check_priority(priority)))
        if deadline_s is not None:
            self._has_deadlines = True
        return rid

    def announce_submit(self, rid: int) -> None:
        """World rank 0, after ``submit`` of a request that reached it only
        (the frontend's): the next round's record submits it on every other
        rank as ``rid``.  A no-op in a world of one rank."""
        if self._control is not None and self._control.controller:
            r = next(r for r in reversed(self.queue) if r.rid == rid)
            self._control.announce_submit(rid, r.prompt, r.max_new, r.eos_id, r.arrival_step,
                                          r.deadline_s, r.priority)

    def note_door_shed(self, priority: str) -> None:
        """Count a request the frontend shed at its door (it never reached
        the scheduler): ``shed_requests`` and the class's bucket, on every
        rank of the world through the next round's record."""
        self.stats["shed_requests"] += 1
        buckets = self.stats.setdefault("classes", {}).setdefault(
            priority, {"served": 0, "shed": 0, "timeout": 0, "error": 0})
        buckets["shed"] += 1
        if self._control is not None and self._control.controller:
            self._control.announce_door_shed(priority)

    # -- internals --------------------------------------------------------
    def _inflight_mask(self) -> Optional[np.ndarray]:
        """Slots with emissions still in flight (predicted active in an
        unlanded block): they may not retire or be reused before it lands."""
        if not self._pipeline:
            return None
        m = np.zeros((self.B,), bool)
        for rec in self._pipeline:
            m |= rec.active
        return m

    def _finish(self, r: Request) -> None:
        """Every retirement ends here (retire, quarantine, deadline, shed):
        ``finished_step`` stamps it on the virtual decode-step clock, the
        class counters count it and ``on_finish`` sees it."""
        r.stats["finished_step"] = self.step_count
        buckets = self.stats["classes"].setdefault(
            r.priority, {"served": 0, "shed": 0, "timeout": 0, "error": 0})
        fr = r.finish_reason or "length"
        buckets["served" if fr in ("stop", "length")
                else fr if fr in ("shed", "timeout") else "error"] += 1
        self.done.append(r)
        if self.on_finish is not None:
            self.on_finish(r)

    def _shed_request(self, r: Request) -> None:
        """The ladder's admission shed: the queued request retires at once
        with finish_reason "shed" and an empty output; it never held a
        slot."""
        r.output = np.zeros((0,), np.int32)
        r.finish_reason = "shed"
        r.stats.update({"emitted": 0, "finished_at": time.monotonic()})
        self.stats["shed_requests"] += 1
        self._finish(r)

    def _retire(self) -> None:
        now = time.monotonic()
        infl = self._inflight_mask()
        for i, s in enumerate(self.slots):
            # mid-prefill slots ride with done=True but are not finished; a
            # done slot with emissions in flight waits for them to land
            if (s.req is not None and self.dones[i] and s.chunk_next is None
                    and (infl is None or not infl[i])):
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
        """Arrived queue entries, interactive first: a stable sort by class,
        so FIFO order (and a preempted request's place at the head) holds
        within a class.  Classes the ladder sheds retire here."""
        arrived = [r for r in self.queue if r.arrival_step <= self.step_count]
        ctl = self.overload_ctl
        if ctl is not None and ctl.shed_classes and arrived:
            for r in [r for r in arrived if r.priority in ctl.shed_classes]:
                self.queue.remove(r)
                self._shed_request(r)
            arrived = [r for r in arrived if r.priority not in ctl.shed_classes]
        arrived.sort(key=lambda r: PRIORITY_RANK[r.priority])
        return arrived

    def _admission_quota(self, n_free: int) -> int:
        """Admissions allowed this round: the free slots, cut at
        tight-admission to the ladder's cap on concurrent admissions (slots
        still mid-prefill count)."""
        ctl = self.overload_ctl
        if ctl is not None and ctl.admission_cap is not None:
            n_free = min(n_free, max(0, ctl.admission_cap - len(self._prefilling())))
        return n_free

    def _in_flight(self) -> bool:
        return any(s.req is not None and (not self.dones[i] or s.chunk_next is not None)
                   for i, s in enumerate(self.slots))

    def _assign(self, pairs) -> None:
        """Dequeue the chosen requests and seat them in their slots."""
        now = time.monotonic()
        for slot, r in pairs:
            self.queue.remove(r)
            self.slots[slot] = _Slot(req=r, admitted_step=self.step_count)
            self._forced_done[slot] = False
            r.stats["queue_s"] = now - r.submitted_at
            r.stats["admitted_step"] = self.step_count

    def _admit(self) -> int:
        free = self._free_slots()
        arrived = self._admissible()
        if not free or not arrived:
            return 0
        # class order; a non-interactive request may not take the last
        # reserve_slots free slots, and since arrivals are sorted by class
        # the first refusal ends the scan
        quota = self._admission_quota(len(free))
        chosen: List[Request] = []
        left = len(free)
        for r in arrived:
            if len(chosen) >= quota:
                break
            if r.priority != "interactive" and left <= self.reserve_slots:
                break
            chosen.append(r)
            left -= 1
        if not chosen:
            return 0
        pairs = list(zip(free, chosen))
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
        new_tok = self._landed(self.engine.prefill_into_slots(self.caches, tokens, admit, plens))
        self.stats["prefill_tokens"] += int(plens[admit].sum())
        self.stats["prefill_calls"] += 1
        self._admission_mark = True
        self._finish_admission(pairs, admit, new_tok)

    def _finish_admission(self, pairs, admit, new_tok) -> None:
        """Record each admitted request's first token (frame) and arm its
        decode state: its position follows the prefix and the prompt.  A
        token out of the vocab (what non-finite logits sample to)
        quarantines the request before it reaches the stream."""
        self.tok = np.where(admit if self.ncb == 1 else admit[:, None], new_tok, self.tok)
        for slot, r in pairs:
            t = tok_scalar(new_tok[slot])
            if not 0 <= t < self.vocab:
                self._quarantine_slot(slot, "error", f"poisoned prefill token {t}")
                continue
            self.slots[slot].toks.append(t if self.ncb == 1 else new_tok[slot].copy())
            if self.on_token is not None:
                self.on_token(r.rid, t)
            self.pos[slot] = len(r.prompt) + self._prefix
            self.remaining[slot] = r.max_new - 1
            self.eos[slot] = -1 if r.eos_id is None else r.eos_id
            self.dones[slot] = r.max_new <= 1 or (r.eos_id is not None and t == r.eos_id)
            r.stats["ttft_s"] = time.monotonic() - r.submitted_at
            self.stats["emitted"] += 1

    def _landed(self, out):
        """Engine outputs just reached the host: the liveness clock the
        watchdog reads (a wedged device stops it)."""
        self._progress_t = time.monotonic()
        return out

    def _decode_inputs(self):
        """Decode state for the next dispatch: the newest unlanded block's
        device outputs while the pipeline holds one (exact: the device
        chains its own masking), else the host arrays."""
        if self._pipeline:
            return self._pipeline[-1].block.state
        return self.tok, self.pos, self.dones, self.remaining

    def _materialize(self, block: DecodeBlock):
        """Land a dispatched block, the wait counted in ``host_blocked_s``:
        the one place either loop waits for a decode block."""
        t0 = time.monotonic()
        out = self.engine.land_decode(block)
        self.stats["host_blocked_s"] += time.monotonic() - t0
        return self._landed(out)

    def _run_decode(self, n: int) -> DecodeBlock:
        """Engine dispatch of one block (the paged backend adds its tables);
        the host's predicted-active mask (a superset of the device's) tells
        a data replica whether its rows need the block at all."""
        tok, pos, dones, remaining = self._decode_inputs()
        return self.engine.dispatch_decode(self.caches, tok, pos, dones, remaining, self.eos,
                                           n=n, active=(~self.dones) & (self.remaining > 0))

    def _ensure_capacity(self, n: int) -> None:
        """Pre-decode capacity hook (paged backend: block allocation)."""

    def _decode_block(self, n: int) -> None:
        self._ensure_capacity(n)
        self._apply_decode(*self._materialize(self._run_decode(n)), n)

    # -- overlapped loop (dispatch ahead, land one block late) ---------------
    def _dispatch_block(self, n: int) -> None:
        """Dispatch one decode block without landing it; the host state
        advances on a prediction (budgets fall by the steps run; a landed
        EOS is the one surprise, rolled back in ``_land_next``).  The
        virtual clock advances at dispatch, so that arrivals become
        admissible at the blocking loop's rounds."""
        self._ensure_capacity(n)
        active = (~self.dones) & (self.remaining > 0)
        if not self._pipeline:
            # drained: the host arrays are the exact frontier
            self._exact_tok = self.tok.copy()
            self._exact_pos = self.pos.copy()
            self._exact_dones = self.dones.copy()
            self._exact_rem = self.remaining.copy()
        block = self._run_decode(n)
        self._pipeline.append(_Pending(
            block=block, n=n, base_step=self.step_count, slots=list(self.slots),
            eos=self.eos.copy(), active=active, adm_mark=self._admission_mark,
            dispatch_t=time.monotonic()))
        self._admission_mark = False
        # the predicted frontier: the device's masking, blind to EOS
        steps = np.where(active, np.minimum(n, self.remaining), 0)
        self.pos = (self.pos + steps).astype(np.int32)
        self.remaining = (self.remaining - steps).astype(np.int32)
        self.dones = self.dones | (self.remaining <= 0)
        self.step_count += n
        self.stats["decode_steps"] += n
        self.stats["slot_steps"] += n * self.B
        depth = len(self._pipeline)
        if depth > 1:
            self.stats["dispatch_ahead_steps"] += n
        self.stats["max_dispatch_ahead"] = max(self.stats["max_dispatch_ahead"], depth)

    def _land_next(self) -> None:
        """Land the oldest unlanded block and replay its emissions as the
        blocking loop's ``_apply_decode`` would (the same appends, on_token
        order and stats), stamp the ITL at host visibility, then reconcile
        the prediction: slots the device froze early (EOS) roll back in the
        predicted arrays, so later decisions see the truth."""
        if not self._pipeline:
            return
        rec = self._pipeline.popleft()
        self.stats["host_overlap_s"] += time.monotonic() - rec.dispatch_t
        toks, pos, done, remaining = self._materialize(rec.block)
        self.stats["landings"] += 1
        toks, emitted, poisoned = self._replay(toks, rec.base_step, rec.slots, self._exact_dones,
                                               self._exact_rem, rec.eos)
        # the landed state is the exact frontier after the block; the device
        # never learns of host retirements, so they are OR-ed in
        self._exact_tok = toks[-1].copy()
        self._exact_pos = np.array(pos)
        self._exact_dones = np.array(done) | self._forced_done
        self._exact_rem = np.where(self._forced_done, 0, np.array(remaining)).astype(np.int32)
        # the rollback: slots predicted to decode that a landed EOS froze
        fix = self._exact_dones & ~self.dones
        if fix.any():
            self.stats["eos_rollbacks"] += int(fix.sum())
            self.dones = self.dones | fix
            self.remaining = np.where(fix, self._exact_rem, self.remaining).astype(np.int32)
            self.pos = np.where(fix, self._exact_pos, self.pos).astype(np.int32)
        if not self._pipeline:
            # everything landed: the prediction is exact (and so the tokens)
            self.tok = self._exact_tok.copy()
            self.pos = self._exact_pos.copy()
            self.dones = self._exact_dones.copy()
            self.remaining = self._exact_rem.copy()
        self._admission_mark = rec.adm_mark
        self._note_itl(rec.n, emitted)
        for i, t in poisoned.items():
            self._quarantine_slot(i, "error", f"poisoned step output (token {t})")
        # retire in landing order, as the blocking loop retires after every
        # block, so both loops retire requests in the same order
        self._retire()

    def _drain_pipeline(self) -> None:
        """Land every unlanded block (the host state becomes exact): before
        any decision that merges host values into the engine state
        (admission, mixed and verify steps, preemption)."""
        while self._pipeline:
            self._land_next()

    def _overlap_turn(self, n: int) -> None:
        self._dispatch_block(n)
        while len(self._pipeline) > 1:
            self._land_next()

    def _replay(self, toks, base_step: int, slots, done, remaining, eos):
        """Replay the device's masking rule over landed steps (toks (n, B)
        or frames (n, B, ncb), the first at engine step ``base_step``) from
        the state before them, to tell real emissions from frozen-slot
        repeats: each goes to its slot's stream, ``on_token`` and the
        stats.  A token out of the vocab freezes its slot at once, so no
        later token of the block reaches the stream.  -> (the tokens after
        the fault plan's poison clauses, emissions, {slot: poisoned
        token})."""
        if self.faults:
            toks = self.faults.corrupt_tokens(
                toks, base_step, active=(np.array([s.req is not None for s in slots])
                                         & ~done & (remaining > 0)))
        cur_done, cur_rem = done.copy(), remaining.copy()
        emitted = 0
        poisoned: Dict[int, int] = {}
        for s in range(toks.shape[0]):
            for i, slot in enumerate(slots):
                if slot.req is None or cur_done[i] or cur_rem[i] <= 0:
                    continue
                t = tok_scalar(toks[s, i])
                if not 0 <= t < self.vocab:
                    poisoned[i] = t
                    cur_done[i] = True
                    continue
                slot.toks.append(t if self.ncb == 1 else toks[s, i].copy())
                if self.on_token is not None:
                    self.on_token(slot.req.rid, t)
                cur_rem[i] -= 1
                if cur_rem[i] == 0 or (eos[i] >= 0 and t == eos[i]):
                    cur_done[i] = True
                self.stats["emitted"] += 1
                self.stats["active_slot_steps"] += 1
                self._tps.append(1)
                emitted += 1
        return toks, emitted, poisoned

    def _apply_decode(self, toks, pos, done, remaining, n: int) -> None:
        """Host bookkeeping for ``n`` decode steps: the emissions replayed,
        then the device's final state adopted; a poisoned slot is
        quarantined."""
        toks, emitted, poisoned = self._replay(toks, self.step_count, self.slots, self.dones,
                                               self.remaining, self.eos)
        self.tok = toks[-1].copy()
        self.pos = np.array(pos)
        self.dones = np.array(done)
        self.remaining = np.array(remaining)
        self.step_count += n
        self.stats["decode_steps"] += n
        self.stats["slot_steps"] += n * self.B
        self._note_itl(n, emitted)
        for i, t in poisoned.items():
            self._quarantine_slot(i, "error", f"poisoned step output (token {t})")

    def _note_itl(self, n: int, emissions: int = 0, tokens_per_slot=None) -> None:
        """One inter-token latency sample per emitted token, stamped when the
        tokens reach the host (never at a dispatch): the block's per-step
        share of the time since the last stamp, tagged when the interval
        absorbed admission work (a prefill or a chunk).  A verify step's
        slot that emitted e tokens in a T-second step gives e samples of
        T / e (``tokens_per_slot``)."""
        now = time.monotonic()
        if self._last_step_t is not None:
            dt = (now - self._last_step_t) / n
            self._itl_recent.append(dt)
            if tokens_per_slot is None:
                self._itl.extend([(dt, self._admission_mark)] * emissions)
            else:
                for e in tokens_per_slot:
                    if e > 0:
                        self._itl.extend([(dt / e, self._admission_mark)] * e)
        self._last_step_t = now
        self._admission_mark = False

    # -- failure isolation (quarantine, bounded retry, deadlines) -----------
    def liveness_age(self) -> float:
        """Seconds since engine outputs last reached the host: the watchdog
        signal of the frontend's /health."""
        return time.monotonic() - self._progress_t

    def _release_slot(self, i: int) -> None:
        """Storage release for slot ``i`` (paged: blocks and refcounts); the
        dense cache owns nothing per slot."""

    def _quarantine_slot(self, i: int, finish_reason: str = "error",
                         error: Optional[str] = None) -> None:
        """Retire slot ``i``'s request now with a failure finish_reason,
        releasing what it holds; no other slot's stream is touched.  Safe
        with blocks in flight: the forced-done mask keeps landed device
        state from reviving the slot, and a block already queued that reads
        its freed blocks runs before any later step could write them (one
        stream, in order)."""
        s = self.slots[i]
        if s.req is None:
            return
        r = s.req
        self._release_slot(i)
        r.output = np.asarray(s.toks, dtype=np.int32)
        r.finish_reason = finish_reason
        if error is not None:
            r.stats["error"] = error
        r.stats.update({"emitted": len(s.toks), "finished_at": time.monotonic(),
                        "decode_steps_held": self.step_count - s.admitted_step})
        self.slots[i] = _Slot()
        self.tok[i] = 0
        self.dones[i] = True
        self.remaining[i] = 0
        self._forced_done[i] = True
        if self._pipeline and self._exact_dones is not None:
            self._exact_tok[i] = 0
            self._exact_dones[i] = True
            self._exact_rem[i] = 0
        self.stats["timeouts" if finish_reason == "timeout" else "quarantined"] += 1
        if self.faults:
            self.faults.on_quarantine(i)
        self._finish(r)

    def _fault_dispatch(self) -> None:
        """``Engine.dispatch_hook`` under a fault plan: consulted before
        every slot step launches anything."""
        self.faults.on_dispatch(self.step_count)

    def _try_step(self, fn):
        """Run one engine step under the bounded-retry policy.  A
        ``TransientStepError`` raised at the dispatch boundary changed
        nothing on the device (the step launched nothing and drew no
        sample): the pipeline drains to the exact landed frontier and the
        round ends, so the next round issues the same work again, bit for
        bit.  When retries run out, a failure blamed on a slot quarantines
        its request; an unattributed one propagates."""
        try:
            out = fn()
        except TransientStepError as e:
            self._recover_step_fault(e)
            return None
        self._retry_streak = 0
        return out

    def _recover_step_fault(self, e: TransientStepError) -> None:
        self._drain_pipeline()
        self.stats["step_faults"] += 1
        self._retry_streak += 1
        if self._retry_streak <= self.max_step_retries:
            self.stats["step_retries"] += 1
            backoff = self.retry_backoff_s * (2 ** (self._retry_streak - 1))
            if backoff > 0:
                time.sleep(backoff)
            return
        self._retry_streak = 0
        slot = e.slot
        if slot is not None and self.slots[slot].req is not None:
            self._quarantine_slot(slot, "error", f"persistent step failure: {e}")
            return
        raise e

    @staticmethod
    def _late(r: Request, now: float) -> bool:
        return r.deadline_s is not None and now - r.submitted_at >= r.deadline_s

    def _late_rids(self, now: float) -> set:
        """The queued and slot-resident requests past their deadline at
        ``now`` (rank 0's clock in a world of ranks)."""
        late = {r.rid for r in self.queue if self._late(r, now)}
        return late | {s.req.rid for s in self.slots
                       if s.req is not None and self._late(s.req, now)}

    def _expire_deadlines(self, late: Optional[set] = None) -> None:
        """Retire every request of ``late`` (default: those past their
        deadline now) with finish_reason "timeout": queued (an empty
        output) or in a slot (what it emitted so far).  The forced-done mask
        drops a slot's unlanded emissions."""
        now = time.monotonic()
        if late is None:
            late = self._late_rids(now)
        for r in [r for r in self.queue if r.rid in late]:
            self.queue.remove(r)
            r.output = np.zeros((0,), np.int32)
            r.finish_reason = "timeout"
            r.stats.update({"emitted": 0, "finished_at": now})
            self.stats["timeouts"] += 1
            self._finish(r)
        for i, s in enumerate(self.slots):
            if s.req is not None and s.req.rid in late:
                self._quarantine_slot(i, "timeout")

    # -- overload (burst injection, the degradation ladder) ------------------
    def _inject_bursts(self) -> None:
        """Submit the fault plan's due ``burst:`` clauses, arriving now on
        the virtual clock; prompts seeded by the scheduled fire step, so two
        runs of a plan inject the same traffic."""
        for count, plen, max_new, cls, fire_step in self.faults.burst(self.step_count):
            rng = np.random.default_rng(0xB0057 + fire_step)
            plen = min(plen, self.prompt_limit, max(2, self.engine.max_len - max_new))
            for _ in range(count):
                self.submit(rng.integers(0, self.vocab, plen, dtype=np.int32), max_new,
                            arrival_step=self.step_count, priority=cls)
                self.stats["burst_injected"] += 1

    def _recent_itl(self) -> Optional[float]:
        """The ladder's wall-clock signal: the recent landed per-step ITL."""
        return float(np.mean(self._itl_recent)) if self._itl_recent else None

    def _overload_observe(self, recent: Optional[float]) -> None:
        """One ladder observation a round: the arrived queue's depth (on the
        virtual clock) and the recent landed per-step ITL ``recent`` (wall
        clock: rank 0's in a world of ranks)."""
        ctl = self.overload_ctl
        depth = sum(1 for r in self.queue if r.arrival_step <= self.step_count)
        before = ctl.level
        ctl.observe(depth, recent)
        if ctl.level != before:
            self.stats["overload_transitions"] += 1

    def _round_record(self) -> Optional[RoundRecord]:
        """This round's record in a world of ranks, else None: rank 0's
        deadline and ITL readings, and what its frontend took, applied here
        on every rank (rank 0's submissions are already queued).
        ``control_s`` sums the host seconds spent in the exchange."""
        ctl = self._control
        if ctl is None:
            return None
        if ctl.controller:
            late = self._late_rids(time.monotonic()) if self._has_deadlines else ()
            itl = None if self.overload_ctl is None else self._recent_itl()
        t = time.perf_counter()
        rec = ctl.exchange(late, itl) if ctl.controller else ctl.exchange()
        self.stats["control_s"] += time.perf_counter() - t
        if ctl.controller:
            return rec
        for cls in rec.door_shed:
            self.note_door_shed(cls)
        for sub in rec.submits:
            rid = self.submit(np.asarray(sub["prompt"], np.int32), sub["max_new"],
                              eos_id=sub["eos_id"], arrival_step=sub["arrival_step"],
                              deadline_s=sub["deadline_s"], priority=sub["priority"])
            if rid != sub["rid"]:
                raise RuntimeError(f"world rank {self.engine.dist.world_rank} took rank 0's "
                                   f"request {sub['rid']} as {rid}")
        return rec

    def _round_prologue(self) -> bool:
        """Every round's head: the round record (world of ranks), bursts,
        deadlines, one ladder observation; False where the record says
        stop (the round does not run)."""
        rec = self._round_record()
        if rec is not None and rec.stop:
            self.control_stopped = True
            return False
        if self.faults:
            self._inject_bursts()
        if self._has_deadlines:
            self._expire_deadlines(None if rec is None else set(rec.expired))
        if self.overload_ctl is not None:
            self._overload_observe(self._recent_itl() if rec is None else rec.itl)
        return True

    def stop_followers(self) -> None:
        """World rank 0 after its last round: the stop record, which ends
        every other rank's loop (a no-op in a world of one rank)."""
        if self._control is not None and self._control.controller:
            self._control.exchange(stop=True)
        self.control_stopped = True

    def control_counters(self) -> Dict:
        """The control plane's counters that every rank of a world must
        agree on (``Engine.check_replicated``)."""
        keys = ("timeouts", "quarantined", "step_faults", "step_retries", "shed_requests",
                "overload_transitions", "burst_injected")
        out = {k: self.stats.get(k, 0) for k in keys}
        out["shed"] = {c: b["shed"] for c, b in sorted(self.stats["classes"].items())}
        if self.overload_ctl is not None:
            out["ladder"] = list(self.overload_ctl.transitions)
        return out

    def _spec_suspended(self) -> bool:
        """True while the ladder holds spec decode off (level 2+); greedy
        spec decode gives plain decode's tokens, so this changes speed
        only."""
        ctl = self.overload_ctl
        if ctl is not None and ctl.spec_off:
            self.stats["spec_off_rounds"] += 1
            return True
        return False

    def overload_level(self) -> int:
        """The ladder's level (0: normal, or no ladder); /health shows it."""
        return 0 if self.overload_ctl is None else self.overload_ctl.level

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
        targets, n_emit, nxt, pos, done, remaining = self._landed(self._run_verify(vtok))
        counts = []
        for i in active:
            e = int(n_emit[i])
            slot = self.slots[i]
            for t in targets[i, :e].tolist():
                slot.toks.append(int(t))
                if self.on_token is not None:
                    self.on_token(slot.req.rid, int(t))
            counts.append(e)
            self._tps.append(e)
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
        ptok, toks, pos, done, remaining, decoded = self._landed(
            self._run_mixed(tokens, admit, clens, starts, totals))
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
        """Fused block size in {1, 2, 4, ..., block_steps}.  Amortizing (the
        default): stretched to the longest active budget, the fewest host
        round trips; admission waits at most one block.  Responsive
        (``responsive_blocks``): while arrivals wait, cut at the shortest
        active budget (at least block_steps / 4) so that a finished slot
        refills at once."""
        active = self.remaining[(~self.dones) & (self.remaining > 0)]
        if active.size == 0:
            return 0
        waiting = any(r.arrival_step <= self.step_count for r in self.queue)
        if self.responsive_blocks and waiting:
            need = max(int(active.min()), max(1, self.block_steps // 4))
        else:
            need = int(active.max())
        n = 1
        while n * 2 <= min(self.block_steps, need):
            n *= 2
        return n

    def request_summary(self) -> Dict:
        """Latency over the completed requests (TTFT, queue wait), the
        decode inter-token latency overall and in admission windows, tokens
        per step, the host/device split of either loop (``overlap``), the
        finish reasons, the fault counters when any is set, the per-class
        breakdown, the ladder and, under spec decode, acceptance and tokens
        per verify step."""
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
        if self._tps:
            out["tokens_per_step"] = percentile_summary(self._tps)
        hb, ho = self.stats["host_blocked_s"], self.stats["host_overlap_s"]
        out["overlap"] = {
            "enabled": self.overlap, "host_blocked_s": hb, "host_overlap_s": ho,
            "host_overlap_fraction": ho / (ho + hb) if ho + hb > 0 else 0.0,
            "host_blocked_per_step_s": hb / max(1, self.stats["decode_steps"]),
            "landings": self.stats["landings"],
            "dispatch_ahead_steps": self.stats["dispatch_ahead_steps"],
            "max_dispatch_ahead": self.stats["max_dispatch_ahead"],
            "eos_rollbacks": self.stats["eos_rollbacks"],
            "shed_requests": self.stats["shed_requests"],
        }
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
        fkeys = ("step_faults", "step_retries", "quarantined", "timeouts",
                 "aborts_exhaustion", "livelock_aborts", "migration_faults")
        if any(self.stats.get(k) for k in fkeys):
            out["faults"] = {k: self.stats.get(k, 0) for k in fkeys}
        classes = self._class_summary()
        if classes:
            out["classes"] = classes
        if self.overload_ctl is not None:
            out["overload"] = self.overload_ctl.summary()
        return out

    def _class_summary(self) -> Dict:
        """Per priority class over the completed requests: the outcome
        counters, TTFT, per-request decode ITL, and where the class has an
        SLO target the share of its retired requests (shed and timed out
        ones included) that completed within it per token."""
        counters = self.stats.get("classes", {})
        classes: Dict = {}
        for cls in PRIORITY_CLASSES:
            recs = [r for r in self.done if r.priority == cls]
            counts = counters.get(cls, {})
            if not recs and not any(counts.values()):
                continue
            entry: Dict = {"requests": len(recs)}
            entry.update(counts)
            s = percentile_summary(r.stats["ttft_s"] for r in recs if "ttft_s" in r.stats)
            if s is not None:
                entry["ttft_s"] = s
            s = percentile_summary(
                (r.stats["finished_at"] - r.submitted_at - r.stats["ttft_s"])
                / (r.stats["emitted"] - 1)
                for r in recs
                if r.stats.get("emitted", 0) >= 2 and "ttft_s" in r.stats
                and "finished_at" in r.stats)
            if s is not None:
                entry["itl_s"] = s
            target = float(self.slo_targets.get(cls) or 0.0)
            if target > 0 and recs:
                ok = sum(1 for r in recs
                         if r.finish_reason in ("stop", "length")
                         and r.stats.get("emitted", 0) > 0 and "finished_at" in r.stats
                         and (r.stats["finished_at"] - r.submitted_at) / r.stats["emitted"]
                         <= target)
                entry["slo_target_s"] = target
                entry["slo_attainment"] = ok / len(recs)
            classes[cls] = entry
        return classes

    # -- main loop --------------------------------------------------------
    def _init_caches(self) -> None:
        # ring caches get spec_k slack entries so that a verify chunk of
        # spec_k drafts never wraps onto live window history
        self.caches = self.engine.init_slot_caches(self.B, ring_slack=self.spec_k)

    def _serve_round(self) -> bool:
        """One round (retire -> admit -> a mixed step while any slot is
        mid-prefill, else a verify step or a decode block); False when idle
        with nothing queued or in flight.  Overlapped, a round drains the
        pipeline only where it merges exact host values into the engine
        state (an admission could fill a slot; a chunk or verify step reads
        the token frontier); otherwise it dispatches the next block on the
        previous block's device outputs and then lands the older one."""
        if not self._round_prologue():
            return False
        if self._pipeline and any(r.arrival_step <= self.step_count for r in self.queue):
            # an arrival may admit once done slots retire: land first, so
            # that admission sees the blocking loop's frontier
            if any(s.req is None or (self.dones[i] and s.chunk_next is None)
                   for i, s in enumerate(self.slots)):
                self._drain_pipeline()
        self._retire()
        self._admit()
        if self._prefilling():
            self._drain_pipeline()
            self._try_step(self._mixed_step)
            return True
        n = self._block_size()
        if n == 0:
            if self._pipeline:
                self._land_next()          # the tail lands before going idle
                return True
            pending = [r.arrival_step for r in self.queue]
            if not pending:
                return False
            # idle: jump the virtual clock to the next arrival
            self.step_count = max(self.step_count, min(pending))
            return True
        if self.spec_k and not self._spec_suspended():
            # the drafter reads the previous step's tokens: spec runs blocking
            self._drain_pipeline()
            self._try_step(self._spec_step)
        elif self.overlap:
            self._try_step(lambda: self._overlap_turn(n))
        else:
            self._try_step(lambda: self._decode_block(n))
        return True

    def serve_step(self) -> bool:
        """One round for an external driver (the frontend's worker):
        admits what is queued, advances the engine one round, retires;
        False when there is nothing left to do.  Safe to call again after
        new ``submit`` calls."""
        if self.caches is None:
            self._init_caches()
        return self._serve_round()

    def run(self) -> List[Request]:
        """Serve until queue and slots drain; requests in completion order."""
        if self.caches is None:
            self._init_caches()
        while self._serve_round():
            pass
        self._drain_pipeline()
        self._retire()
        self.engine.check_replicated(self.done, self.control_counters())
        return self.done


class PagedContinuousScheduler(ContinuousScheduler):
    """Continuous batching over the paged KV backend: the dense loop plus
    host-side block management (``kvcache.BlockAllocator``).

    * block-aware admission: a request is admitted only when free blocks
      cover its whole prompt; full blocks of a prefix already resident are
      referenced instead of recomputed, and only the suffix is prefilled;
      a non-interactive admission may not take the last ``reserve_blocks``
      free blocks;
    * incremental allocation: decode claims a slot's next block only when
      its position crosses a block boundary;
    * preempt-to-requeue: when the pool runs out mid-decode, the lowest-
      class, most recently admitted request is evicted (blocks freed,
      requeued at the head, recomputed on readmission); with nothing to
      evict, the starved request alone aborts (finish_reason "error");
    * prefix reuse: a prompt's full blocks are published after its prefill
      (under chunked admission, as each chunk completes them) and evicted
      with their last reference;
    * spec decode: a verify step claims blocks for its spec_k + 1 writes
      first and frees those past the rewound frontier after;
    * overlap: each dispatch uploads the block tables as they stand, so a
      block claimed for a later dispatch never reaches an earlier one.

    ``n_blocks`` defaults to the dense footprint (n_slots x blocks per slot
    + the null block); smaller overcommits the pool against short requests.
    An attention-free model (mamba2-1.3b) has no pools: its requests take
    no blocks and share no prefix (recurrent state cannot be grafted from
    another slot's history), and each slot carries its state, as in the
    reference.  ``on_preempt(rid)`` tells a streaming client to drop what
    it buffered for a preempted request.
    """

    def __init__(self, engine: Engine, n_slots: int, pad_id: int = 0, block_steps: int = 8,
                 *, block_size: Optional[int] = None, n_blocks: Optional[int] = None,
                 prefix_cache: bool = True, on_preempt: Optional[Callable[[int], None]] = None,
                 **kw):
        # paged is a hard backend choice, no silent fallback: the registry
        # raises its error for ring archs
        engine.caps.require("paged")
        super().__init__(engine, n_slots, pad_id, block_steps, **kw)
        kinds = set(engine.cfg.layer_pattern)
        self.has_attn = bool(kinds & {"attn", "local_attn"})
        self.bs = block_size or engine.parallel.kv_block_size
        self.view_blocks = -(-engine.max_len // self.bs)
        # one block namespace a data shard, each with its own null block
        self.n_shards = engine.dist.dp
        if n_slots % self.n_shards:
            raise ValueError(f"n_slots {n_slots} must divide data shards {self.n_shards}")
        self.n_blocks = (n_blocks or engine.parallel.kv_pool_blocks
                         or n_slots * self.view_blocks + self.n_shards)
        self.alloc = kvcache.BlockAllocator(self.n_blocks, self.bs, self.n_shards)
        self.prefix_cache = prefix_cache and kinds <= {"attn", "local_attn"}
        self.on_preempt = on_preempt
        # per-slot block table (local ids of the slot's shard; the engine
        # hands each replica its rows); unallocated entries point at the
        # null block
        self.bt = np.zeros((n_slots, self.view_blocks), np.int32)
        self.slot_blocks: List[List[int]] = [[] for _ in range(n_slots)]
        self.stats.update({"prefill_tokens_saved": 0, "preemptions": 0,
                           "shared_block_hits": 0, "blocks_hwm": 0, "blocks_in_use": 0,
                           "deferred_admissions": 0, "prefix_prefill_calls": 0})

    def _shard_of(self, slot: int) -> int:
        """The data shard that holds ``slot`` (and whose pool its blocks
        come from)."""
        return slot // (self.B // self.n_shards)

    def _note_usage(self) -> None:
        used = self.alloc.total_used()
        self.stats["blocks_in_use"] = used
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"], used)

    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None,
               arrival_step: int = 0, deadline_s: Optional[float] = None,
               priority: str = "standard") -> int:
        need = -(-(len(prompt) + max_new) // self.bs)
        usable = self.alloc.blocks_per_shard - 1
        if self.has_attn and need > usable:
            raise ValueError(f"request needs {need} blocks > per-shard pool {usable}")
        return super().submit(prompt, max_new, eos_id, arrival_step, deadline_s, priority)

    def _init_caches(self) -> None:
        self.caches = self.engine.init_paged_caches(self.B, self.n_blocks, self.bs)

    # -- block management -------------------------------------------------
    def _release_slot(self, i: int) -> None:
        if self.slot_blocks[i]:
            self.alloc.free(self.slot_blocks[i], self._shard_of(i))
            self.slot_blocks[i] = []
        self.bt[i, :] = kvcache.NULL_BLOCK
        self._note_usage()

    def _retire(self) -> None:
        infl = self._inflight_mask()
        for i, s in enumerate(self.slots):
            if (s.req is not None and self.dones[i] and s.chunk_next is None
                    and (infl is None or not infl[i])):
                self._release_slot(i)
        super()._retire()

    def _preempt_youngest(self, shard: int) -> bool:
        """Evict the lowest-class, most recently admitted running request on
        ``shard`` (victim key: class rank, then admission step, then rid;
        with one class, the youngest): free its blocks and requeue it at the head
        (recomputed on readmission).  Its tokens so far are discarded and
        the emitted counter rolls back.  A slot mid-prefill is a candidate
        too; its chunk progress is dropped.  Never under an unlanded block:
        the pipeline drains first."""
        if self._pipeline:
            self._drain_pipeline()
        cand = [i for i, s in enumerate(self.slots)
                if s.req is not None and self._shard_of(i) == shard
                and ((not self.dones[i] and self.remaining[i] > 0) or s.chunk_next is not None)]
        if not cand:
            return False
        i = max(cand, key=lambda j: (PRIORITY_RANK[self.slots[j].req.priority],
                                     self.slots[j].admitted_step, self.slots[j].req.rid))
        req = self.slots[i].req
        self.stats["emitted"] -= len(self.slots[i].toks)
        self._release_slot(i)
        self.slots[i] = _Slot()
        self.dones[i] = True
        self.remaining[i] = 0
        req.stats["preempted"] = req.stats.get("preempted", 0) + 1
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1
        if self.on_preempt is not None:
            self.on_preempt(req.rid)
        return True

    def _grow_slot(self, i: int, n_needed: int) -> bool:
        """Extend slot i's table to ``n_needed`` blocks; False if the pool
        cannot supply them (or the fault plan denies the allocation)."""
        have = len(self.slot_blocks[i])
        if n_needed <= have:
            return True
        if self.faults and self.faults.deny_alloc(self.step_count):
            return False
        fresh = self.alloc.alloc(n_needed - have, self._shard_of(i))
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
        pipeline lands first (an EOS may free blocks), then a victim is
        preempted and the slot checked again; with nothing to evict the
        starved request alone aborts."""
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
            if self._pipeline:
                # blocks may be tied up in requests whose end has not
                # landed: land, retire, then check slot i again
                self._drain_pipeline()
                self._retire()
                continue
            if not self._preempt_youngest(self._shard_of(i)):
                self.stats["aborts_exhaustion"] += 1
                self._quarantine_slot(i, "error", "paged pool exhausted with nothing to preempt")
                i += 1
            # else re-check slot i (it may itself have been evicted)

    def _run_decode(self, n: int) -> DecodeBlock:
        tok, pos, dones, remaining = self._decode_inputs()
        return self.engine.dispatch_decode(self.caches, tok, pos, dones, remaining, self.eos,
                                           n=n, block_tables=self.bt,
                                           active=(~self.dones) & (self.remaining > 0))

    # -- admission --------------------------------------------------------
    def _admit(self) -> int:
        free = self._free_slots()
        arrived = self._admissible()
        if not free or not arrived:
            return 0
        in_flight = self._in_flight()
        # class order; stop at the first request whose blocks, or whose
        # claim on the interactive slot and block reserves, do not fit
        quota = self._admission_quota(len(free))
        pairs, starts_of = [], {}
        left = len(free)
        for r, slot in zip(arrived, free):
            if len(pairs) >= quota:
                break
            if r.priority != "interactive" and left <= self.reserve_slots:
                break
            if not self.has_attn:   # recurrent-only: no blocks to reserve
                starts_of[r.rid] = 0
                pairs.append((slot, r))
                left -= 1
                continue
            shard = self._shard_of(slot)
            plen = len(r.prompt)
            shared, n_cached = [], 0
            if self.prefix_cache:
                shared, n_cached = self.alloc.match_prefix(r.prompt, shard)
                while n_cached > plen - 1:   # keep >= 1 suffix token to run
                    shared = shared[:-1]
                    n_cached -= self.bs
            need = -(-plen // self.bs) - len(shared)
            if (r.priority != "interactive"
                    and self.alloc.free_count(shard) - need < self.reserve_blocks):
                # the blocks exist but are held for interactive admissions
                self.stats["deferred_admissions"] += 1
                break
            fresh = self.alloc.alloc(need, shard)
            if fresh is None:
                self.stats["deferred_admissions"] += 1
                break
            if shared:
                self.alloc.incref(shared, shard)
                self.stats["shared_block_hits"] += len(shared)
            blocks = shared + fresh
            self.slot_blocks[slot] = blocks
            self.bt[slot, :] = kvcache.NULL_BLOCK
            self.bt[slot, :len(blocks)] = blocks
            starts_of[r.rid] = n_cached
            pairs.append((slot, r))
            left -= 1
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
        new_tok = self._landed(self.engine.prefill_into_slots_paged(
            self.caches, tokens, admit, plens, starts, totals, self.bt))
        self.stats["prefill_calls"] += 1
        self.stats["prefix_prefill_calls"] += int(starts.any())
        self._admission_mark = True
        if self.prefix_cache:   # publish the fresh full prompt blocks for reuse
            for slot, r in pairs:
                self.alloc.register_prefix(r.prompt,
                                           self.slot_blocks[slot][:len(r.prompt) // self.bs],
                                           self._shard_of(slot))
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
                self.alloc.free(blocks[keep:], self._shard_of(i))
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
                self.alloc.register_prefix(s.req.prompt, self.slot_blocks[i][:n_full],
                                           self._shard_of(i))


class DisaggScheduler(PagedContinuousScheduler):
    """Disaggregated serving (``repro.runtime.scheduler.DisaggScheduler``):
    the data axis splits into a prefill pool (the first ``prefill_shards``
    data shards) and a decode pool (the rest), each shard with its own
    block namespace in the allocator.

    Prompts admit only to prefill-pool slots and stream through the
    chunk-only step (``Engine.chunk_slots_paged``: no decode half, since
    the decode-active slots live on other shards and step apart).  At each
    chunk boundary the completed full blocks are queued for migration at
    once; when the prompt completes, its tail block follows, the prefill
    slot is released, and the request lands in a free decode-pool slot,
    its position row rewritten by the same engine call that runs the
    queued block copies (``Engine.migrate_blocks``: the source replica
    sends them to the destination replica).  Refcounts hand off through
    the allocator: sources are pinned by ``begin_migration`` until the copy
    has run, destinations belong to the landing slot, and a decode-side
    prefix hit on a block already migrated is referenced instead of copied
    (``migration_skipped_blocks``).

    Decode reads K/V only through block tables, so it never learns where a
    block was filled: greedy streams equal the unified paged engine's at
    the same chunk width.  Every rank runs this scheduler in lockstep; a
    replica computes only its own shard's rows, so the decode pool's ranks
    skip the chunk-only step and the prefill pool's the decode blocks.
    A decode ITL sample starts at the decode dispatch (``_last_step_t``)
    and ends at its landing: in the blocking loop the dispatch's own
    duration, in the overlapped one (dp > 1 lands each block's tokens
    while the next block runs) the time from the newest dispatch to the
    landing of the block before it.  With ranks sharing one card the two
    pools time-slice it, so no ITL measured there shows the pools'
    independence.
    """

    def __init__(self, engine: Engine, n_slots: int, pad_id: int = 0, block_steps: int = 8,
                 *, prefill_shards: Optional[int] = None, **kw):
        # the pool split rides on chunked prefill over the paged backend; an
        # ineligible arch would silently serve unified, so the registry
        # refuses it with its uniform error
        engine.caps.require("disagg")
        super().__init__(engine, n_slots, pad_id, block_steps, **kw)
        self._stall = 0
        self._stall_sig = None
        if not self.chunk:
            raise ValueError("disaggregated serving needs prefill_chunk > 0")
        from repro_torch.launch.mesh import split_data_shards
        pf = (prefill_shards if prefill_shards is not None
              else engine.parallel.disagg_prefill_shards)
        try:
            self._pf_shards, self._dec_shards = split_data_shards(self.n_shards, pf)
        except ValueError as e:
            raise ValueError(
                "disaggregated serving splits the data axis into two pools "
                f"(got dp*pods={self.n_shards}, prefill_shards={pf}) — run "
                "with dp >= 2 and 1 <= prefill_shards < dp*pods") from e
        self._spss = self.B // self.n_shards
        self._pf_slots = tuple(range(len(self._pf_shards) * self._spss))
        # the migration pipeline:
        #   _mig_queue  (slot, src shard, src local, dst shard, dst local)
        #               copies waiting for the next migrate call
        #   _mig        per-slot handoff state {dst, dst_blocks, sent, ready_t}
        #   _handoff_ready  prefill-complete slots still queuing blocks
        #   _landing        fully queued requests waiting for a decode slot
        self._mig_queue: List[Tuple[int, int, int, int, int]] = []
        self._mig: Dict[int, Dict] = {}
        self._handoff_ready: List[int] = []
        self._landing: List[Dict] = []
        self._mig_wait: "deque[float]" = deque(maxlen=65536)
        self._block_bytes: Optional[int] = None
        self.stats.update({
            "migrated_blocks": 0, "migration_bytes": 0, "migration_skipped_blocks": 0,
            "migration_deferrals": 0, "migration_steps": 0, "handoffs": 0,
            "prefill_steps": 0, "prefill_slot_busy": 0, "prefill_slot_total": 0,
        })

    # -- pool geometry ----------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i in self._pf_slots if self.slots[i].req is None]

    def _prefilling(self) -> List[int]:
        # chunk_next == plen marks a slot waiting for its handoff: no longer
        # chunking, but it may not retire until its blocks have migrated
        return [i for i in super()._prefilling()
                if self.slots[i].chunk_next < len(self.slots[i].req.prompt)]

    def _pick_decode_shard(self) -> int:
        """The least loaded decode shard: most free blocks, then most free
        slots, then the lowest id."""
        def free_slots(sh: int) -> int:
            lo = sh * self._spss
            return sum(1 for j in range(lo, lo + self._spss) if self.slots[j].req is None)

        return max(self._dec_shards,
                   key=lambda sh: (self.alloc.free_count(sh), free_slots(sh), -sh))

    # -- slot release (migration state rolled back) -------------------------
    def _release_slot(self, i: int) -> None:
        m = self._mig.pop(i, None)
        if m is not None:
            # drop this slot's queued copies (unpinning their sources) and
            # return its destination blocks: a preempted request recomputes
            # from its prompt, so a half-done handoff rolls back whole
            keep = []
            for e in self._mig_queue:
                if e[0] == i:
                    self.alloc.end_migration([e[2]], e[1])
                else:
                    keep.append(e)
            self._mig_queue[:] = keep
            if m["dst_blocks"]:
                self.alloc.free(m["dst_blocks"], m["dst"])
            if i in self._handoff_ready:
                self._handoff_ready.remove(i)
        super()._release_slot(i)

    # -- the prefill pool -------------------------------------------------
    def _chunk_step(self) -> bool:
        """One chunk-only step over every mid-prefill slot (the prefill
        pool's turn: ``_mixed_step`` without the decode half)."""
        C = self.chunk
        slots_p = self._prefilling()
        if not slots_p:
            return False
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
        ptok = self._landed(self.engine.chunk_slots_paged(
            self.caches, tokens, admit, clens, starts, totals, block_tables=self.bt))
        self._admission_mark = True       # this round carried prefill work
        for i in slots_p:
            self.slots[i].chunk_next += int(clens[i])
            self.stats["prefill_tokens"] += int(clens[i])
            self.stats["prefill_chunks"] += 1
        self.stats["prefill_calls"] += 1
        self.stats["prefill_steps"] += 1
        self.stats["prefill_slot_busy"] += len(slots_p)
        self.stats["prefill_slot_total"] += len(self._pf_slots)
        self._post_chunks(slots_p)
        for i in emits:
            self._complete_prefill(i, int(ptok[i]))
        return True

    def _post_chunks(self, slots_p: List[int]) -> None:
        super()._post_chunks(slots_p)     # the prefill shard's prefix publication
        # eager migration: the completed full blocks start their copy at the
        # chunk boundary that publishes them
        for i in slots_p:
            s = self.slots[i]
            if s.chunk_next < len(s.req.prompt):
                self._enqueue_migration(i)

    def _complete_prefill(self, i: int, tok: int) -> None:
        """Slot i's chunk completed its prompt: record the first token (the
        chunk step sampled it) and stage the handoff."""
        if not 0 <= tok < self.vocab:
            self._quarantine_slot(i, "error", f"poisoned prefill token {tok}")
            return
        s = self.slots[i]
        r = s.req
        s.toks.append(tok)
        if self.on_token is not None:
            self.on_token(r.rid, tok)
        r.stats["ttft_s"] = time.monotonic() - r.submitted_at
        self.stats["emitted"] += 1
        if r.max_new <= 1 or (r.eos_id is not None and tok == r.eos_id):
            # nothing left to decode: it completes off the prefill pool (the
            # retirement releases its blocks and any queued migration)
            self.dones[i] = True
            self.remaining[i] = 0
            s.chunk_next = None
            return
        m = self._mig.get(i)
        if m is None:
            m = self._mig[i] = {"dst": self._pick_decode_shard(), "dst_blocks": [],
                                "sent": 0, "ready_t": None}
        m["ready_t"] = time.monotonic()
        self._handoff_ready.append(i)
        # chunk_next stays at plen: _retire and _prefilling leave the slot
        # alone while its blocks stream out

    # -- the migration pipeline -------------------------------------------
    def _enqueue_migration(self, i: int, final: bool = False) -> None:
        """Queue the copies of slot i's blocks up to its published frontier
        (all of them, the partial tail too, when ``final``).  A decode-side
        prefix hit references the resident block instead of copying; when
        the destination runs dry the youngest decode-pool request is
        preempted once, then the copy is deferred (retried every round)."""
        s = self.slots[i]
        prompt = s.req.prompt
        plen = len(prompt)
        done_toks = plen if s.chunk_next is None else min(s.chunk_next, plen)
        target = -(-plen // self.bs) if final else done_toks // self.bs
        if target == 0:
            return
        m = self._mig.get(i)
        if m is None:
            m = self._mig[i] = {"dst": self._pick_decode_shard(), "dst_blocks": [],
                                "sent": 0, "ready_t": None}
        dshard, src_shard = m["dst"], self._shard_of(i)
        hits: List[int] = []
        if self.prefix_cache:
            hits, _ = self.alloc.match_prefix(prompt, dshard)
        while m["sent"] < target:
            j = m["sent"]
            if j < len(hits):
                # the chain-verified block already lives in the decode pool:
                # hand the reference over, copy nothing
                self.alloc.incref([hits[j]], dshard)
                m["dst_blocks"].append(hits[j])
                self.stats["migration_skipped_blocks"] += 1
            else:
                got = self.alloc.alloc(1, dshard)
                if got is None and self._preempt_youngest(dshard):
                    got = self.alloc.alloc(1, dshard)
                if got is None:
                    self.stats["migration_deferrals"] += 1
                    return
                src_local = self.slot_blocks[i][j]
                self.alloc.begin_migration([src_local], src_shard)
                self._mig_queue.append((i, src_shard, src_local, dshard, got[0]))
                m["dst_blocks"].append(got[0])
            m["sent"] += 1

    def _advance_handoffs(self) -> None:
        """Finish staging the prefill-complete slots: once every block (the
        tail too) is queued or referenced, free the prefill slot (the pins
        keep queued sources alive until their copy runs) and move the
        request to the landing list."""
        for i in list(self._handoff_ready):
            s = self.slots[i]
            try:
                if self.faults:
                    self.faults.on_handoff()
                self._enqueue_migration(i, final=True)
            except MigrationFault as e:
                # failed mid-handoff: roll it all back (queued copies
                # unpinned, destination blocks freed: _release_slot) and
                # quarantine the request; nothing reached the decode pool
                self.stats["migration_faults"] += 1
                self._quarantine_slot(i, "error", str(e))
                continue
            m = self._mig[i]
            if m["sent"] < -(-len(s.req.prompt) // self.bs):
                continue                   # starved for destination blocks; retry
            self._handoff_ready.remove(i)
            m = self._mig.pop(i)
            self._landing.append({"req": s.req, "shard": m["dst"], "blocks": m["dst_blocks"],
                                  "toks": list(s.toks), "ready_t": m["ready_t"]})
            self.stats["handoffs"] += 1
            self._release_slot(i)          # _mig popped: the source blocks free
            self.slots[i] = _Slot()
            self.dones[i] = True
            self.remaining[i] = 0

    def _run_migrations(self) -> None:
        """Land waiting requests into free decode slots and run every queued
        copy in one engine call (global block ids)."""
        if self._pipeline and (self._landing or self._mig_queue):
            self._drain_pipeline()
        land = np.zeros((self.B,), bool)
        totals = np.zeros((self.B,), np.int32)
        landed = []
        for rec in self._landing:
            lo = rec["shard"] * self._spss
            slot = next((j for j in range(lo, lo + self._spss)
                         if self.slots[j].req is None and not land[j]), None)
            if slot is None:
                continue                   # decode pool full; lands later
            r = rec["req"]
            plen = len(r.prompt)
            land[slot] = True
            totals[slot] = plen
            s = _Slot(req=r, admitted_step=self.step_count)
            s.toks = list(rec["toks"])
            self.slots[slot] = s
            self._forced_done[slot] = False
            self.slot_blocks[slot] = list(rec["blocks"])
            self.bt[slot, :] = kvcache.NULL_BLOCK
            self.bt[slot, :len(rec["blocks"])] = rec["blocks"]
            t = int(rec["toks"][-1])
            self.tok[slot] = t
            self.pos[slot] = plen
            self.remaining[slot] = r.max_new - 1
            self.eos[slot] = -1 if r.eos_id is None else r.eos_id
            self.dones[slot] = r.eos_id is not None and t == r.eos_id
            wait = time.monotonic() - rec["ready_t"]
            r.stats["migration_wait_s"] = wait
            self._mig_wait.append(wait)
            if self.prefix_cache:
                self.alloc.register_prefix(r.prompt, rec["blocks"][:plen // self.bs],
                                           rec["shard"])
            landed.append(rec)
        for rec in landed:
            self._landing.remove(rec)
        if not self._mig_queue and not landed:
            return
        per = self.alloc.blocks_per_shard
        src = [sh * per + b for _, sh, b, _, _ in self._mig_queue]
        dst = [sh * per + b for _, _, _, sh, b in self._mig_queue]
        self.engine.migrate_blocks(self.caches, src, dst, land, totals)
        for _, sh, b, _, _ in self._mig_queue:
            self.alloc.end_migration([b], sh)
        n = len(self._mig_queue)
        self._mig_queue.clear()
        self.stats["migrated_blocks"] += n
        self.stats["migration_bytes"] += n * (self._block_bytes or 0)
        self.stats["migration_steps"] += 1
        self._note_usage()

    # -- failure isolation (migration-aware) --------------------------------
    def _finish_landing_record(self, rec: Dict, finish_reason: str,
                               error: Optional[str] = None) -> None:
        """Abort a fully migrated request still waiting for a decode slot:
        free its destination blocks and retire it.  The copy queue must be
        empty first: a queued copy still targets these blocks."""
        assert not self._mig_queue, "landing abort with copies in flight"
        self._landing.remove(rec)
        self.alloc.free(rec["blocks"], rec["shard"])
        r = rec["req"]
        r.output = np.asarray(rec["toks"], np.int32)
        r.finish_reason = finish_reason
        if error is not None:
            r.stats["error"] = error
        r.stats.update({"emitted": len(rec["toks"]), "finished_at": time.monotonic()})
        self.stats["timeouts" if finish_reason == "timeout" else "quarantined"] += 1
        self._note_usage()
        self._finish(r)

    def _abort_stuck_entity(self) -> bool:
        """The livelock breaker's last resort: abort ONE stuck request so
        every other stream keeps its slot: a slot wedged mid-handoff, then a
        landed request with no decode slot (once the copy queue is empty),
        then a mid-prefill slot."""
        victim = False
        if self._handoff_ready:
            self._quarantine_slot(self._handoff_ready[0], "error",
                                  "livelock: migration handoff stuck")
            victim = True
        elif self._landing and not self._mig_queue:
            self._finish_landing_record(self._landing[0], "error",
                                        "livelock: no decode slot ever freed for landing")
            victim = True
        else:
            for i, s in enumerate(self.slots):
                if s.req is not None and s.chunk_next is not None:
                    self._quarantine_slot(i, "error", "livelock: prefill stuck")
                    victim = True
                    break
        if victim:
            self.stats["livelock_aborts"] += 1
        return victim

    def _late_rids(self, now: float) -> set:
        # landed requests waiting for a decode slot hold destination blocks:
        # they time out too, once the copy queue is empty
        late = super()._late_rids(now)
        if self._landing and not self._mig_queue:
            late |= {rec["req"].rid for rec in self._landing if self._late(rec["req"], now)}
        return late

    def _expire_deadlines(self, late: Optional[set] = None) -> None:
        if late is None:
            late = self._late_rids(time.monotonic())
        super()._expire_deadlines(late)
        if not self._landing or self._mig_queue:
            return
        for rec in [rec for rec in self._landing if rec["req"].rid in late]:
            self._finish_landing_record(rec, "timeout")

    # -- the decode pool ---------------------------------------------------
    def _run_decode(self, n: int) -> DecodeBlock:
        # decode runs while other slots are mid-prefill: their rows carry
        # stale positions but real tables, so a frozen row's rewrite must
        # sink into the null block; the ITL sample starts here
        self._last_step_t = time.monotonic()
        active = (~self.dones) & (self.remaining > 0)
        bt = np.where(active[:, None], self.bt, kvcache.NULL_BLOCK).astype(np.int32)
        tok, pos, dones, remaining = self._decode_inputs()
        return self.engine.dispatch_decode(self.caches, tok, pos, dones, remaining, self.eos,
                                           n=n, block_tables=bt, active=active)

    def _run_verify(self, vtok):
        self._last_step_t = time.monotonic()
        return super()._run_verify(vtok)

    # -- reporting ---------------------------------------------------------
    def request_summary(self) -> Dict:
        out = super().request_summary()
        st = self.stats
        pools: Dict = {
            "prefill_shards": len(self._pf_shards), "decode_shards": len(self._dec_shards),
            "prefill_steps": st["prefill_steps"], "decode_steps": st["decode_steps"],
            "prefill_occupancy": (st["prefill_slot_busy"] / st["prefill_slot_total"]
                                  if st["prefill_slot_total"] else 0.0),
            "migrated_blocks": st["migrated_blocks"], "migration_bytes": st["migration_bytes"],
            "migration_skipped_blocks": st["migration_skipped_blocks"],
            "migration_deferrals": st["migration_deferrals"], "handoffs": st["handoffs"],
        }
        w = percentile_summary(self._mig_wait)
        if w is not None:
            pools["migration_wait_s"] = w
        if "decode_itl_s" in out:
            pools["decode_itl_s"] = out["decode_itl_s"]
        out["pools"] = pools
        return out

    # -- main loop ---------------------------------------------------------
    def _serve_round(self) -> bool:
        """One disagg round: retire, admit into the prefill pool, one
        chunk-only step, handoffs, the migrations and landings, then the
        decode pool's block (or verify step); a round with prefill work
        only advances the virtual clock by one step."""
        if self._block_bytes is None:
            self._block_bytes = kvcache.pool_block_bytes(self.caches)
        if not self._round_prologue():
            return False
        if self._pipeline and (self._handoff_ready or self._landing or self._mig_queue):
            self._drain_pipeline()
        self._retire()
        self._admit()
        did_prefill = bool(self._try_step(self._chunk_step))
        self._advance_handoffs()
        self._run_migrations()
        n = self._block_size()
        if n:
            if self.spec_k and not self._spec_suspended():
                self._drain_pipeline()
                self._try_step(self._spec_step)
            elif self.overlap:
                self._try_step(lambda: self._overlap_turn(n))
            else:
                self._try_step(lambda: self._decode_block(n))
        elif did_prefill:
            # a prefill-only round: the virtual arrival clock advances, so
            # arrivals keyed to decode steps stay admissible
            self.step_count += 1
        elif self._pipeline:
            self._land_next()
        busy = any(s.req is not None for s in self.slots)
        if not busy and not self._landing and not self._mig_queue and not self._pipeline:
            pending = [r.arrival_step for r in self.queue]
            if not pending:
                return False
            self.step_count = max(self.step_count, min(pending))
            return True
        # livelock breaker: a whole round without observable progress
        # (deferred migrations against a wedged decode pool) preempts its
        # way out instead of spinning
        sig = (len(self.done), self.stats["emitted"], self.stats["migrated_blocks"],
               self.stats["handoffs"], self.stats["prefill_chunks"], self.stats["decode_steps"],
               len(self.queue), len(self._landing))
        if sig == self._stall_sig:
            self._stall += 1
            if self._stall > 4 * self.B + 16:
                self._drain_pipeline()
                if not any(self._preempt_youngest(sh)
                           for sh in (*self._dec_shards, *self._pf_shards)):
                    # nothing to preempt either: abort ONE stuck request
                    if not self._abort_stuck_entity():
                        raise RuntimeError("disagg scheduler stalled: no progress and "
                                           "nothing to preempt or abort")
                self._stall = 0
        else:
            self._stall, self._stall_sig = 0, sig
        return True
