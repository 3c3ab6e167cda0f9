"""Deterministic fault injection for the serving runtime (the port's copy
of ``repro.runtime.faults``, which it may not import).

A :class:`FaultPlan` is parsed from a compact spec string (kept as a plain
``str`` so it can ride on the frozen ``ParallelConfig`` and the
``--fault-plan`` CLI flag) and consulted by the schedulers at the host
boundaries where failures are recoverable:

* **pre-dispatch** (``on_dispatch``, through ``Engine.dispatch_hook``) --
  before an engine step launches anything.  The port updates its caches in
  place, so once a step has launched a kernel the host cannot replay it; a
  failure *before* the first launch leaves the exact pre-step state intact,
  which is what makes bounded retry sound.
* **token landing** (``corrupt_tokens``) -- after a block of sampled tokens
  reaches the host.  "Non-finite logits on slot i" is modeled as the
  out-of-range id such logits sample to; the schedulers' range guard
  (0 <= t < vocab) is the detector either way.  Device math is never
  altered, so surviving slots' streams are bit-identical to an uninjected
  run.
* **allocation** (``deny_alloc``) -- the paged allocator's grow path reports
  exhaustion whatever the pool holds.
* **handoff staging** (``on_handoff``) -- the disaggregated scheduler's
  final handoff of a prefilled request's blocks to the decode pool
  (``DisaggScheduler._advance_handoffs``): a ``MigrationFault`` there
  rolls the whole handoff back and quarantines the request.

Over a world of ranks (tensor parallelism, the data axis) every rank runs
its own scheduler and its own copy of the plan over the same schedule.
Every clause fires from the engine-step count, the handoff count and the
plan's seeded rng only, so each fires at the same point on every rank: a
step fault raises on every rank before any of them launches the step, so
every rank retries (or quarantines) the same step, and no collective of
the step is left half issued.  ``delay`` fires on every rank alike (its
rng draw too) but sleeps on world rank 0 only (``sleeps``): the ranks
wait for it in the next collective, as a wedged controller would hold
them.  What no plan models is an organic exception raised on one rank
only (an out-of-memory error, a failed kernel launch): that rank's
scheduler parts from the others', which then wait in a collective until
the process group's timeout; recovering from it is out of scope.

Spec grammar — clauses separated by ``;``, each ``kind:key=val,key=val``::

    step:at=N[,times=M][,slot=I][,p=F]   transient exception at the first
                                         engine dispatch with step >= N;
                                         fires M times (default 1) then
                                         disarms.  slot= attributes blame
                                         (escalates to quarantine when
                                         retries exhaust); p= makes each
                                         opportunity fire with probability
                                         F from the plan's seeded rng.
    poison:slot=I,at=N[,times=M]         corrupt slot I's landed token at
                                         the first step >= N where slot I
                                         is actively decoding (out-of-range
                                         id; defers while the slot is
                                         empty/frozen).
    alloc:at=N[,times=M]                 deny the next M block allocations
                                         once step >= N.
    migrate:handoff=K[,times=M]          raise MigrationFault at the K-th
                                         (0-based) final handoff staging.
    delay:at=N,s=F[,times=M]             sleep F seconds before the first
                                         dispatch with step >= N (drives
                                         the liveness watchdog).
    burst:at=N,count=K[,plen=P][,new=M]  inject K synthetic requests
         [,cls=C][,times=T][,every=E]    (prompt length P, default 8;
                                         decode budget M, default 4;
                                         priority class C, default
                                         "standard") at the first serving
                                         round with step >= N.  times=T
                                         refires the burst T times,
                                         every=E spacing refires E steps
                                         apart — a deterministic overload
                                         wave for degradation tests.
                                         Prompts come from an rng seeded
                                         by the firing step, so two runs
                                         of the same plan inject
                                         identical traffic.
    seed:n=K                             seed for probabilistic clauses
                                         (default 0; the plan is fully
                                         deterministic either way).

Example: ``step:at=12,times=2;poison:slot=1,at=20;migrate:handoff=0``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# An id no real vocab reaches: what NaN/Inf logits "sample" to.  The
# schedulers detect any id outside [0, vocab) — injected or organic.
POISON_TOKEN = 1 << 30


class InjectedFault(Exception):
    """Base class for all faults raised by a FaultPlan."""


class TransientStepError(InjectedFault):
    """A step dispatch failed before the program consumed any state.

    ``slot`` optionally attributes the failure to one request (e.g. its
    input triggers the crash): when bounded retries exhaust, the scheduler
    quarantines that slot instead of dying."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot


class MigrationFault(InjectedFault):
    """A KV-block handoff failed mid-staging (disagg prefill->decode)."""


@dataclass
class _Clause:
    kind: str                     # step|poison|alloc|migrate|delay|burst
    at: int = 0                   # engine-step threshold
    times: int = 1                # remaining fires (counts down to 0)
    slot: Optional[int] = None    # blamed/targeted slot
    handoff: int = 0              # migrate: 0-based handoff index
    seconds: float = 0.0          # delay: sleep duration
    p: float = 1.0                # per-opportunity fire probability
    count: int = 0                # burst: requests injected per fire
    plen: int = 8                 # burst: synthetic prompt length
    new: int = 4                  # burst: per-request decode budget
    cls: str = "standard"         # burst: priority class of injected load
    every: int = 0                # burst: step spacing between refires
    fired: int = 0                # burst: fires consumed so far


_KINDS = ("step", "poison", "alloc", "migrate", "delay", "burst", "seed")
_INT_KEYS = ("at", "times", "slot", "handoff", "n", "count", "plen",
             "new", "every")
_FLOAT_KEYS = ("s", "p")
_STR_KEYS = ("cls",)


class FaultPlan:
    """Parsed fault schedule; one instance per scheduler (stateful: clauses
    disarm as they fire, so a plan must not be shared across runs)."""

    def __init__(self, clauses: List[_Clause], seed: int = 0):
        self.clauses = clauses
        self._rng = random.Random(seed)
        self._handoffs = 0        # final handoff stagings observed
        # whether a firing delay clause sleeps: on world rank 0 only (the
        # scheduler clears it on the other ranks)
        self.sleeps = True

    def __bool__(self) -> bool:
        return bool(self.clauses)

    @classmethod
    def parse(cls, spec: Optional[str]) -> "FaultPlan":
        clauses: List[_Clause] = []
        seed = 0
        for part in (spec or "").split(";"):
            part = part.strip()
            if not part:
                continue
            kind, _, rest = part.partition(":")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in {part!r}")
            kw = {}
            for item in rest.split(","):
                item = item.strip()
                if not item:
                    continue
                k, _, v = item.partition("=")
                k = k.strip()
                if k in _INT_KEYS:
                    kw[k] = int(v)
                elif k in _FLOAT_KEYS:
                    kw[k] = float(v)
                elif k in _STR_KEYS:
                    kw[k] = v.strip()
                else:
                    raise ValueError(f"unknown fault key {k!r} in {part!r}")
            if kind == "seed":
                seed = kw.get("n", 0)
                continue
            c = _Clause(kind=kind, at=kw.get("at", 0),
                        times=kw.get("times", 1), slot=kw.get("slot"),
                        handoff=kw.get("handoff", 0),
                        seconds=kw.get("s", 0.0), p=kw.get("p", 1.0),
                        count=kw.get("count", 0), plen=kw.get("plen", 8),
                        new=kw.get("new", 4), cls=kw.get("cls", "standard"),
                        every=kw.get("every", 0))
            if kind == "poison" and c.slot is None:
                raise ValueError(f"poison clause needs slot= in {part!r}")
            if kind == "burst" and c.count <= 0:
                raise ValueError(f"burst clause needs count= in {part!r}")
            clauses.append(c)
        return cls(clauses, seed=seed)

    # -- firing logic ------------------------------------------------------
    def _fire(self, c: _Clause) -> bool:
        if c.times <= 0:
            return False
        if c.p < 1.0 and self._rng.random() >= c.p:
            return False
        c.times -= 1
        return True

    def on_dispatch(self, step: int) -> None:
        """Consulted before every engine step dispatch.  Delay clauses
        sleep (where ``sleeps``); step clauses raise
        :class:`TransientStepError`."""
        for c in self.clauses:
            if c.kind == "delay" and step >= c.at and self._fire(c) and self.sleeps:
                time.sleep(c.seconds)
        for c in self.clauses:
            if c.kind == "step" and step >= c.at and self._fire(c):
                raise TransientStepError(
                    f"injected step fault (at={c.at}, step={step})",
                    slot=c.slot)

    def corrupt_tokens(self, toks, base_step: int, active=None):
        """Apply poison clauses to a landed (n, B) token block covering
        engine steps [base_step, base_step + n).  Copy-on-write: the input
        (np.asarray of a device array) may be a read-only view, so the
        first firing clause takes a host-owned copy.

        ``active`` is the caller's slot-is-decoding mask at the block's
        start.  A clause whose target slot is empty/frozen there DEFERS
        (does not consume ``times``) — "poison slot I at step N" means the
        first block at/after N where slot I's stream would actually read
        the corrupted cell, not a silent no-op on whatever block happened
        to cover N while the slot sat idle."""
        out = toks
        n = toks.shape[0]
        for c in self.clauses:
            if c.kind != "poison" or c.times <= 0:
                continue
            if c.at >= base_step + n:
                continue              # this block ends before the target
            if active is not None and (c.slot >= len(active)
                                       or not active[c.slot]):
                continue              # slot not live yet: wait, don't spend
            if self._fire(c):
                if out is toks:
                    out = np.array(toks)
                out[max(0, c.at - base_step), c.slot] = POISON_TOKEN
        return out

    def burst(self, step: int) -> List[tuple]:
        """Consulted at each serving-round start; returns a list of
        ``(count, plen, max_new, cls, fire_step)`` burst specs due now.

        A clause's i-th fire (0-based) is due once ``step >= at + i *
        every``; ``times`` bounds total fires.  ``fire_step`` is the step
        the fire was *scheduled* for (not the observed step), so prompt
        synthesis seeded by it is identical run-to-run even if rounds
        land on slightly different step indices."""
        due = []
        for c in self.clauses:
            if c.kind != "burst":
                continue
            while c.times > 0 and step >= c.at + c.fired * max(0, c.every):
                due.append((c.count, max(2, c.plen), max(1, c.new),
                            c.cls, c.at + c.fired * max(0, c.every)))
                c.fired += 1
                c.times -= 1
        return due

    def deny_alloc(self, step: int) -> bool:
        """True when an allocation at ``step`` should report exhaustion."""
        for c in self.clauses:
            if c.kind == "alloc" and step >= c.at and self._fire(c):
                return True
        return False

    def on_handoff(self) -> None:
        """Consulted at each FINAL handoff staging (disagg); raises
        :class:`MigrationFault` for the matching 0-based handoff index."""
        k = self._handoffs
        self._handoffs += 1
        for c in self.clauses:
            if c.kind == "migrate" and k >= c.handoff and self._fire(c):
                raise MigrationFault(
                    f"injected migration fault (handoff #{k})")

    def on_quarantine(self, slot: int) -> None:
        """Disarm every clause attributed/targeted at ``slot`` — once the
        request is quarantined, its poisoned input is out of the system and
        the failures it caused stop."""
        for c in self.clauses:
            if c.slot == slot:
                c.times = 0
