"""Adaptive graceful-degradation controller for sustained overload (the
port's copy of ``repro.runtime.overload``, which it may not import).

The serving schedulers already *survive* short bursts: the frontend sheds
at ``max_pending``, paged pools preempt-to-requeue, deadlines expire.
What none of that handles is demand that stays above capacity for many
rounds — queues grow without bound and every class's latency collapses
together.  :class:`OverloadController` closes that gap with a small,
fully documented ladder of degradation levers, applied and released with
hysteresis so the system neither flaps nor stays degraded after the
burst passes.

Ladder (level 0 is normal operation; each level keeps the levers of the
levels below it):

=====  ================  =================================================
level  name              lever
=====  ================  =================================================
0      normal            —
1      shed-batch        ``batch``-class requests are shed at admission
                         (scheduler) and at submission (frontend) instead
                         of queueing behind latency classes.
2      spec-off          speculative decoding is suspended.  Greedy spec
                         decode is token-identical to plain decode, so
                         this trades per-request speed for a smaller
                         fused-step footprint without changing any
                         stream.
3      tight-admission   the admission window shrinks to one new request
                         per round (and at most one mid-prefill slot
                         under chunked prefill), keeping decode cadence
                         for already-admitted work instead of paying wide
                         prefill chunks at the worst moment.
=====  ================  =================================================

Signals, observed once per serving round (``observe``):

* **queue depth** — requests that have arrived (``arrival_step <=
  step_count``) but hold no slot.  Deterministic under the virtual
  decode-step clock, which is what makes degradation testable.
* **recent landed ITL** — mean of the last ``window`` per-step
  inter-token latencies, compared against the interactive-class SLO
  scaled by ``itl_hi``/``itl_lo``.  Only consulted when an interactive
  SLO target is configured (wall-clock signals are advisory; queue depth
  is the primary, reproducible signal).

Hysteresis: the controller escalates one level only after ``patience``
consecutive pressured rounds, and restores one level only after
``cooldown`` consecutive clear rounds; rounds in the dead band between
the lo and hi thresholds reset both streaks (hold the current level).
Every transition is recorded and surfaced through ``summary()`` —
wired into ``request_summary()["overload"]`` and ``GET /health``.

Over a world of ranks every rank's scheduler keeps its own controller and
feeds it the same signals: the queue depth of its own lockstep queue and
the ITL that world rank 0 measured and broadcast in the round record
(``runtime/control.py``), so every rank makes the same transitions at the
same rounds.

None of the levers ever touches device math or sampled tokens: admitted
survivors' greedy streams stay bit-identical to an unloaded run.
Degradation changes *which* requests run and *when* — never *what*.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

LADDER = ("normal", "shed-batch", "spec-off", "tight-admission")
MAX_LEVEL = len(LADDER) - 1


class OverloadController:
    """Hysteresis ladder walker; one instance per scheduler."""

    def __init__(self,
                 queue_hi: int,
                 queue_lo: int,
                 slo_s: float = 0.0,
                 itl_hi: float = 1.5,
                 itl_lo: float = 1.0,
                 patience: int = 3,
                 cooldown: int = 6,
                 window: int = 32):
        if queue_lo > queue_hi:
            raise ValueError("overload queue_lo must be <= queue_hi")
        self.queue_hi = int(queue_hi)
        self.queue_lo = int(queue_lo)
        self.slo_s = float(slo_s)
        self.itl_hi = float(itl_hi)
        self.itl_lo = float(itl_lo)
        self.patience = max(1, int(patience))
        self.cooldown = max(1, int(cooldown))
        self.window = max(1, int(window))
        self.level = 0
        self.max_level_seen = 0
        self._hot = 0             # consecutive pressured rounds
        self._cool = 0            # consecutive clear rounds
        self._round = 0
        self.escalations = 0
        self.restorations = 0
        self.rounds_at_level = [0] * len(LADDER)
        # (round, from_level, to_level) — every ladder transition, in order
        self.transitions: List[Tuple[int, int, int]] = []

    # -- signal evaluation -------------------------------------------------
    def _pressured(self, depth: int, itl: Optional[float]) -> bool:
        if depth >= self.queue_hi:
            return True
        return (self.slo_s > 0.0 and itl is not None
                and itl > self.itl_hi * self.slo_s)

    def _clear(self, depth: int, itl: Optional[float]) -> bool:
        if depth > self.queue_lo:
            return False
        return (self.slo_s <= 0.0 or itl is None
                or itl <= self.itl_lo * self.slo_s)

    def observe(self, depth: int, itl: Optional[float] = None) -> int:
        """Feed one round's signals; returns the (possibly new) level."""
        self._round += 1
        self.rounds_at_level[self.level] += 1
        if self._pressured(depth, itl):
            self._hot += 1
            self._cool = 0
            if self._hot >= self.patience and self.level < MAX_LEVEL:
                self._shift(self.level + 1)
                self.escalations += 1
                self._hot = 0
        elif self._clear(depth, itl):
            self._cool += 1
            self._hot = 0
            if self._cool >= self.cooldown and self.level > 0:
                self._shift(self.level - 1)
                self.restorations += 1
                self._cool = 0
        else:
            # dead band: hold the level, reset both streaks
            self._hot = 0
            self._cool = 0
        return self.level

    def _shift(self, to: int) -> None:
        self.transitions.append((self._round, self.level, to))
        self.level = to
        self.max_level_seen = max(self.max_level_seen, to)

    # -- levers (read by the schedulers each round) ------------------------
    @property
    def shed_classes(self) -> Tuple[str, ...]:
        return ("batch",) if self.level >= 1 else ()

    @property
    def spec_off(self) -> bool:
        return self.level >= 2

    @property
    def admission_cap(self) -> Optional[int]:
        """Max new admissions per round (None = unlimited)."""
        return 1 if self.level >= 3 else None

    # -- reporting ---------------------------------------------------------
    def summary(self) -> dict:
        return {
            "level": self.level,
            "level_name": LADDER[self.level],
            "max_level": self.max_level_seen,
            "max_level_name": LADDER[self.max_level_seen],
            "escalations": self.escalations,
            "restorations": self.restorations,
            "transitions": len(self.transitions),
            "rounds_at_level": list(self.rounds_at_level),
            "shed_classes": list(self.shed_classes),
            "spec_off": self.spec_off,
            "admission_cap": self.admission_cap or 0,
        }
