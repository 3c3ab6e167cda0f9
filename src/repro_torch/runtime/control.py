"""One controller a world: the serving control plane's round record.

Over a world of ranks (tensor parallelism, the data axis) every rank runs
its own scheduler over the same requests, in lockstep: its decisions read
the requests, the sampled tokens and the virtual decode-step clock, which
are the same on every rank.  A decision read off the wall clock would part
the ranks, and so would a request that reached one rank only.  So world
rank 0 makes every such decision once and, at the head of each serving
round, broadcasts a ``RoundRecord`` that every rank (rank 0 too) applies
before it retires and admits:

* ``expired``: the rids whose deadline passed on rank 0's clock;
* ``itl``: rank 0's recent landed inter-token latency, the degradation
  ladder's wall-clock signal (queue depth reads the virtual clock);
* ``submits``: the requests the HTTP frontend accepted on rank 0 since the
  last round, with the rid, the arrival step and the deadline rank 0 gave
  them;
* ``door_shed``: the classes of the requests the frontend shed at its door
  (HTTP 429) since the last round, which every rank counts;
* ``stop``: the frontend drained; the followers leave their loop.

The record is a small host byte string (JSON), broadcast over a gloo group
of the whole world (``core/collectives.control_broadcast``, tag
``control``), so host metadata never rides NCCL on a card.  A world of one
rank makes no record.  The JAX package needs none: one controller decides
for every device of its mesh.
"""
from __future__ import annotations

import json
import math
import threading
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

from repro_torch.core import collectives as cc
from repro_torch.models.common import Dist


@dataclass
class RoundRecord:
    expired: List[int] = field(default_factory=list)
    itl: Optional[float] = None
    submits: List[Dict] = field(default_factory=list)
    door_shed: List[str] = field(default_factory=list)
    stop: bool = False

    def encode(self) -> bytes:
        d = asdict(self)
        d["itl"] = None if self.itl is None or math.isnan(self.itl) else self.itl
        return json.dumps(d, separators=(",", ":")).encode()

    @classmethod
    def decode(cls, data: bytes) -> "RoundRecord":
        return cls(**json.loads(data.decode()))


class ControlChannel:
    """A scheduler's end of the round records in a world of more than one
    rank.  On world rank 0 (``controller``) it gathers what the frontend's
    threads announce between rounds (under a lock: door sheds arrive on
    the event loop's thread) and sends it with the round's decisions; on
    every other rank it receives."""

    def __init__(self, dist: Dist):
        self.dist = dist
        self.controller = dist.world_rank == 0
        self._lock = threading.Lock()
        self._submits: List[Dict] = []
        self._door_shed: List[str] = []

    def announce_submit(self, rid: int, prompt, max_new: int, eos_id: Optional[int],
                        arrival_step: int, deadline_s: Optional[float], priority: str) -> None:
        with self._lock:
            self._submits.append({"rid": rid, "prompt": prompt.tolist(), "max_new": max_new,
                                  "eos_id": eos_id, "arrival_step": arrival_step,
                                  "deadline_s": deadline_s, "priority": priority})

    def announce_door_shed(self, priority: str) -> None:
        with self._lock:
            self._door_shed.append(priority)

    def exchange(self, expired=(), itl: Optional[float] = None,
                 stop: bool = False) -> RoundRecord:
        """The round's record: built from the arguments and the
        announcements on rank 0, received everywhere else."""
        if not self.controller:
            return RoundRecord.decode(cc.control_broadcast(None, self.dist))
        with self._lock:
            rec = RoundRecord(expired=sorted(int(r) for r in expired), itl=itl,
                              submits=self._submits, door_shed=self._door_shed, stop=stop)
            self._submits, self._door_shed = [], []
        cc.control_broadcast(rec.encode(), self.dist)
        return rec
