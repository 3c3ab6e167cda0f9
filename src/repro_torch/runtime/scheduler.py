"""Request scheduling over the engine: ``Request`` and the drain-and-restart
``WaveScheduler`` of ``repro.runtime.scheduler``.

A wave takes up to ``batch_size`` queued requests, right-pads their prompts
to the longest one, runs one prefill and decodes every row to the wave's
largest ``max_new``; each request then keeps its own ``max_new`` tokens, cut
after its EOS.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.runtime.engine import Engine


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,)
    max_new: int
    eos_id: Optional[int] = None
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

    def submit(self, prompt: np.ndarray, max_new: int, eos_id: Optional[int] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, np.asarray(prompt), max_new, eos_id))
        return rid

    def run(self) -> List[Request]:
        """Drain the queue; returns completed requests in completion order."""
        while self.queue:
            wave, self.queue = self.queue[:self.batch_size], self.queue[self.batch_size:]
            self._run_wave(wave)
        return self.done

    def _run_wave(self, wave: List[Request]) -> None:
        plen = max(len(r.prompt) for r in wave)
        max_new = max(r.max_new for r in wave)
        prompts = np.full((len(wave), plen), self.pad_id, dtype=np.int32)
        for i, r in enumerate(wave):
            # left-aligned; short prompts are right-padded (positions aligned)
            prompts[i, :len(r.prompt)] = r.prompt
        t0 = time.monotonic()
        out = self.engine.generate(prompts, max_new)       # (b, max_new)
        dt = time.monotonic() - t0
        cut = []
        for i, r in enumerate(wave):
            toks = out[i, :r.max_new]
            if r.eos_id is not None:
                hits = np.nonzero(toks == r.eos_id)[0]
                if hits.size:
                    toks = toks[:hits[0] + 1]
            cut.append(toks)
        # throughput from tokens actually delivered (EOS-cut, per-request
        # max_new), not the padded wave the step loop ran
        emitted = sum(len(t) for t in cut)
        for r, toks in zip(wave, cut):
            r.output = toks
            r.finish_reason = ("stop" if r.eos_id is not None and len(toks)
                               and toks[-1] == r.eos_id else "length")
            r.stats = {
                "wave_batch": len(wave),
                "queue_s": t0 - r.submitted_at,
                "wave_s": dt,
                "emitted": len(toks),
                "tok_per_s": emitted / dt if dt > 0 else float("inf"),
            }
            self.done.append(r)
