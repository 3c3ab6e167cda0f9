"""What each rank of tests/test_torch_control_ranks.py and
tests/test_torch_control_ranks_serve.py runs: the port's serving control
plane over a world of gloo ranks on the CPU (torch, numpy and repro_torch
only, so the spawned rank processes import no jax).  Every function here
takes (dist, device, ...) as ``launch.mesh.spawn`` calls it and returns
plain data.

A case is a dict: the scheduler ``kind`` ("dense", "paged", "disagg"), its
keyword arguments ``sched``, the engine's ``parallel`` keywords, the
requests ``reqs`` as (prompt, max_new, eos_id, arrival_step, priority,
deadline_s), and optionally ``levels`` (record the ladder's level after
every round), ``skew`` (the world rank whose ``time.monotonic`` runs
``SKEW`` times fast for the run: a follower that read its own clock for a
decision would part from the others) and ``axis`` ("model": the replica's
tp ranks as a world of their own; "data": the data group at tp 1;
"world": the whole dp x tp world)."""
import asyncio
import http.client
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import collectives as cc
from repro_torch.launch.frontend import EngineService, HttpFrontend, follow
from repro_torch.models.common import Dist
from repro_torch.runtime.scheduler import (ContinuousScheduler, DisaggScheduler,
                                           PagedContinuousScheduler)
from torch_dp_ranks import engine, tp1

MAX_LEN = 64
SKEW = 1000.0
KINDS = {"dense": ContinuousScheduler, "paged": PagedContinuousScheduler,
         "disagg": DisaggScheduler}


def model_world(dist: Dist) -> Dist:
    """This rank's replica as a world of ``dist.tp`` ranks at dp 1."""
    return Dist(tp=dist.tp, rank=dist.rank, group=dist.group, backend=dist.backend,
                control=dist.group)


def axis_world(dist: Dist, axis: str) -> Dist:
    return {"model": model_world, "data": tp1, "world": lambda d: d}[axis](dist)


class fast_clock:
    """``time.monotonic`` in this process runs ``SKEW`` times fast inside
    the context (from the moment it is entered)."""

    def __enter__(self):
        self.real = time.monotonic
        t0 = self.real()
        time.monotonic = lambda: t0 + (self.real() - t0) * SKEW
        return self

    def __exit__(self, *exc):
        time.monotonic = self.real


def run_case(dist: Dist, device, cfg, tree, case) -> dict:
    """One scheduler run of ``case`` on world ``dist`` -> its streams
    (rid -> (tokens, finish_reason)), (rid, token) emission trace, retire
    order, counters, ladder levels and transitions, the control records
    broadcast and the rounds served."""
    eng = engine(dist, device, cfg, tree, case.get("parallel", {}), MAX_LEN)
    sched = KINDS[case["kind"]](eng, **case["sched"])
    events = []
    sched.on_token = lambda rid, t: events.append((rid, int(t)))
    for p, mn, eos, arr, cls, dl in case["reqs"]:
        sched.submit(np.asarray(p, np.int32), mn, eos_id=eos, arrival_step=arr, priority=cls,
                     deadline_s=dl)
    levels, rounds = [], 0
    skewed = case.get("skew") == dist.world_rank
    with cc.comm_stats() as st:
        clock = fast_clock() if skewed else None
        if clock is not None:
            clock.__enter__()
        try:
            while sched.serve_step():
                rounds += 1
                levels.append(sched.overload_level())
            done = sched.run()        # drains, retires and checks every rank alike
        finally:
            if clock is not None:
                clock.__exit__()
    ctl = sched.overload_ctl
    control = st.by_tag().get("control (broadcast)", {"count": 0, "bytes": 0})
    return {"streams": {r.rid: (r.output.tolist(), r.finish_reason) for r in done},
            "events": events, "order": [r.rid for r in done],
            "stats": {k: v for k, v in sched.stats.items() if not isinstance(v, dict)},
            "classes": sched.stats["classes"], "counters": sched.control_counters(),
            "levels": levels, "transitions": None if ctl is None else list(ctl.transitions),
            # rounds served: the serve_step calls (the last one idle) and the
            # idle round with which run() ends
            "control": control, "rounds": rounds + 2, "skewed": skewed,
            "world_rank": dist.world_rank}


def run_cases(dist: Dist, device, cfg, tree, stages) -> dict:
    """``stages``: a list of {name: case}; within a stage the cases whose
    worlds do not overlap run at the same time (each on the ranks of its
    axis that hold it: ``case["on"]`` names the replica (model axis) or
    model rank (data axis) that runs it); -> {name: this rank's run}."""
    torch.set_num_threads(1)
    out = {}
    for stage in stages:
        for name, case in stage.items():
            axis = case.get("axis", "world")
            mine = (axis == "world"
                    or (axis == "model" and case.get("on", 0) == dist.data_rank)
                    or (axis == "data" and case.get("on", 0) == dist.rank))
            if mine:
                run = frontend_case if case["kind"] == "frontend" else run_case
                out[name] = run(axis_world(dist, axis), device, cfg, tree, case)
    return out


# -- the HTTP frontend over a world of ranks -------------------------------------


def _post(port, body, timeout=120):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, dict(r.getheaders()), r.read()


def _sse(raw: bytes) -> list:
    toks = []
    for ev in raw.decode().split("\n\n"):
        if ev.startswith("data: {"):
            toks += json.loads(ev[6:])["choices"][0].get("token_ids", [])
    return toks


def frontend_case(dist: Dist, device, cfg, tree, case) -> dict:
    """tests/test_torch_control_ranks_serve.py's frontend at the world
    ``dist``: first the blocking loop over ``case["prompts"]`` (the
    reference), then the HTTP frontend over the overlapped continuous
    scheduler (with ``case["sched"]``'s keywords: a fault plan, the
    ladder), world rank 0 serving on 127.0.0.1 and its own client
    threads posting: 4 concurrent SSE streams (``max_pending`` 4), then 6
    concurrent requests against ``max_pending`` 2, and a stream in flight when the drain
    begins.  Every other rank follows the round records until the stop
    record; -> the reference, what the clients got, and each rank's
    streams and counters."""
    eng = engine(dist, device, cfg, tree, {}, MAX_LEN)
    ref_sched = ContinuousScheduler(eng, n_slots=2, block_steps=2)
    for p in case["prompts"]:
        ref_sched.submit(np.asarray(p, np.int32), case["max_new"])
    ref = {r.rid: r.output.tolist() for r in ref_sched.run()}
    sched = ContinuousScheduler(eng, n_slots=2, block_steps=2, overlap=True,
                                **case.get("sched", {}))
    out = {"world_rank": dist.world_rank, "ref": ref}

    def served():
        return {"counters": sched.control_counters(), "done": len(sched.done),
                "streams": {r.rid: (r.output.tolist(), r.finish_reason) for r in sched.done}}

    if dist.world_rank != 0:
        follow(sched)
        out.update(served())
        return out
    service = EngineService(sched, max_pending=len(case["prompts"]), idle_wait_s=0.002)
    frontend = HttpFrontend(service, port=0)
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=lambda: (asyncio.set_event_loop(loop),
                                              loop.run_until_complete(frontend.start()),
                                              loop.run_forever()), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while frontend._server is None:
        assert time.monotonic() < deadline, "the frontend did not start"
        time.sleep(0.01)
    port = frontend.port
    n, mn = len(case["prompts"]), case["max_new"]
    with ThreadPoolExecutor(6) as pool:
        streamed = list(pool.map(lambda p: _post(port, {"prompt": p, "max_tokens": mn,
                                                        "stream": True}), case["prompts"]))
        service.max_pending = 2
        overload = list(pool.map(lambda p: _post(port, {"prompt": p, "max_tokens": 8}),
                                 case["overload_prompts"]))
        fut = pool.submit(_post, port, {"prompt": case["prompts"][0], "max_tokens": mn,
                                        "stream": True})
        time.sleep(0.3)           # in flight when the drain begins
        asyncio.run_coroutine_threadsafe(frontend.stop(), loop).result(timeout=120)
        drained = fut.result(timeout=120)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)
    loop.close()
    try:
        _post(port, {"prompt": [1, 2], "max_tokens": 1}, timeout=5)
        listening = True
    except OSError:
        listening = False
    out.update(streamed=[(st, _sse(raw)) for st, _, raw in streamed[:n]],
               overload=[(st, h.get("Retry-After"),
                          json.loads(data)["choices"][0]["token_ids"] if st == 200 else None)
                         for st, h, data in overload],
               drained=(drained[0], _sse(drained[2])), listening=listening,
               shed_requests=sched.stats["shed_requests"], **served())
    return out
