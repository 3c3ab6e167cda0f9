"""The serving control plane across ranks: the overlapped loop, fault plans
and deadlines at tp 2, at dp 2 and at dp 2 x tp 2, against the same
world's blocking loop and the JAX package's schedulers at tp=1.

Reduced yi-9b on the JAX package's weights bridged bit for bit
(tests/torch_control_plane.py), greedy, over gloo ranks on the CPU: one
spawn of four ranks (tests/torch_control_ranks.py) runs the tp 2 cases on
its two replicas at once, then the dp 2 cases on its two data groups at
once, then the dp 2 x tp 2 cases on the whole world, while the JAX
references serve in a thread beside them.

* overlap: the overlapped loop's streams, retire order and (rid, token)
  emission trace equal the blocking loop's at the same world bit for bit,
  EOS rollbacks included, and the JAX overlapped scheduler's (streams up to
  a certified near-tie; the order and trace where no stream parted); at
  dp > 1 the next block is dispatched on the replica's own device state
  and the world's tokens gathered at the landing;
* faults: a plan of step faults, a poisoned slot and an allocation denial
  on the paged overlapped loop quarantines the JAX package's request with
  its retry counts, every survivor's stream the clean run's at the same
  world;
* deadlines with one follower's clock running fast: every rank retires
  exactly world rank 0's timeouts (a queued one, a slot-resident one cut
  mid-stream after rank 0's ``delay`` clause), the streams and counters
  agree on every rank (``Engine.check_replicated``), and every round of a
  world of ranks makes one record, one length and one payload broadcast
  (tag ``control``), and none at tp = dp = 1.
"""
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_control_ranks
from repro.configs import get_config as jget_config
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core import collectives as cc
from repro_torch.launch import mesh
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import ContinuousScheduler
from test_torch_model import jax_engine
from test_torch_tp import _torch_tree
from torch_control_plane import MAX_LEN, assert_same_streams, poisson_requests, run_sched

SLOTS = dict(n_slots=4, block_steps=2)
PAGED = dict(SLOTS, block_size=8)
PLAN = "step:at=4,times=2;poison:slot=1,at=8;alloc:at=12"
FAULT_COUNTS = ("step_faults", "step_retries", "quarantined", "preemptions")
WORLDS = ("tp2", "dp2", "dp2xtp2")
AXIS = {"tp2": "model", "dp2": "data", "dp2xtp2": "world"}


def _req(p, mn, eos=None, arr=0, cls="standard", dl=None):
    return (np.asarray(p, np.int32), mn, eos, arr, cls, dl)


def fault_requests(vocab, n=6):
    """EOS-free requests with max_new >= 8 (tests/test_torch_faults.py's
    workload, six of them for four slots)."""
    rng = np.random.default_rng(3)
    return [_req(rng.integers(0, vocab, int(rng.integers(4, 12))), 8 + i % 3, arr=2 * (i // 3))
            for i in range(n)]


def deadline_requests(vocab):
    """rid 0 and 3 expire queued (a deadline already past), rid 1 in its
    slot after rank 0's delay clause, rid 2 has 100 s (gone after 0.1 s on
    a clock running SKEW times fast), rid 4 none."""
    rng = np.random.default_rng(12)
    p = [rng.integers(0, vocab, 6) for _ in range(5)]
    return [_req(p[0], 6, dl=1e-6), _req(p[1], 14, dl=0.4), _req(p[2], 10, dl=100.0),
            _req(p[3], 6, arr=4, dl=1e-6), _req(p[4], 10, arr=2)]


def _overlap_workloads(teng):
    """The dense workload ends streams at an EOS the prediction cannot see
    (tests/test_torch_overlap.py's rollback case, four rows), the paged one
    is tests/test_async.py's seeded Poisson arrivals."""
    vocab = teng.cfg.vocab_size
    reqs = poisson_requests(vocab, n=4, seed=6, lam=0.0, max_new=(12, 16))
    probe = run_sched(ContinuousScheduler(teng, **SLOTS), reqs)[0]
    toks = np.concatenate([r.output[4:-2].ravel() for r in probe.values()])
    eos_id = int(np.bincount(toks).argmax())
    dense = [_req(p, mn, eos_id, arr) for p, mn, _, arr in reqs]
    paged = [_req(p, mn, eos, arr) for p, mn, eos, arr in poisson_requests(vocab, n=8, seed=2)]
    return {"dense": dense, "paged": paged}


def _stages(teng):
    vocab = teng.cfg.vocab_size
    work = _overlap_workloads(teng)
    faults = fault_requests(vocab)
    dl = deadline_requests(vocab)
    stages = []
    for world in WORLDS:
        stage = {}
        axis = AXIS[world]
        for kind, reqs in work.items():
            sched = PAGED if kind == "paged" else SLOTS
            for overlap in (False, True):
                stage[f"{world} {kind} {'overlapped' if overlap else 'blocking'}"] = dict(
                    kind=kind, sched=dict(sched, overlap=overlap), reqs=reqs, axis=axis, on=0)
        other = 1 if axis != "world" else 0
        stage[f"{world} faults clean"] = dict(kind="paged", sched=dict(PAGED, overlap=True),
                                              reqs=faults, axis=axis, on=other)
        stage[f"{world} faults"] = dict(kind="paged", reqs=faults, axis=axis, on=other,
                                        sched=dict(PAGED, overlap=True, fault_plan=PLAN,
                                                   retry_backoff_s=0.0))
        last = 3 if world == "dp2xtp2" else 1
        stage[f"{world} deadlines"] = dict(kind="dense", reqs=dl, axis=axis, on=other,
                                           skew=last, sched=dict(SLOTS, overlap=True,
                                                                 fault_plan="delay:at=3,s=0.5"))
        stages.append(stage)
    return stages, work, faults


def _jax_runs(jeng, work, faults):
    """The JAX package's overlapped runs of the overlap workloads, and its
    paged overlapped loop under PLAN and clean on the fault workload."""
    out = {}
    for kind, reqs in work.items():
        cls, kw = (JPagedScheduler, PAGED) if kind == "paged" else (JContinuousScheduler, SLOTS)
        out[kind] = run_sched(cls(jeng, overlap=True, **kw), [r[:4] for r in reqs])
    fr = [r[:4] for r in faults]
    out["faults clean"] = run_sched(JPagedScheduler(jeng, overlap=True, **PAGED), fr)
    sched = JPagedScheduler(jeng, overlap=True, fault_plan=PLAN, retry_backoff_s=0.0, **PAGED)
    out["faults"] = run_sched(sched, fr) + ({k: sched.stats[k] for k in FAULT_COUNTS},)
    jeng.dispatch_hook = None
    return out


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = jget_config("yi-9b").reduced(), get_config("yi-9b").reduced()
    jeng, tree = jax_engine(jcfg, MAX_LEN)
    teng = Engine(cfg, parallel=ParallelConfig(), sampling=SamplingConfig(top_k=1),
                  max_len=MAX_LEN, params=bridge.params_from_jax(tree, cfg, device="cpu"),
                  device="cpu")
    stages, work, faults = _stages(teng)
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_runs, jeng, work, faults)
        got = mesh.spawn(torch_control_ranks.run_cases, 2, cfg, _torch_tree(tree), stages,
                         device="cpu", dp=2)
        ref = ref.result(timeout=600)
    return got, ref, teng, jeng, stages


def _runs(got, name):
    return [r[name] for r in got if name in r]


def _requests(streams, reqs=None):
    """rid -> a Request-like record of a rank's streams."""
    return {rid: types.SimpleNamespace(output=np.asarray(t, np.int32), finish_reason=why,
                                       prompt=None if reqs is None else reqs[rid][0])
            for rid, (t, why) in streams.items()}


def _same_on_every_rank(runs, n):
    assert len(runs) == n
    for r in runs[1:]:
        assert r["streams"] == runs[0]["streams"] and r["order"] == runs[0]["order"]
        assert r["counters"] == runs[0]["counters"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("world", WORLDS)
def test_overlap_equals_blocking_and_jax(served, world, kind):
    got, ref, teng, jeng, _ = served
    n = 4 if world == "dp2xtp2" else 2
    blocking = _runs(got, f"{world} {kind} blocking")
    overlapped = _runs(got, f"{world} {kind} overlapped")
    _same_on_every_rank(blocking, n)
    _same_on_every_rank(overlapped, n)
    b, o = blocking[0], overlapped[0]
    # the two loops at the same world, bit for bit: streams, trace, and
    # (without EOS) retire order
    assert o["streams"] == b["streams"] and o["events"] == b["events"]
    if kind == "paged":
        assert o["order"] == b["order"]
    assert b["stats"]["landings"] == 0 and o["stats"]["landings"] > 0
    assert o["stats"]["max_dispatch_ahead"] >= 2
    if kind == "dense":
        assert o["stats"]["eos_rollbacks"] >= 1
    # a record every round, though no deadline, ladder or frontend reads it
    assert b["control"]["count"] == 2 * b["rounds"] and o["control"]["count"] == 2 * o["rounds"]
    # against the JAX package's overlapped loop at tp=1
    jdone, jevents, jorder = ref[kind]
    flips = assert_same_streams(teng, _requests(o["streams"]), jdone, jeng=jeng)
    if not flips:
        assert [tuple(e) for e in o["events"]] == jevents and o["order"] == jorder


@pytest.mark.parametrize("world", WORLDS)
def test_fault_plan_quarantines_the_jax_request(served, world):
    got, ref, teng, jeng, stages = served
    n = 4 if world == "dp2xtp2" else 2
    runs, clean = _runs(got, f"{world} faults"), _runs(got, f"{world} faults clean")
    _same_on_every_rank(runs, n)
    _same_on_every_rank(clean, n)
    r, c = runs[0], clean[0]
    jdone, _, _, jcounts = ref["faults"]
    bad = sorted(rid for rid, (_, why) in r["streams"].items() if why == "error")
    assert bad == sorted(rid for rid, q in jdone.items() if q.finish_reason == "error")
    assert len(bad) == 1
    counts = {k: r["stats"][k] for k in FAULT_COUNTS}
    assert counts == jcounts, (counts, jcounts)
    assert (counts["step_faults"], counts["step_retries"], counts["quarantined"]) == (2, 2, 1)
    for rid, (toks, why) in r["streams"].items():
        if rid not in bad:
            assert why in ("stop", "length") and toks == c["streams"][rid][0]
    jclean = ref["faults clean"][0]
    assert_same_streams(teng, _requests(c["streams"]), jclean, jeng=jeng)


@pytest.mark.parametrize("world", WORLDS)
def test_deadlines_follow_rank0_clock(served, world):
    """A follower whose clock runs SKEW times fast retires exactly rank 0's
    timeouts: no rank but 0 reads the clock for a decision."""
    got, _, teng, _, stages = served
    n = 4 if world == "dp2xtp2" else 2
    runs = _runs(got, f"{world} deadlines")
    _same_on_every_rank(runs, n)
    assert sum(r["skewed"] for r in runs) == 1
    r = runs[0]
    reqs = stages[WORLDS.index(world)][f"{world} deadlines"]["reqs"]
    why = {rid: w for rid, (_, w) in r["streams"].items()}
    toks = {rid: t for rid, (t, _) in r["streams"].items()}
    assert why[0] == why[3] == "timeout" and toks[0] == toks[3] == []
    assert why[1] == "timeout" and 0 < len(toks[1]) < reqs[1][1]
    assert why[2] in ("stop", "length") and len(toks[2]) == reqs[2][1]
    assert why[4] in ("stop", "length") and len(toks[4]) == reqs[4][1]
    assert r["counters"]["timeouts"] == 3
    # one record a round: its length and its payload
    for x in runs:
        assert x["control"]["count"] == 2 * x["rounds"]


def test_no_record_in_a_world_of_one_rank(served):
    """At tp = dp = 1 the deadlines and the ladder read the local clock:
    no record, no ``control`` broadcast."""
    teng = served[2]
    sched = ContinuousScheduler(teng, **SLOTS, overload_opts={"enabled": True})
    for p, mn, eos, arr, cls, dl in deadline_requests(teng.cfg.vocab_size):
        sched.submit(p, mn, eos_id=eos, arrival_step=arr, priority=cls, deadline_s=dl)
    with cc.comm_stats() as st:
        done = sched.run()
    assert st.records == [] and sched._control is None
    assert sum(r.finish_reason == "timeout" for r in done) >= 2


def test_delay_clause_sleeps_on_rank0_only():
    """A delay clause fires on every rank alike (its rng draw too) but
    sleeps only where ``sleeps`` (world rank 0)."""
    draws = []
    for sleeps in (True, False):
        plan = tfaults.FaultPlan.parse("delay:at=1,s=0.2,p=0.9,times=3;seed:n=3")
        plan.sleeps = sleeps
        t = time.monotonic()
        for step in range(6):
            plan.on_dispatch(step)
        dt = time.monotonic() - t
        fired = 3 - plan.clauses[0].times
        assert fired >= 1
        assert dt >= 0.2 * fired if sleeps else dt < 0.1
        draws.append((fired, plan._rng.random()))
    assert draws[0] == draws[1]


def test_control_broadcast_round_trip():
    """The record's encoding round-trips every field, and a world of one
    rank broadcasts nothing."""
    from repro_torch.models.common import Dist
    from repro_torch.runtime.control import RoundRecord

    rec = RoundRecord(expired=[3, 1], itl=0.0125, stop=True, door_shed=["batch"],
                      submits=[{"rid": 7, "prompt": [[1, 2], [3, 4]], "max_new": 3,
                                "eos_id": None, "arrival_step": 5, "deadline_s": 0.5,
                                "priority": "interactive"}])
    assert RoundRecord.decode(rec.encode()) == rec
    assert RoundRecord.decode(RoundRecord(itl=float("nan")).encode()).itl is None
    with cc.comm_stats() as st:
        assert cc.control_broadcast(b"xyz", Dist()) == b"xyz"
    assert st.records == []


def test_control_channel_is_thread_safe():
    """Door sheds arrive on the event loop's thread while the worker takes
    the record: none is lost or counted twice."""
    from repro_torch.models.common import Dist
    from repro_torch.runtime.control import ControlChannel

    ch = ControlChannel(Dist())
    taken = []

    def shed():
        for _ in range(500):
            ch.announce_door_shed("batch")

    threads = [threading.Thread(target=shed) for _ in range(4)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        with ch._lock:
            taken += ch._door_shed
            ch._door_shed = []
    taken += ch._door_shed
    assert len(taken) == 2000
