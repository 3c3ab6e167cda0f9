"""Priority classes, SLO accounting and the degradation ladder: the port's
schedulers and ``OverloadController`` against the JAX package's, on the
same weights.

tests/test_slo.py's non-disagg cases: priority validation; the ladder's
hysteresis and the ``burst:`` clause (both packages' classes, each held to
the same assertions); class-ordered admission; the interactive slot and
paged block reserves; lowest-class-youngest preemption (the allocator
audited after every eviction, requeued streams as an uncontended run's);
the ladder engaging under a burst and walking back to normal, its level
after every round the reference's; deterministic bursts; the spec-off lever
and the ladder under the overlapped loop leaving every admitted stream as
an unloaded run's; per-class summaries and SLO attainment; and the
frontend's class-aware inbox (displacement with a 429, the reserve, the
batch door under degradation).  Degradation changes which requests run and
when, never their tokens.
"""
import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.runtime import faults as jfaults
from repro.runtime import overload as joverload
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch.launch.frontend import EngineService, TokenStream
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import overload as toverload
from repro_torch.runtime.scheduler import (PRIORITY_CLASSES, PRIORITY_RANK,
                                           ContinuousScheduler, PagedContinuousScheduler)
from torch_control_plane import (assert_same_stats, assert_same_streams, clear_hooks,
                                 make_engines)

OVERLOAD = {"jax": joverload, "port": toverload}
FAULTS = {"jax": jfaults, "port": tfaults}
CLASS_STATS = ("decode_steps", "slot_steps", "emitted", "shed_requests", "burst_injected",
               "overload_transitions", "spec_off_rounds", "admission_rounds", "preemptions",
               "classes")


@pytest.fixture(scope="module")
def engines():
    return make_engines()


@pytest.fixture(autouse=True)
def _clear_hooks(request):
    yield
    if "engines" in request.fixturenames:
        clear_hooks(*request.getfixturevalue("engines"))


def mixed_requests(vocab, n=10, seed=9, max_new=6):
    """Seeded prompts with a fixed class rotation (i, s, b, s, ...)."""
    rng = np.random.default_rng(seed)
    rot = ("interactive", "standard", "batch", "standard")
    return [(rng.integers(0, vocab, int(rng.integers(4, 12))).astype(np.int32), max_new,
             rot[i % len(rot)]) for i in range(n)]


def run_mixed(sched, reqs, arrival_every=0):
    rids = {}
    for i, (p, mn, cls) in enumerate(reqs):
        rids[sched.submit(p, mn, arrival_step=i * arrival_every, priority=cls)] = cls
    return {r.rid: r for r in sched.run()}, rids


def both(engines, make, reqs, arrival_every=0, stats=CLASS_STATS):
    """``make(engine, jax_side)``'s scheduler on both sides over the mixed
    workload: the same streams (up to certified near-ties) and counters.
    -> ((port scheduler, done, rids), (JAX scheduler, done))."""
    jeng, teng = engines
    tsched, jsched = make(teng, False), make(jeng, True)
    port, rids = run_mixed(tsched, reqs, arrival_every)
    ref, _ = run_mixed(jsched, reqs, arrival_every)
    assert_same_streams(teng, port, ref, jeng=jeng)
    assert_same_stats(tsched, jsched, stats)
    return (tsched, port, rids), (jsched, ref)


def dense(**kw):
    return lambda eng, jax_side: (JContinuousScheduler if jax_side else ContinuousScheduler)(
        eng, **kw)


# -- validation and the controller ---------------------------------------------

def test_priority_validation(engines):
    sched = ContinuousScheduler(engines[1], n_slots=2, block_steps=2)
    with pytest.raises(ValueError, match="unknown priority class"):
        sched.submit(np.arange(2, 8, dtype=np.int32), 4, priority="vip")
    assert PRIORITY_CLASSES == ("interactive", "standard", "batch")
    assert PRIORITY_RANK["interactive"] < PRIORITY_RANK["batch"]


@pytest.mark.parametrize("pkg", sorted(OVERLOAD))
def test_overload_controller_hysteresis(pkg):
    mod = OVERLOAD[pkg]
    ctl = mod.OverloadController(queue_hi=4, queue_lo=1, patience=2, cooldown=3)
    assert ctl.observe(10) == 0
    assert ctl.observe(10) == 1 and ctl.shed_classes == ("batch",)
    assert ctl.observe(2) == 1                    # dead band holds the level
    assert ctl.observe(0) == 1 and ctl.observe(0) == 1
    assert ctl.observe(0) == 0                    # third clear round restores
    for _ in range(8):
        ctl.observe(10)
    assert ctl.level == mod.LADDER.index("tight-admission")
    assert ctl.spec_off and ctl.admission_cap == 1
    s = ctl.summary()
    assert s["max_level_name"] == "tight-admission"
    assert s["escalations"] == 4 and s["restorations"] == 1
    with pytest.raises(ValueError):
        mod.OverloadController(queue_hi=1, queue_lo=2)


@pytest.mark.parametrize("pkg", sorted(FAULTS))
def test_burst_clause_parse_and_schedule(pkg):
    FaultPlan = FAULTS[pkg].FaultPlan
    plan = FaultPlan.parse("burst:at=4,count=3,plen=6,new=5,cls=batch,times=2,every=8")
    assert plan.burst(3) == []
    assert plan.burst(4) == [(3, 6, 5, "batch", 4)]
    assert plan.burst(15) == [(3, 6, 5, "batch", 12)]
    assert plan.burst(99) == []
    with pytest.raises(ValueError, match="burst clause needs count="):
        FaultPlan.parse("burst:at=4")
    with pytest.raises(ValueError, match="unknown fault key"):
        FaultPlan.parse("burst:count=1,nope=2")


# -- class-aware admission -------------------------------------------------------

def test_admission_prefers_interactive(engines):
    """Everything arrived at once, 2 slots: both interactive requests admit
    first though submitted last, in FIFO order within the class."""
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, engines[1].cfg.vocab_size, 6).astype(np.int32), 4, cls)
            for cls in ("batch", "standard", "interactive", "interactive")]
    (_, done, rids), (_, ref) = both(engines, dense(n_slots=2, block_steps=2), reqs)
    first = {cls for rid, cls in rids.items() if done[rid].stats["admitted_step"] == 0}
    assert first == {"interactive"}
    ia = [done[rid].stats["admitted_step"] for rid, c in rids.items() if c == "interactive"]
    assert ia == sorted(ia)
    assert all(done[rid].stats["admitted_step"] == ref[rid].stats["admitted_step"]
               for rid in done)


def test_interactive_reserve_slots(engines):
    """reserve_slots=1 of 2: one standard admits at once, the held slot
    takes the interactive arrival, the second standard waits for a slot to
    free."""
    vocab = engines[1].cfg.vocab_size
    outs = []
    for eng, cls in ((engines[1], ContinuousScheduler), (engines[0], JContinuousScheduler)):
        rng = np.random.default_rng(2)
        sched = cls(eng, n_slots=2, block_steps=2, reserve_slots=1)
        s1 = sched.submit(rng.integers(0, vocab, 6).astype(np.int32), 8, priority="standard")
        s2 = sched.submit(rng.integers(0, vocab, 6).astype(np.int32), 8, priority="standard")
        it = sched.submit(rng.integers(0, vocab, 6).astype(np.int32), 4, arrival_step=2,
                          priority="interactive")
        done = {r.rid: r for r in sched.run()}
        assert done[s1].stats["admitted_step"] == 0 and done[it].stats["admitted_step"] <= 4
        assert done[s2].stats["admitted_step"] > done[it].stats["admitted_step"]
        outs.append(done)
    assert_same_streams(engines[1], *outs, jeng=engines[0])
    assert ([r.stats["admitted_step"] for r in outs[0].values()]
            == [outs[1][rid].stats["admitted_step"] for rid in outs[0]])


def test_interactive_reserve_blocks(engines):
    """Paged, reserve_blocks: a non-interactive admission may not take the
    pool's last free blocks; the admissions, deferrals and streams are the
    reference's."""
    reqs = mixed_requests(engines[1].cfg.vocab_size, n=8, seed=4, max_new=8)

    def make(eng, jax_side):
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=2, block_size=4, n_blocks=10,
                   prefix_cache=False, reserve_blocks=4)
    (tsched, done, rids), (jsched, ref) = both(engines, make, reqs, arrival_every=1,
                                               stats=CLASS_STATS + ("deferred_admissions",))
    assert tsched.stats["deferred_admissions"] > 0
    assert all(done[rid].stats["admitted_step"] == ref[rid].stats["admitted_step"]
               for rid in done)
    tsched.alloc.audit()


# -- preemption by class ---------------------------------------------------------

def test_preempt_victims_lowest_class_youngest_first(engines):
    """An overcommitted paged pool with mixed classes: every victim is the
    worst-class, youngest running request, the allocator audits clean after
    every eviction, and every stream is an uncontended run's."""
    jeng, teng = engines
    reqs = mixed_requests(teng.cfg.vocab_size, n=8, seed=7, max_new=8)
    ref, _ = run_mixed(PagedContinuousScheduler(teng, n_slots=3, block_steps=2, block_size=4,
                                                prefix_cache=False), reqs, arrival_every=2)
    victims = []

    def make(eng, jax_side):
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        sched = cls(eng, n_slots=3, block_steps=2, block_size=4, n_blocks=12,
                    prefix_cache=False)
        if jax_side:
            return sched
        orig = sched._preempt_youngest

        def spy(shard):
            running = {i: (PRIORITY_RANK[s.req.priority], s.admitted_step, s.req.rid)
                       for i, s in enumerate(sched.slots)
                       if s.req is not None and ((not sched.dones[i] and sched.remaining[i] > 0)
                                                 or s.chunk_next is not None)}
            before = {i: s.req.rid if s.req else None for i, s in enumerate(sched.slots)}
            ok = orig(shard)
            if ok:
                evicted = [i for i, s in enumerate(sched.slots) if before[i] is not None
                           and (s.req is None or s.req.rid != before[i])]
                assert len(evicted) == 1
                victims.append((running, running[evicted[0]]))
                sched.alloc.audit()
            return ok

        sched._preempt_youngest = spy
        return sched
    (tsched, done, _), _ = both(engines, make, reqs, arrival_every=2)
    assert tsched.stats["preemptions"] >= 1 and victims
    for running, chosen in victims:
        assert chosen == max(running.values())
    tsched.alloc.audit()
    for rid, r in done.items():
        assert r.finish_reason in ("stop", "length")
        np.testing.assert_array_equal(r.output, ref[rid].output)


# -- the degradation ladder -------------------------------------------------------

def test_ladder_sheds_batch_and_recovers(engines):
    """A burst drives the queue past the threshold: the ladder engages,
    batch is shed at admission, and once the wave drains the ladder walks
    back to normal.  Its level after every round is the reference's."""
    levels = []
    outs = []
    for eng, cls in ((engines[1], ContinuousScheduler), (engines[0], JContinuousScheduler)):
        sched = cls(eng, n_slots=2, block_steps=2,
                    fault_plan="burst:at=2,count=8,cls=batch,new=4",
                    overload_opts={"enabled": True, "queue_hi": 4, "queue_lo": 1,
                                   "patience": 1, "cooldown": 2})
        rng = np.random.default_rng(5)
        keep = [sched.submit(rng.integers(0, eng.cfg.vocab_size, 6).astype(np.int32), 10,
                             arrival_step=4 * i, priority="interactive") for i in range(6)]
        lv = []
        while sched.serve_step():
            lv.append(sched.overload_level())
        done = {r.rid: r for r in sched.run()}
        st = sched.stats
        assert st["burst_injected"] == 8
        assert st["classes"]["batch"]["shed"] >= 1 and st["classes"]["interactive"]["shed"] == 0
        ov = sched.request_summary()["overload"]
        assert ov["max_level"] >= 1 and ov["level"] == 0
        assert ov["escalations"] >= 1 and ov["restorations"] >= 1
        assert st["overload_transitions"] == ov["transitions"]
        for rid in keep:
            assert done[rid].finish_reason in ("stop", "length")
        levels.append(lv)
        outs.append((sched, done))
    assert levels[0] == levels[1]
    assert_same_streams(engines[1], outs[0][1], outs[1][1], jeng=engines[0])
    assert_same_stats(outs[0][0], outs[1][0], CLASS_STATS)


def test_burst_injection_deterministic(engines):
    """Two runs of one burst plan inject the same traffic, on both sides."""
    outs = []
    for eng, cls in ((engines[1], ContinuousScheduler), (engines[1], ContinuousScheduler),
                     (engines[0], JContinuousScheduler)):
        sched = cls(eng, n_slots=2, block_steps=2,
                    fault_plan="burst:at=0,count=3,plen=6,new=5,cls=standard")
        sched.submit(np.arange(2, 8, dtype=np.int32), 4)
        done = sched.run()
        assert sched.stats["burst_injected"] == 3
        outs.append({r.rid: r for r in done})
    for rid in outs[0]:
        np.testing.assert_array_equal(outs[0][rid].output, outs[1][rid].output)
        np.testing.assert_array_equal(outs[0][rid].prompt, outs[2][rid].prompt)
    assert_same_streams(engines[1], outs[0], outs[2], jeng=engines[0])


def test_spec_off_lever_token_identical(engines):
    """The ladder at spec-off with spec decode on: the lever fires without
    changing a stream against a plain unloaded run."""
    teng = engines[1]
    reqs = [(p, mn, "interactive")
            for p, mn, _ in mixed_requests(teng.cfg.vocab_size, n=8, seed=3, max_new=8)]
    ref, _ = run_mixed(ContinuousScheduler(teng, n_slots=2, block_steps=2), reqs)
    make = dense(n_slots=2, block_steps=2, spec_k=2,
                 overload_opts={"enabled": True, "queue_hi": 2, "queue_lo": 1,
                                "patience": 1, "cooldown": 1})
    (sched, done, _), _ = both(engines, make, reqs)
    assert sched.stats["spec_off_rounds"] > 0
    assert sched.request_summary()["overload"]["max_level"] >= 2
    for rid, r in done.items():
        np.testing.assert_array_equal(r.output, ref[rid].output)


def test_overlap_degradation_identity(engines):
    """The ladder and the classes under the overlapped loop: survivors equal
    a blocking unloaded run, and only batch requests are shed."""
    teng = engines[1]
    reqs = mixed_requests(teng.cfg.vocab_size, n=10, seed=6, max_new=6)
    ref, _ = run_mixed(ContinuousScheduler(teng, n_slots=4, block_steps=2), reqs,
                       arrival_every=4)
    make = dense(n_slots=2, block_steps=2, overlap=True, reserve_slots=1,
                 overload_opts={"enabled": True, "queue_hi": 3, "queue_lo": 1,
                                "patience": 1, "cooldown": 2})
    (sched, done, rids), _ = both(engines, make, reqs,
                                  stats=CLASS_STATS + ("landings", "max_dispatch_ahead"))
    assert sched.request_summary()["overload"]["max_level"] >= 1
    survivors = [rid for rid, r in done.items() if r.finish_reason in ("stop", "length")]
    assert survivors
    for rid in survivors:
        np.testing.assert_array_equal(done[rid].output, ref[rid].output)
    assert all(rids[rid] == "batch" for rid, r in done.items() if r.finish_reason == "shed")


# -- per-class telemetry ---------------------------------------------------------

def test_class_summary_and_slo_attainment(engines):
    make = dense(n_slots=3, block_steps=2, slo_targets={"interactive": 60.0, "batch": 1e-9})
    (sched, done, rids), (jsched, _) = both(
        engines, make, mixed_requests(engines[1].cfg.vocab_size, n=8))
    classes, jclasses = sched.request_summary()["classes"], jsched.request_summary()["classes"]
    for cls in PRIORITY_CLASSES:
        n = sum(1 for c in rids.values() if c == cls)
        assert classes[cls]["requests"] == classes[cls]["served"] == n
        assert classes[cls]["itl_s"]["p50"] > 0.0
        assert classes[cls]["ttft_s"]["p95"] >= classes[cls]["ttft_s"]["p50"]
        assert sorted(classes[cls]) == sorted(jclasses[cls])
    assert classes["interactive"]["slo_attainment"] == 1.0
    assert classes["batch"]["slo_attainment"] == 0.0
    assert "slo_target_s" not in classes["standard"]
    assert sched.stats["classes"]["interactive"]["served"] == classes["interactive"]["served"]


# -- the frontend's class-aware inbox ---------------------------------------------

class _Loop:
    """Stands in for the asyncio loop TokenStream schedules onto."""

    def call_soon_threadsafe(self, fn, *a):
        fn(*a)


def test_frontend_priority_displacement_and_reserve(engines):
    sched = ContinuousScheduler(engines[1], n_slots=2, block_steps=2)
    svc = EngineService(sched, max_pending=2, pending_reserve=1)
    # the worker is not started: submissions stay in the inbox
    prompt = [2, 3, 4, 5]
    streams = [TokenStream(_Loop()) for _ in range(4)]
    assert svc.try_submit(prompt, 4, None, streams[0], priority="batch") == "ok"
    assert svc.try_submit(prompt, 4, None, streams[1], priority="standard") == "shed"
    assert svc.try_submit(prompt, 4, None, streams[1], priority="interactive") == "ok"
    assert svc.try_submit(prompt, 4, None, streams[2], priority="standard") == "ok"
    assert streams[0].error is not None and streams[0].error_status.startswith("429")
    assert streams[0].error_type == "overloaded_error"
    assert svc.try_submit(prompt, 4, None, streams[3], priority="standard") == "shed"
    assert sched.stats["classes"]["batch"]["shed"] == 1
    assert sched.stats["classes"]["standard"]["shed"] == 2
    assert sched.stats["shed_requests"] == 3


def test_frontend_batch_door_shed_under_degradation(engines):
    sched = ContinuousScheduler(engines[1], n_slots=2, block_steps=2,
                                overload_opts={"enabled": True, "queue_hi": 1, "queue_lo": 1,
                                               "patience": 1, "cooldown": 1})
    sched.overload_ctl.observe(5)          # level 1: shed-batch
    assert sched.overload_level() == 1
    svc = EngineService(sched, max_pending=8)
    s = TokenStream(_Loop())
    assert svc.try_submit([2, 3, 4], 4, None, s, priority="batch") == "shed"
    assert svc.try_submit([2, 3, 4], 4, None, s, priority="interactive") == "ok"
    assert sched.stats["classes"]["batch"]["shed"] == 1
