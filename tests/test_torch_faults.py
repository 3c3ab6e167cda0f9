"""Fault injection and failure isolation: the port's FaultPlan against the
JAX package's, and the port's schedulers against the JAX schedulers under
the same plans, on the same weights.

tests/test_faults.py's non-disagg cases: the plan's grammar and firing
(both packages' FaultPlan, each held to the same assertions); poisoned-slot
quarantine (dense, overlapped, paged with the allocator audited after every
quarantine and preemption); bounded retry of transient step faults, bit
for bit, and quarantine or a fatal error when retries run out; queued and
slot-resident deadlines; the watchdog's liveness age; injected allocation
denials absorbed by preemption and terminal exhaustion aborting one
request; preempt-requeue churn conserving the pool; ``--stats-json``
flushed when the serve loop dies.  Everywhere a fault on one request leaves
every other stream as an uninjected run's, and the port's streams and
fault counters equal the reference's (streams up to certified near-ties).
The control plane at tp > 1 is admitted here and served in test_torch_control_ranks.py.
"""
import json
import time

import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.runtime import faults as jfaults
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.launch.frontend import EngineService
from repro_torch.models import model as M
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from torch_control_plane import (assert_same_stats, assert_same_streams, clear_hooks,
                                 make_engines, run_sched)

FAULT_STATS = ("step_faults", "step_retries", "quarantined", "timeouts", "aborts_exhaustion",
               "preemptions", "decode_steps", "slot_steps", "emitted", "landings")
PLANS = {"jax": jfaults, "port": tfaults}


@pytest.fixture(scope="module")
def engines():
    return make_engines()


@pytest.fixture(autouse=True)
def _clear_hooks(request):
    yield
    if "engines" in request.fixturenames:
        clear_hooks(*request.getfixturevalue("engines"))


def fault_requests(vocab, n=5):
    """EOS-free requests with max_new >= 8, so that every admitted slot is
    still emitting through the early steps the clauses target."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, int(rng.integers(4, 12))).astype(np.int32), 8 + i % 3,
             None, 2 * (i // 3)) for i in range(n)]


def audited(sched, jax_side=False):
    """Run the allocator's audit after every quarantine and preemption."""
    audit = ((lambda: sched.alloc.audit(expect_no_migration=True)) if jax_side
             else sched.alloc.audit)
    orig = sched._quarantine_slot

    def quarantine(i, finish_reason="error", error=None):
        orig(i, finish_reason, error)
        audit()

    sched._quarantine_slot = quarantine
    sched.on_preempt = lambda rid: audit()
    return sched


@pytest.fixture(scope="module")
def clean(engines):
    """The uninjected dense run of the shared workload (port's and JAX's)."""
    jeng, teng = engines
    reqs = fault_requests(teng.cfg.vocab_size)
    port = run_sched(ContinuousScheduler(teng, n_slots=3, block_steps=4), reqs)[0]
    ref = run_sched(JContinuousScheduler(jeng, n_slots=3, block_steps=4), reqs)[0]
    assert_same_streams(teng, port, ref, jeng=jeng)
    return port


def check_survivors(done, clean, n_bad=1, reason="error"):
    bad = [r for r in done.values() if r.finish_reason == reason]
    assert len(bad) == n_bad
    for rid, r in done.items():
        if r.finish_reason != reason:
            assert r.finish_reason in ("stop", "length")
            np.testing.assert_array_equal(r.output, clean[rid].output)
    return bad


def run_both(engines, make, reqs=None, n_bad=1, reason="error", clean=None):
    """The workload through the port's scheduler and the JAX one made by
    ``make(engine, jax_side)``: the same streams (up to certified near-ties)
    and the same fault counters; survivors equal ``clean`` when given.
    -> (port scheduler, its rid -> Request, the reference's)."""
    jeng, teng = engines
    reqs = reqs or fault_requests(teng.cfg.vocab_size)
    tsched, jsched = make(teng, False), make(jeng, True)
    port = run_sched(tsched, reqs)[0]
    ref = run_sched(jsched, reqs)[0]
    assert_same_streams(teng, port, ref, jeng=jeng)
    assert_same_stats(tsched, jsched, FAULT_STATS)
    if clean is not None:
        check_survivors(port, clean, n_bad, reason)
    return tsched, port, ref


# -- FaultPlan: grammar and firing (no engine), both packages -----------------

@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_plan_parse_grammar(pkg):
    FaultPlan = PLANS[pkg].FaultPlan
    plan = FaultPlan.parse("step:at=12,times=2,slot=1; poison:slot=0,at=20;"
                           "alloc:at=5;migrate:handoff=1;delay:at=3,s=0.5;seed:n=7")
    assert bool(plan) and len(plan.clauses) == 5
    st = plan.clauses[0]
    assert (st.kind, st.at, st.times, st.slot) == ("step", 12, 2, 1)
    assert plan.clauses[3].handoff == 1
    assert plan.clauses[4].seconds == 0.5
    assert not FaultPlan.parse("") and not FaultPlan.parse(None)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("fry:at=1")
    with pytest.raises(ValueError, match="unknown fault key"):
        FaultPlan.parse("step:when=1")
    with pytest.raises(ValueError, match="needs slot"):
        FaultPlan.parse("poison:at=4")


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_plan_step_firing_and_disarm(pkg):
    mod = PLANS[pkg]
    plan = mod.FaultPlan.parse("step:at=5,times=2,slot=1")
    plan.on_dispatch(4)
    for _ in range(2):
        with pytest.raises(mod.TransientStepError) as ei:
            plan.on_dispatch(7)
        assert ei.value.slot == 1
    plan.on_dispatch(7)
    plan2 = mod.FaultPlan.parse("step:at=0,times=9,slot=2;poison:slot=2,at=50")
    plan2.on_quarantine(2)
    plan2.on_dispatch(10)
    assert all(c.times == 0 for c in plan2.clauses)


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_plan_corrupt_tokens_copy_on_write(pkg):
    mod = PLANS[pkg]
    plan = mod.FaultPlan.parse("poison:slot=1,at=6")
    toks = np.arange(12, dtype=np.int32).reshape(4, 3)
    toks.setflags(write=False)
    assert plan.corrupt_tokens(toks, base_step=0) is toks
    assert plan.corrupt_tokens(toks, base_step=4, active=np.array([True, False, True])) is toks
    assert plan.clauses[0].times == 1
    out = plan.corrupt_tokens(toks, base_step=4)
    assert out is not toks and out[2, 1] == mod.POISON_TOKEN == jfaults.POISON_TOKEN
    mask = np.ones((4, 3), bool)
    mask[2, 1] = False
    np.testing.assert_array_equal(out[mask], toks[mask])
    assert plan.corrupt_tokens(toks, base_step=4) is toks


@pytest.mark.parametrize("pkg", sorted(PLANS))
def test_plan_alloc_delay_handoff(pkg):
    mod = PLANS[pkg]
    plan = mod.FaultPlan.parse("alloc:at=3,times=2;delay:at=0,s=0.05;migrate:handoff=1")
    t0 = time.monotonic()
    plan.on_dispatch(0)
    assert time.monotonic() - t0 >= 0.05
    assert not plan.deny_alloc(2)
    assert plan.deny_alloc(3) and plan.deny_alloc(9)
    assert not plan.deny_alloc(9)
    plan.on_handoff()
    with pytest.raises(mod.MigrationFault):
        plan.on_handoff()


# -- poisoned slot: quarantine, survivors bit-identical ------------------------

def test_poison_quarantine_dense(engines, clean):
    def make(eng, jax_side):
        cls = JContinuousScheduler if jax_side else ContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, fault_plan="poison:slot=1,at=2")
    sched, port, _ = run_both(engines, make, clean=clean)
    bad = [r for r in port.values() if r.finish_reason == "error"]
    assert "poisoned" in bad[0].stats["error"] and bad[0].output is not None
    assert sched.stats["quarantined"] == 1
    summ = sched.request_summary()
    assert summ["faults"]["quarantined"] == 1 and summ["finish_reasons"]["error"] == 1


def test_poison_quarantine_overlap(engines, clean):
    def make(eng, jax_side):
        cls = JContinuousScheduler if jax_side else ContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, overlap=True, fault_plan="poison:slot=0,at=4")
    sched, _, _ = run_both(engines, make, clean=clean)
    assert sched.stats["quarantined"] == 1 and sched.stats["landings"] > 0


def test_poison_quarantine_paged_audited(engines, clean):
    def make(eng, jax_side):
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return audited(cls(eng, n_slots=3, block_steps=4, block_size=8, prefix_cache=False,
                           fault_plan="poison:slot=0,at=3"), jax_side)
    sched, _, _ = run_both(engines, make, clean=clean)
    assert sched.stats["quarantined"] == 1
    sched.alloc.audit()
    assert sched.alloc.used_count() == 0      # the quarantined slot's blocks came back


# -- transient step faults: bounded retry, then quarantine of the blamed slot --

def test_transient_retry_bit_identical(engines, clean):
    def make(eng, jax_side):
        cls = JContinuousScheduler if jax_side else ContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, fault_plan="step:at=3,times=2",
                   max_step_retries=3, retry_backoff_s=0.0)
    sched, _, _ = run_both(engines, make, n_bad=0, clean=clean)
    assert sched.stats["step_faults"] == 2 and sched.stats["step_retries"] == 2
    assert sched.stats["quarantined"] == 0


def test_transient_retry_overlap_bit_identical(engines, clean):
    """The retry drains the pipeline to the exact landed frontier first."""
    def make(eng, jax_side):
        cls = JContinuousScheduler if jax_side else ContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, overlap=True,
                   fault_plan="step:at=6,times=2", retry_backoff_s=0.0)
    sched, _, _ = run_both(engines, make, n_bad=0, clean=clean)
    assert sched.stats["step_retries"] == 2 and sched.stats["landings"] > 0


def test_retry_exhaustion_quarantines_blamed_slot(engines, clean):
    def make(eng, jax_side):
        cls = JContinuousScheduler if jax_side else ContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, fault_plan="step:at=3,times=99,slot=0",
                   max_step_retries=2, retry_backoff_s=0.0)
    sched, port, _ = run_both(engines, make, clean=clean)
    bad = [r for r in port.values() if r.finish_reason == "error"]
    assert "persistent step failure" in bad[0].stats["error"]
    assert sched.stats["step_faults"] == 3 and sched.stats["step_retries"] == 2
    assert sched.stats["quarantined"] == 1
    assert all(c.times == 0 for c in sched.faults.clauses)


def test_retry_exhaustion_unattributed_is_fatal(engines):
    counts = []
    for eng, cls, err in ((engines[1], ContinuousScheduler, tfaults.TransientStepError),
                          (engines[0], JContinuousScheduler, jfaults.TransientStepError)):
        sched = cls(eng, n_slots=2, block_steps=4, fault_plan="step:at=0,times=99",
                    max_step_retries=1, retry_backoff_s=0.0)
        sched.submit(np.arange(2, 8, dtype=np.int32), 4)
        with pytest.raises(err):
            sched.run()
        counts.append(sched.stats["step_faults"])
    assert counts == [2, 2]


# -- deadlines -----------------------------------------------------------------

def test_deadline_expires_queued_request(engines):
    outs = []
    for eng, cls in ((engines[1], ContinuousScheduler), (engines[0], JContinuousScheduler)):
        sched = cls(eng, n_slots=2, block_steps=4)
        ra = sched.submit(np.arange(2, 8, dtype=np.int32), 4)
        rb = sched.submit(np.arange(3, 9, dtype=np.int32), 4, deadline_s=0.0)
        done = {r.rid: r for r in sched.run()}
        assert done[rb].finish_reason == "timeout" and done[rb].output.size == 0
        assert done[ra].finish_reason in ("stop", "length") and len(done[ra].output) == 4
        assert sched.stats["timeouts"] == 1
        assert sched.request_summary()["finish_reasons"]["timeout"] == 1
        outs.append(done)
    assert_same_streams(engines[1], *outs, jeng=engines[0])


def test_deadline_expires_slot_resident_request(engines):
    """The deadline passes once the slot has emitted 2 tokens: the request
    keeps what it emitted, the same on both sides (the rounds agree)."""
    outs = []
    for eng, cls in ((engines[1], ContinuousScheduler), (engines[0], JContinuousScheduler)):
        sched = cls(eng, n_slots=2, block_steps=2)
        rid = sched.submit(np.arange(2, 8, dtype=np.int32), 24, deadline_s=60.0)
        while not sched.done:
            sched.serve_step()
            slot = next((s for s in sched.slots if s.req is not None), None)
            if slot is not None and len(slot.toks) >= 2:
                slot.req.deadline_s = 0.0
        done = {r.rid: r for r in sched.run()}
        assert done[rid].finish_reason == "timeout" and 2 <= len(done[rid].output) < 24
        assert sched.stats["timeouts"] == 1
        outs.append((done, sched.step_count))
    assert_same_streams(engines[1], outs[0][0], outs[1][0], jeng=engines[0])
    assert outs[0][1] == outs[1][1]


def test_liveness_age_and_watchdog(engines):
    sched = ContinuousScheduler(engines[1], n_slots=2, block_steps=2)
    sched._progress_t = time.monotonic() - 5.0
    assert sched.liveness_age() >= 5.0
    svc = EngineService(sched, watchdog_s=1.0)
    assert not svc.wedged()                       # idle engines never wedge
    svc._live = 1
    assert svc.wedged()                           # live work, stale progress
    svc_off = EngineService(sched, watchdog_s=0.0)
    svc_off._live = 1
    assert not svc_off.wedged()
    sched.submit(np.arange(2, 8, dtype=np.int32), 4)
    sched.serve_step()                            # engine output reached the host
    assert sched.liveness_age() < 5.0


# -- allocator exhaustion -------------------------------------------------------

def test_injected_alloc_denial_recovers(engines, clean):
    def make(eng, jax_side):
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return audited(cls(eng, n_slots=3, block_steps=4, block_size=8, prefix_cache=False,
                           fault_plan="alloc:at=2,times=1"), jax_side)
    sched, _, _ = run_both(engines, make, n_bad=0, clean=clean)
    assert all(c.times == 0 for c in sched.faults.clauses)
    assert sched.stats["aborts_exhaustion"] == 0 and sched.stats["preemptions"] >= 1
    sched.alloc.audit()


def test_terminal_exhaustion_aborts_request(engines, clean):
    def make(eng, jax_side):
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        sched = audited(cls(eng, n_slots=3, block_steps=4, block_size=8, prefix_cache=False,
                            fault_plan="alloc:at=2,times=1"), jax_side)
        sched._preempt_youngest = lambda shard: False
        return sched
    sched, port, _ = run_both(engines, make, clean=clean)
    bad = [r for r in port.values() if r.finish_reason == "error"]
    assert "exhausted" in bad[0].stats["error"]
    assert sched.stats["aborts_exhaustion"] == 1 and sched.stats["quarantined"] == 1
    sched.alloc.audit()
    assert sched.alloc.used_count() == 0


def test_preempt_requeue_cycles_conserve_pool(engines):
    """Preempt -> requeue -> readmit churn in a tiny pool keeps the
    refcounts whole (audited at every preemption) and every stream as a
    roomy pool's; the preemptions match the reference's."""
    jeng, teng = engines
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, teng.cfg.vocab_size, 9).astype(np.int32), 20, None, 0),
            (rng.integers(0, teng.cfg.vocab_size, 8).astype(np.int32), 16, None, 0)]
    roomy = run_sched(PagedContinuousScheduler(teng, n_slots=2, block_steps=4, block_size=8,
                                               prefix_cache=False), reqs)[0]

    def make(eng, jax_side):
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return audited(cls(eng, n_slots=2, block_steps=4, block_size=8, n_blocks=7,
                           prefix_cache=False), jax_side)
    tiny, done, _ = run_both(engines, make, reqs)
    assert tiny.stats["preemptions"] >= 1 and tiny.stats["quarantined"] == 0
    for rid in roomy:
        assert done[rid].finish_reason in ("stop", "length")
        np.testing.assert_array_equal(done[rid].output, roomy[rid].output)
    tiny.alloc.audit()
    assert tiny.alloc.used_count() == 0


# -- the control plane at tp > 1 and the crash path ---------------------------------

@pytest.mark.parametrize("field,value,name", [("overlap_decode", True, "overlap_decode"),
                                              ("fault_plan", "step:at=1", "fault_plan"),
                                              ("overload_degrade", True, "overload_degrade")])
def test_control_plane_refused_at_tp2(field, value, name):
    """No longer refused: world rank 0 decides what reads the wall clock and
    broadcasts it (tests/test_torch_control_ranks.py serves it at tp 2);
    the packed weight file at tp>1 stays refused beside it."""
    cfg = get_config("yi-9b").reduced()
    for tp in (2, 4, 8):
        M.check_supported(cfg, ParallelConfig(tp=tp, **{field: value}))
    with pytest.raises(NotImplementedError, match="wq_cache at tp>1") as err:
        M.check_supported(cfg, ParallelConfig(tp=2, weight_quant="int8", **{field: value}),
                          wq_cache="x.npz")
    assert name not in str(err.value)


def test_stats_json_flushes_on_fatal_fault(tmp_path):
    from repro_torch.launch import serve
    path = tmp_path / "stats.json"
    argv = ["--device", "cpu", "--arch", "yi-9b", "--scheduler", "continuous",
            "--requests", "2", "--slots", "2", "--prompt-len", "6", "--max-new", "4",
            "--max-len", "64", "--block-steps", "2", "--fault-plan", "step:at=0,times=99",
            "--max-step-retries", "0", "--retry-backoff-s", "0", "--stats-json", str(path)]
    with pytest.raises(tfaults.TransientStepError):
        serve.main(argv)
    payload = json.loads(path.read_text())        # flushed from the finally
    assert payload["stats"]["step_faults"] >= 1
