"""The overlapped decode loop: the port's scheduler against its own
blocking loop and against the JAX package's, on the same weights.

Decode block N+1 is dispatched on block N's device outputs before N lands
(``Engine.dispatch_decode`` / ``land_decode``); the host state advances on
a prediction that a landed EOS rolls back.  Each workload of
``tests/test_async.py`` (seeded Poisson arrivals on the virtual clock) runs
through the port blocking and overlapped, and through the JAX scheduler
blocking and overlapped.  Within the port the two loops give the same
streams bit for bit, the same (rid, token) emission trace and, without
EOS, the same retire order; against the reference the streams agree up to
certified near-ties and the virtual-clock counters agree exactly.  The
service test holds ``EngineService``'s bounded queue: a shed request never
reaches the scheduler, and every admitted one decodes its whole budget,
the tokens the JAX scheduler gives the same prompt.
"""
import asyncio

import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch.launch.frontend import EngineService, TokenStream
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from torch_control_plane import (assert_same_stats, assert_same_streams, make_engines,
                                 poisson_requests, run_sched)

CLOCK_STATS = ("decode_steps", "slot_steps", "emitted", "active_slot_steps", "landings",
               "eos_rollbacks", "max_dispatch_ahead", "dispatch_ahead_steps",
               "admission_rounds", "prefill_calls", "prefill_chunks")


@pytest.fixture(scope="module")
def engines():
    return make_engines()


def make(kind, eng, overlap, jax_side=False, **kw):
    if kind == "paged":
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=2, block_size=8, overlap=overlap, **kw)
    cls = JContinuousScheduler if jax_side else ContinuousScheduler
    return cls(eng, n_slots=3, block_steps=2, overlap=overlap, **kw)


def run_pair(engines, kind, reqs, check_retire_order=True, expect_landings=True, **kw):
    """The workload through the port blocking then overlapped, and through
    the JAX scheduler the same two ways; returns the port's two schedulers."""
    jeng, teng = engines
    port, ref = [], []
    for overlap in (False, True):
        s = make(kind, teng, overlap, **kw)
        port.append((s, *run_sched(s, reqs)))
        j = make(kind, jeng, overlap, jax_side=True, **kw)
        ref.append((j, *run_sched(j, reqs)))
    (s0, d0, e0, o0), (s1, d1, e1, o1) = port
    assert not s0.overlap and s1.overlap
    # the port's two loops, bit for bit
    assert e0 == e1, "global (rid, token) emission trace diverged"
    assert sorted(d0) == sorted(d1)
    for rid in d0:
        np.testing.assert_array_equal(d0[rid].output, d1[rid].output)
        assert d0[rid].finish_reason == d1[rid].finish_reason
    if check_retire_order:
        assert o0 == o1
    assert s0.stats["landings"] == 0
    if expect_landings:
        assert s1.stats["landings"] > 0
    assert s1.stats["host_overlap_s"] >= 0.0
    # each loop against the reference's same loop; a parting changes the
    # counters only where they read token values (EOS, drafts)
    value_free = not kw.get("spec_k") and all(eos is None for _, _, eos, _ in reqs)
    for (s, d, _, _), (j, jd, _, _) in zip(port, ref):
        if not assert_same_streams(teng, d, jd, jeng=jeng) or value_free:
            assert_same_stats(s, j, CLOCK_STATS)
    return s0, s1


@pytest.mark.parametrize("case", ["dense", "dense_spec", "paged", "paged_spec",
                                  "paged_chunked_prefill"])
def test_overlap_identity(engines, case):
    """tests/test_async.py's five non-disagg identity workloads."""
    vocab = engines[1].cfg.vocab_size
    if case == "dense":
        s0, s1 = run_pair(engines, "dense", poisson_requests(vocab, n=8, seed=0))
        # the loop really ran ahead of the host
        assert s1.stats["max_dispatch_ahead"] >= 2 and s1.stats["dispatch_ahead_steps"] > 0
    elif case == "dense_spec":
        # verify steps drain the pipeline and run blocking: identity holds,
        # and the loop does not stall on the drained pipeline
        run_pair(engines, "dense", poisson_requests(vocab, n=6, seed=1), expect_landings=False,
                 spec_k=2)
    elif case == "paged":
        s0, s1 = run_pair(engines, "paged", poisson_requests(vocab, n=8, seed=2))
        assert s1.stats["max_dispatch_ahead"] >= 2
        s1.alloc.audit()
    elif case == "paged_spec":
        run_pair(engines, "paged", poisson_requests(vocab, n=6, seed=3), expect_landings=False,
                 spec_k=2)
    else:
        s0, s1 = run_pair(engines, "paged", poisson_requests(vocab, n=6, seed=4, plen=(16, 40)),
                          prefill_chunk=8)
        assert s1.stats["prefill_chunks"] > 0


def test_overlap_eos_rollback(engines):
    """EOS is the one event the prediction cannot see: the loop has already
    dispatched ahead when the landing shows the stop, and rolls the
    predicted state back.  Streams stay bit-identical (retire order may
    lag, so it is not held)."""
    jeng, teng = engines
    reqs = poisson_requests(teng.cfg.vocab_size, n=3, seed=6, lam=0.0, max_new=(12, 16))
    probe, _, _ = run_sched(ContinuousScheduler(teng, n_slots=3, block_steps=2), reqs)
    # the most common token deep in the streams, so requests stop early at
    # positions the predictor cannot anticipate
    toks = np.concatenate([r.output[4:-2].ravel() for r in probe.values()])
    eos_id = int(np.bincount(toks).argmax())
    reqs = [(p, mn, eos_id, arr) for p, mn, _, arr in reqs]
    s0, s1 = run_pair(engines, "dense", reqs, check_retire_order=False)
    assert any(r.output[-1] == eos_id for r in s0.done), "no early EOS stop"
    assert s1.stats["eos_rollbacks"] >= 1


def test_decode_dispatch_chains_device_outputs(engines):
    """A dispatch takes the previous block's device state as its inputs: two
    chained blocks of 2 give one block of 4's tokens and state."""
    _, teng = engines
    toks = np.tile(np.arange(8, dtype=np.int32) + 3, (2, 1))
    state = dict(pos=np.full(2, 8), done=np.array([False, False]),
                 remaining=np.array([4, 2]), eos=np.full(2, -1))
    outs = []
    for chained in (False, True):
        caches = teng.init_slot_caches(2)
        first = teng.prefill_into_slots(caches, toks, np.ones(2, bool), np.full(2, 8))
        if chained:
            a = teng.dispatch_decode(caches, first, state["pos"], state["done"],
                                     state["remaining"], state["eos"], n=2)
            b = teng.dispatch_decode(caches, *a.state, state["eos"], n=2)
            ta, tb = teng.land_decode(a), teng.land_decode(b)
            outs.append((np.concatenate([ta[0], tb[0]]), *tb[1:]))
        else:
            outs.append(teng.decode_slots(caches, first, **state, n=4))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(outs[1][3], [0, 0])


def test_service_shed_requests_cleanly(engines):
    """The bounded queue under overload: shed requests never reach the
    scheduler, and every admitted one decodes its whole budget, the tokens
    the JAX scheduler gives the same prompt."""
    jeng, teng = engines
    sched = ContinuousScheduler(teng, n_slots=2, block_steps=2, overlap=True)
    service = EngineService(sched, max_pending=2, idle_wait_s=0.002)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, teng.cfg.vocab_size, 8).tolist() for _ in range(6)]

    async def drive():
        loop = asyncio.get_running_loop()
        service.start()
        pairs = []
        for p in prompts:
            s = TokenStream(loop)
            pairs.append((service.try_submit(p, 5, None, s), s))
        outs = []
        for verdict, s in pairs:
            if verdict != "ok":
                outs.append(None)
                continue
            toks = []
            while (t := await s.next_token()) is not None:
                toks.append(t)
            outs.append(toks)
        return [v for v, _ in pairs], outs

    verdicts, outs = asyncio.run(drive())
    shed = verdicts.count("shed")
    assert shed >= 1 and verdicts.count("ok") == 6 - shed
    assert sched.stats["shed_requests"] == shed
    assert service.drain(timeout=60)
    assert len(sched.done) == 6 - shed
    admitted = [(np.asarray(p, np.int32), 5, None, 0)
                for p, v in zip(prompts, verdicts) if v == "ok"]
    ref, _, _ = run_sched(JContinuousScheduler(jeng, n_slots=2, block_steps=2), admitted)
    port = {i: r for i, r in enumerate(sorted(sched.done, key=lambda r: r.rid))}
    assert_same_streams(teng, port, ref)
    for out, r in zip([o for o in outs if o is not None], port.values()):
        assert len(out) == 5 and out == r.output.tolist()
