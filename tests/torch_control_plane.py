"""Shared by the port's serving control-plane test files
(``test_torch_overlap.py``, ``test_torch_faults.py``, ``test_torch_slo.py``,
``test_torch_frontend.py``): the JAX package's engine and the port's on the
same bridged weights, and the comparisons those files make.

Both engines serve reduced yi-9b (2 layers, 4 MHA heads of 64, vocab 512),
max_len 64, greedy, as the JAX package's control-plane tests build theirs
(``tests/test_async.py``): its default ``ParallelConfig`` (chunked
admission of 256, pure-JAX attention), the gammas perturbed as in
``tests/test_torch_model.py``.  A stream that differs from the
reference's is certified at its first differing step by a top-2 gap below
1e-2 in the port's logits there, or in the reference's own teacher-forced
logits (``tests/test_torch_continuous.py``).
"""
import numpy as np

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.runtime.engine import Engine
from test_torch_continuous import TIE_GAP, jax_top2_gap, top2_gap
from test_torch_model import jax_engine

MAX_LEN = 64


def make_engines(**parallel_kw):
    """(JAX engine, port engine) of reduced yi-9b on the same weights, both
    with ``parallel_kw`` on their ParallelConfig."""
    jcfg, tcfg = jget_config("yi-9b").reduced(), get_config("yi-9b").reduced()
    jeng, tree = jax_engine(jcfg, MAX_LEN, **parallel_kw)
    teng = Engine(tcfg, parallel=ParallelConfig(**parallel_kw), sampling=SamplingConfig(top_k=1),
                  max_len=MAX_LEN, params=bridge.params_from_jax(tree, tcfg, device="cpu"),
                  device="cpu")
    return jeng, teng


def clear_hooks(*engines) -> None:
    """Fault-planned schedulers install ``dispatch_hook`` on their engine;
    a module-scoped engine drops it after each test."""
    for eng in engines:
        eng.dispatch_hook = None


def poisson_requests(vocab, n=8, seed=0, lam=3.0, eos_id=None, plen=(4, 20), max_new=(4, 12)):
    """tests/test_async.py's seeded Poisson arrivals on the virtual clock:
    (prompt, max_new, eos_id, arrival_step) per request."""
    rng = np.random.default_rng(seed)
    arrival, reqs = 0, []
    for _ in range(n):
        p = rng.integers(0, vocab, int(rng.integers(*plen))).astype(np.int32)
        reqs.append((p, int(rng.integers(*max_new)), eos_id, arrival))
        arrival += int(rng.poisson(lam))
    return reqs


def run_sched(sched, reqs, **submit_kw):
    """Submit (prompt, max_new, eos, arrival) requests, run, and return
    (rid -> Request, the (rid, token) emission trace, the retire order)."""
    events = []
    sched.on_token = lambda rid, t: events.append((rid, int(t)))
    for p, mn, eos, arr in reqs:
        sched.submit(p, mn, eos_id=eos, arrival_step=arr, **submit_kw)
    done = sched.run()
    return {r.rid: r for r in done}, events, [r.rid for r in done]


def assert_same_streams(teng, port: dict, ref: dict, max_flips: int = 2, jeng=None) -> int:
    """Per request (rid -> Request): the same greedy tokens and finish
    reason as the reference, or a first difference at a near-tie of the
    port's logits after the prompt and the reference's tokens before it
    (or of the reference engine ``jeng``'s own logits there).
    Returns the number of parted streams (at most ``max_flips``: this
    model's 4 heads of 64 give near-ties, e.g. two of tests/test_async.py's
    six spec-workload streams part at top-2 gaps of 0.006 and 0.001)."""
    assert sorted(port) == sorted(ref)
    flips = 0
    for rid, r in ref.items():
        a, b = port[rid].output, r.output
        assert a.dtype == np.int32 and ((a >= 0) & (a < teng.cfg.vocab_size)).all()
        if np.array_equal(a, b):
            assert port[rid].finish_reason == r.finish_reason, rid
            continue
        n = min(len(a), len(b))
        t = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
        gap = top2_gap(teng, r.prompt, b[:t])
        if gap >= TIE_GAP and jeng is not None:
            gap = jax_top2_gap(jeng, r.prompt, b[:t])
        assert gap < TIE_GAP, f"request {rid} differs at step {t} with top-2 gap {gap}"
        flips += 1
    assert flips <= max_flips
    return flips


def assert_same_stats(tsched, jsched, keys) -> None:
    """The counters the two schedulers share, equal (a key a dense
    scheduler lacks, such as "preemptions", is skipped)."""
    for key in keys:
        if key not in jsched.stats:
            continue
        assert tsched.stats[key] == jsched.stats[key], (key, tsched.stats[key],
                                                        jsched.stats[key])
