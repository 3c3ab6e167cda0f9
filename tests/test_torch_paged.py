"""Continuous batching over the paged KV cache: the port's
``PagedContinuousScheduler`` against the JAX package's on the same weights
(``use_pallas=True``, so the JAX side runs its paged decode and paged
flash-prefill Pallas kernels in interpret mode; ``prefill_chunk=0`` on
both sides: whole-prompt admission), and the port's ``BlockAllocator`` on
its own.

Per request the greedy tokens agree up to certified near-ties (see
tests/test_torch_continuous.py), and the host bookkeeping agrees exactly:
tokens saved by prefix reuse, shared-block hits, preemptions and the
pool's high-water mark, with ``audit()`` passing at the end.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch.runtime.kvcache import NULL_BLOCK, POOL_KEYS, BlockAllocator
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from test_torch_continuous import (WORKLOADS, assert_streams_match, engines,  # noqa: F401
                                   serve, shared_prompt_requests)

STATS = ("prefill_tokens_saved", "shared_block_hits", "preemptions", "blocks_hwm",
         "prefill_calls", "prefill_tokens", "decode_steps", "emitted", "deferred_admissions")


def run_pair(engines, reqs, **kw):
    """The same requests through the JAX and the port's paged schedulers.
    The JAX dense scheduler runs too: its paged and dense backends round
    differently and can part at a near-tie themselves, and there the port
    may follow either."""
    jeng, teng = engines
    jsched = JPagedScheduler(jeng, **kw)
    tsched = PagedContinuousScheduler(teng, prefill_chunk=0, **kw)
    ref, port = serve(jsched, reqs), serve(tsched, reqs)
    dense = serve(JContinuousScheduler(jeng, n_slots=kw["n_slots"],
                                       block_steps=kw["block_steps"]), reqs)
    assert_streams_match(teng, reqs, port, ref, ref_other=dense)
    for key in STATS:
        assert tsched.stats[key] == jsched.stats[key], key
    tsched.alloc.audit()
    jsched.alloc.audit()
    return jsched, tsched, port


@pytest.mark.parametrize("workload,prefix_cache",
                         [(w, True) for w in sorted(WORKLOADS)] + [("shared_prompt", False)])
def test_paged_tokens_and_stats_match_jax(engines, workload, prefix_cache):
    """With the prefix cache off, a shared system prompt is prefilled anew
    by every request, and the paged flash-prefill path never runs."""
    reqs = WORKLOADS[workload](engines[1].cfg)
    _, tsched, _ = run_pair(engines, reqs, n_slots=3, block_steps=4, block_size=8,
                            prefix_cache=prefix_cache)
    assert tsched.stats["in_flight_admissions"] > 0
    assert 0 < tsched.stats["blocks_hwm"] < tsched.n_blocks     # occupancy, not worst case
    shared = workload == "shared_prompt" and prefix_cache
    assert (tsched.stats["prefill_tokens_saved"] > 0) == shared
    assert (tsched.stats["shared_block_hits"] > 0) == shared
    assert (tsched.stats["prefix_prefill_calls"] > 0) == shared
    if not prefix_cache:
        assert tsched.stats["prefill_tokens"] == sum(len(p) for p, *_ in reqs)


def test_overcommitted_pool_preempts_like_jax(engines):
    """A pool far below the dense footprint: admission defers, decode runs
    out of blocks and preempts the youngest request, which recomputes on
    readmission -- in the same places as in the JAX scheduler, and every
    request still gets its tokens."""
    reqs = shared_prompt_requests(engines[1].cfg.vocab_size, n=5, seed=9)
    reqs = [(p, 20, None, 0) for p, *_ in reqs]
    _, tsched, port = run_pair(engines, reqs, n_slots=3, block_steps=4, block_size=8,
                               n_blocks=12)
    assert tsched.stats["preemptions"] > 0 and tsched.stats["shared_block_hits"] > 0
    assert tsched.stats["emitted"] == sum(len(r.output) for r in port.values())
    assert all(len(r.output) == 20 for r in port.values())


def test_paged_matches_dense_port(engines):
    """The port's paged scheduler gives its dense scheduler's tokens (the
    cached prefix is attended through the paged kernel, the fresh prompt
    through the dense one)."""
    _, teng = engines
    reqs = shared_prompt_requests(teng.cfg.vocab_size, seed=5)
    dense = serve(ContinuousScheduler(teng, n_slots=3, block_steps=4, prefill_chunk=0), reqs)
    paged = serve(PagedContinuousScheduler(teng, n_slots=3, block_steps=4, block_size=8,
                                           prefill_chunk=0), reqs)
    assert_streams_match(teng, reqs, paged, dense)


def test_shared_blocks_are_never_written(engines):
    """The blocks of a registered prefix keep their bytes while a second
    request that shares them is admitted and decodes."""
    _, teng = engines
    reqs = shared_prompt_requests(teng.cfg.vocab_size, n=2, seed=6)
    sched = PagedContinuousScheduler(teng, n_slots=2, block_steps=2, block_size=8,
                                     prefill_chunk=0)
    sched.submit(reqs[0][0], 12)
    sched.submit(reqs[1][0], 6, arrival_step=3)
    sched._init_caches()
    while sched.slots[0].req is None:
        sched._serve_round()
    shared = sched.slot_blocks[0][:2]
    before = {k: sched.caches[k][:, shared].clone() for k in POOL_KEYS if k in sched.caches}
    while not any(r.rid == 1 for r in sched.done):
        sched._serve_round()
    assert sched.stats["shared_block_hits"] == 2
    assert sched.alloc.refcount(shared[0]) == 1               # the second request released it
    for k in before:
        assert torch.equal(sched.caches[k][:, shared], before[k]), k
    sched.run()
    sched.alloc.audit()


def test_allocator_refcounts_and_exhaustion():
    a = BlockAllocator(5, 4)
    blocks = a.alloc(3)
    assert NULL_BLOCK not in blocks and a.free_count() == 1
    assert a.alloc(2) is None and a.free_count() == 1          # never a partial grant
    a.incref(blocks[:1])
    a.free(blocks)
    assert a.refcount(blocks[0]) == 1 and a.free_count() == 3
    a.free(blocks[:1])
    assert a.free_count() == 4 and a.used_count() == 0
    a.audit()


def test_allocator_prefix_chain_verifies_tokens_and_evicts():
    a = BlockAllocator(8, 4)
    prompt = np.arange(10, dtype=np.int32)
    blocks = a.alloc(3)
    a.register_prefix(prompt, blocks[:2])                      # 2 full blocks
    assert a.match_prefix(np.concatenate([prompt[:8], [99, 98]])) == (blocks[:2], 8)
    other = prompt.copy()
    other[5] = 77                                              # second block differs
    assert a.match_prefix(other) == (blocks[:1], 4)
    a._prefix[next(iter(a._prefix))] = (blocks[0], (1, 2, 3, 4))   # a forged entry
    assert a.match_prefix(prompt) == ([], 0)                   # tokens are checked
    a.free(blocks)
    assert a.match_prefix(prompt) == ([], 0) and not a._prefix_of
    a.audit()


def test_allocator_audit_names_a_leak():
    a = BlockAllocator(4, 4)
    a.alloc(1)
    a._free[0].popleft()                                       # lose a block
    with pytest.raises(AssertionError, match="conservation"):
        a.audit()


def test_oversized_request_rejected(engines):
    sched = PagedContinuousScheduler(engines[1], n_slots=2, block_size=8, n_blocks=5)
    with pytest.raises(ValueError, match="blocks"):
        sched.submit(np.arange(30, dtype=np.int32), max_new=10)
