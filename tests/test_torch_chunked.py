"""Chunked admission: the port's fused mixed prefill/decode step against the
JAX package's, on the same weights, over the dense slot cache and the paged
pool.

Both sides run ``prefill_chunk=8``, so prompts of 20..44 tokens stream in
3..6 chunks while the other slots decode, and every chunk is at most
``VERIFY_WIDTH`` wide: it attends the slot's stripe through flash_verify
(dense) or its view through paged_flash_prefill (paged).  The JAX side
runs ``use_pallas=True`` (interpret mode), reduced yi-9b with the GQA
head_dim-128 variant, max_len 64.  Per request the greedy tokens agree up
to certified near-ties (top-2 gap < 1e-2, tests/test_torch_continuous.py),
and the stats the two schedulers share agree exactly.  Within the port,
chunked admission gives whole-prompt admission's tokens.

The mixed step's decode half rides admitting slots frozen; their stale
decode position may lie inside the chunk just written, so the step must
keep that write out of the cache: the byte checks here compare the step
with and without a live decode half.
"""
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch.runtime.kvcache import POOL_KEYS
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from test_torch_continuous import (MAX_LEN, assert_streams_match, engines,  # noqa: F401
                                   serve, shared_prompt_requests)

CHUNK = 8
SHARED_STATS = ("decode_steps", "emitted", "active_slot_steps", "admission_rounds",
                "in_flight_admissions", "prefill_calls", "prefill_tokens", "prefill_chunks",
                "chunked_admissions")
PAGED_STATS = ("prefill_tokens_saved", "shared_block_hits", "preemptions", "blocks_hwm",
               "deferred_admissions")


def long_requests(vocab, n=5, seed=0):
    """Prompts of 20..44 tokens (3..6 chunks of 8), budgets 3..8, one
    arrival every 2 decode steps."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(20, 45))).astype(np.int32),
             int(rng.integers(3, 9)), None, 2 * i) for i in range(n)]


WORKLOADS = {"long": lambda v: long_requests(v),
             # a 16-token system prompt: later requests resume after it
             "shared_prompt": lambda v: shared_prompt_requests(v, n=5, seed=8)}


def make(kind, eng, chunk, jax_side=False):
    if kind == "paged":
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, prefill_chunk=chunk, block_size=8)
    cls = JContinuousScheduler if jax_side else ContinuousScheduler
    return cls(eng, n_slots=3, block_steps=4, prefill_chunk=chunk)


@pytest.mark.parametrize("kind,workload", [("dense", "long"), ("paged", "long"),
                                           ("paged", "shared_prompt")])
def test_chunked_tokens_and_stats_match_jax(engines, kind, workload):
    jeng, teng = engines
    reqs = WORKLOADS[workload](teng.cfg.vocab_size)
    jsched, tsched = make(kind, jeng, CHUNK, jax_side=True), make(kind, teng, CHUNK)
    ref, port = serve(jsched, reqs), serve(tsched, reqs)
    assert_streams_match(teng, reqs, port, ref)
    for key in SHARED_STATS + (PAGED_STATS if kind == "paged" else ()):
        assert tsched.stats[key] == jsched.stats[key], key
    assert tsched.stats["chunked_admissions"] > 0
    assert tsched.stats["prefill_chunks"] > len(reqs)
    assert tsched.stats["mixed_decode_steps"] > 0          # decode went on during admission
    if kind == "paged":
        tsched.alloc.audit()
        assert (tsched.stats["prefill_tokens_saved"] > 0) == (workload == "shared_prompt")


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_chunked_matches_whole_prompt(engines, kind):
    """Within the port: chunked admission gives whole-prompt admission's
    greedy tokens (up to certified near-ties)."""
    _, teng = engines
    reqs = long_requests(teng.cfg.vocab_size, seed=1)
    whole = serve(make(kind, teng, 0), reqs)
    chunked = serve(make(kind, teng, CHUNK), reqs)
    assert_streams_match(teng, reqs, chunked, whole)


def _live_and_admitting(teng, kind):
    """Slot 0 holds a live 6-token request; slot 1 is mid-admission, its
    first chunk written, its stale decode position (3) inside that chunk.
    -> (caches, block tables or None, host slot state, the second chunk)."""
    rng = np.random.default_rng(3)
    p0, p1 = (rng.integers(0, teng.cfg.vocab_size, n).astype(np.int32) for n in (6, 20))
    toks = np.zeros((2, 8), np.int32)
    toks[0, :6] = p0
    admit0 = np.array([True, False])
    if kind == "paged":
        caches = teng.init_paged_caches(2, 9, 8)
        bt = np.array([[1, 2, 0, 0, 0, 0, 0, 0], [3, 4, 5, 0, 0, 0, 0, 0]], np.int32)
        first = teng.prefill_into_slots_paged(caches, toks, admit0, np.array([6, 1]),
                                              np.zeros(2, np.int32), np.array([6, 1]), bt)
    else:
        caches, bt = teng.init_slot_caches(2), None
        first = teng.prefill_into_slots(caches, toks, admit0, np.array([6, 1]))
    state = dict(tok=np.array([first[0], 0], np.int32), pos=np.array([6, 3], np.int32),
                 done=np.array([True, True]), remaining=np.array([5, 0], np.int32),
                 eos=np.full(2, -1, np.int32))
    ctok = np.zeros((2, CHUNK), np.int32)
    ctok[1] = p1[:CHUNK]
    teng.mixed_step(caches, ctok, np.array([False, True]), np.array([1, CHUNK]),
                    np.zeros(2, np.int32), np.array([1, CHUNK]), **state, block_tables=bt)
    ctok[1] = p1[CHUNK:2 * CHUNK]
    return caches, bt, state, ctok


def _slot_bytes(caches, bt, slot):
    """Slot ``slot``'s K and V as (L, hkv, view, hd) -- through its blocks,
    if paged -- and its position row."""
    keys = [k for k in POOL_KEYS if k in caches]
    if bt is None:
        kv = [caches[k][:, slot].clone() for k in keys]
    else:
        blocks = torch.from_numpy(bt[slot][bt[slot] > 0]).long()
        kv = [caches[k][:, blocks].transpose(1, 2).flatten(2, 3).clone() for k in keys]
    return kv + [caches["pos"][slot].clone()]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_mixed_step_keeps_live_and_admitting_bytes(engines, kind):
    """The second chunk of slot 1 with slot 0 decoding beside it: slot 1's
    bytes equal those of the same chunk with no decode half (its stale
    decode write at position 3 never lands), and slot 0's bytes change at
    its own decode position 6 only."""
    _, teng = engines
    results = {}
    for live in (True, False):
        caches, bt, state, ctok = _live_and_admitting(teng, kind)
        before = _slot_bytes(caches, bt, 0)
        state = dict(state, done=np.array([not live, True]))
        ptok, nxt, pos, done, rem, decoded = teng.mixed_step(
            caches, ctok, np.array([False, True]), np.array([1, CHUNK]),
            np.array([0, CHUNK]), np.array([1, 2 * CHUNK]), **state, block_tables=bt)
        results[live] = (_slot_bytes(caches, bt, 1), ptok[1])
        after = _slot_bytes(caches, bt, 0)
        assert decoded == live
        if live:
            assert pos.tolist() == [7, 3] and rem[0] == 4 and done[1] and nxt[1] == 0
            for a, b in zip(after[:2], before[:2]):
                changed = (a != b).any(dim=3).any(dim=1).any(dim=0)     # per view position
                assert changed.nonzero().flatten().tolist() == [6]
            np.testing.assert_array_equal(after[2].numpy()[:8], [0, 1, 2, 3, 4, 5, 6, -1])
        else:
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    for a, b in zip(results[True][0], results[False][0]):
        assert torch.equal(a, b)
    assert results[True][1] == results[False][1]
    np.testing.assert_array_equal(results[True][0][-1].numpy()[:2 * CHUNK + 1],
                                  list(range(2 * CHUNK)) + [-1])


def test_chunk_writes_drop_past_the_cache_end(engines):
    """A chunk whose last positions fall past the cache: those tokens are
    dropped, never clamped onto the entry at S - 1."""
    from repro_torch.models.attention import chunk_writes

    (rows, idx), src = chunk_writes(np.array([2, 0]), np.array([MAX_LEN - 3, 5]), 4, MAX_LEN,
                                    "cpu")
    assert rows.tolist() == [2, 2, 2, 0, 0, 0, 0]
    assert idx.tolist() == [MAX_LEN - 3, MAX_LEN - 2, MAX_LEN - 1, 5, 6, 7, 8]
    assert src.tolist() == [0, 1, 2, 4, 5, 6, 7]
    _, none = chunk_writes(np.array([1]), np.array([0]), 4, MAX_LEN, "cpu")
    assert none is None
