"""Speculative decoding: the port's n-gram drafter, the plain version of its
flash_verify kernel and its fused verify step against the JAX package's,
and spec decode against plain decode within the port.

Greedy spec decode gives plain decode's tokens by construction (a draft is
accepted only where it equals the model's own choice), but the reference
itself parts width-(K+1) verify from width-1 decode by one bf16 ulp, so
identity is held at ``max_new <= 30`` and a stream that parts is certified
at its first differing step by a top-2 gap < 1e-2 (as
tests/test_torch_continuous.py does).  The JAX side runs ``use_pallas=True``
(interpret mode) on reduced yi-9b with the GQA head_dim-128 variant,
max_len 64, ``spec_k=4``.

Random weights seldom follow an n-gram draft, so one run here drafts from
the plain run's own continuation: every draft is then right, which drives
the verify step's causal rows 1..K and its acceptance and rewind.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.kernels import ops as jops
from repro.runtime.drafter import NgramDrafter as JNgramDrafter
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro_torch.kernels import ops
from repro_torch.runtime.drafter import NgramDrafter
from repro_torch.runtime.kvcache import POOL_KEYS
from repro_torch.runtime.scheduler import ContinuousScheduler, PagedContinuousScheduler
from test_torch_continuous import (MAX_LEN, TIE_GAP, assert_streams_match,  # noqa: F401
                                   engines, serve, top2_gap)
from test_torch_kernels import DTYPES, _both, _np

K = 4
SPEC_STATS = ("spec_steps", "spec_slot_steps", "spec_proposed", "spec_accepted",
              "spec_emitted", "decode_steps", "emitted", "active_slot_steps",
              "prefill_calls", "prefill_chunks")


@pytest.mark.parametrize("k,ngram", [(1, 1), (4, 3), (7, 2)])
def test_drafter_matches_jax(k, ngram):
    """Identical drafts on seeded random histories: short ones, long ones
    over a small alphabet (many matches), and exact repeats."""
    rng = np.random.default_rng(k * 10 + ngram)
    hists = [rng.integers(0, 6, int(rng.integers(1, 40))) for _ in range(40)]
    hists += [np.tile(rng.integers(0, 50, 5), 3), np.array([7]), np.arange(30)]
    mine, ref = NgramDrafter(k, ngram_max=ngram), JNgramDrafter(k, ngram_max=ngram)
    for h in hists:
        np.testing.assert_array_equal(mine.propose(h), ref.propose(h))
    np.testing.assert_array_equal(mine.propose_many(hists), ref.propose_many(hists))
    assert mine.propose_many([]).shape == (0, k)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,hd", [
    (3, 8, 2, 5, 64, 128),        # yi-9b-like g = 4 at spec_k 4
    (2, 4, 4, 1, 40, 64),         # a width-1 chunk, MHA
    (2, 16, 2, 8, 130, 64),       # the widest verify chunk, g = 8, ragged stripe
])
def test_flash_verify_plain_matches_jax(b, hq, hkv, sq, sk, hd, dtype):
    """Over the stripes of a 5-slot cache read through ``rows``: row 0
    at its frontier, row 1 at the stripe's end with a pad row, and the
    last row with no valid key at all (all pad: exact zeros).  Tolerance
    that of tests/test_torch_kernels.py: 1e-5 fp32, 3e-2 bf16."""
    rng = np.random.default_rng(sq * sk + hd)
    n_cache = 5
    rows = np.array([4, 1, 3][:b], np.int32)
    jq, tq = _both(rng.standard_normal((b, hq, sq, hd)), dtype)
    jk, tk = _both(rng.standard_normal((n_cache, hkv, sk, hd)), dtype)
    jv, tv = _both(rng.standard_normal((n_cache, hkv, sk, hd)), dtype)
    q_pos = np.stack([sk // 3 + np.arange(sq), sk - sq + np.arange(sq)]
                     + [np.full(sq, -1)] * (b - 2)).astype(np.int32)
    q_pos[1, -1] = -1
    scale = 1.0 / np.sqrt(hd)
    out = ops.flash_verify(tq, tk, tv, torch.from_numpy(q_pos), scale,
                           rows=torch.from_numpy(rows))
    assert out.dtype == tq.dtype and out.shape == (b, hq, sq, hd)
    want = jops.flash_verify(jq, jk[rows], jv[rows], jnp.asarray(q_pos), scale)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)
    assert not _np(out)[q_pos[:, 0] < 0].any() and not _np(out)[1, :, -1].any()
    # the same function as flash_prefill over the same stripes
    prefill = ops.flash_prefill(tq, tk, tv, torch.from_numpy(q_pos), scale,
                                rows=torch.from_numpy(rows))
    assert torch.equal(out, prefill)


def make(kind, eng, spec_k, chunk, jax_side=False, **kw):
    if kind == "paged":
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, spec_k=spec_k, prefill_chunk=chunk,
                   block_size=8, **kw)
    cls = JContinuousScheduler if jax_side else ContinuousScheduler
    return cls(eng, n_slots=3, block_steps=4, spec_k=spec_k, prefill_chunk=chunk, **kw)


def spec_requests(vocab, n=5, seed=0):
    """Prompts of 8..20 tokens, some of them a repeated phrase (so n-gram
    lookups find continuations), budgets 10..30, an arrival every 2
    steps."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        if i % 2:
            p = np.tile(rng.integers(0, vocab, int(rng.integers(3, 6))), 4)[:20]
        else:
            p = rng.integers(0, vocab, int(rng.integers(8, 21)))
        reqs.append((p.astype(np.int32), int(rng.integers(10, 31)), None, 2 * i))
    return reqs


@pytest.mark.parametrize("kind,chunk", [("dense", 0), ("dense", 8), ("paged", 8)])
def test_spec_tokens_and_stats_match_jax(engines, kind, chunk):
    """spec_k 4, whole-prompt or chunked admission: per request the JAX
    package's tokens (certified near-ties aside).  The stats count every
    request, so they are compared on a rerun of the requests whose streams
    agreed, narrowed again until every stream of the rerun agrees: the
    port's stream of a request does not depend on its slot, but the
    reference's may part at another near-tie when the request lands in
    another slot.  At least three requests must remain.  A parting is
    certified by either side's teacher-forced top-2 gap (``jeng``): the
    reference's own stream can move to a near-tie of its own in the
    rerun's other slots."""
    jeng, teng = engines
    reqs = spec_requests(teng.cfg.vocab_size)
    ref, port = (serve(make(kind, e, K, chunk, jax_side=e is jeng), reqs) for e in engines)
    assert_streams_match(teng, reqs, port, ref, jeng=jeng)
    same = [rid for rid in port if np.array_equal(port[rid].output, ref[rid].output)]
    for _ in range(3):
        sub = [reqs[rid] for rid in same]
        jsched, tsched = make(kind, jeng, K, chunk, jax_side=True), make(kind, teng, K, chunk)
        ref, port2 = serve(jsched, sub), serve(tsched, sub)
        for new, rid in enumerate(same):
            assert np.array_equal(port2[new].output, port[rid].output)
        assert_streams_match(teng, sub, port2, ref, jeng=jeng)
        agree = [np.array_equal(port2[new].output, ref[new].output) for new in range(len(sub))]
        if all(agree):
            break
        same = [rid for rid, a in zip(same, agree) if a]
    assert all(agree) and len(sub) >= 3, (len(sub), agree)
    for key in SPEC_STATS:
        assert tsched.stats[key] == jsched.stats[key], key
    assert tsched.stats["spec_steps"] > 0 and tsched.stats["spec_accepted"] > 0
    assert tsched.stats["spec_proposed"] == K * tsched.stats["spec_slot_steps"]
    summary = tsched.request_summary()["spec"]
    assert summary["mean_tokens_per_step"] >= 1.0
    if kind == "paged":
        tsched.alloc.audit()
        assert tsched.alloc.used_count() == 0


class PlainContinuation:
    """A drafter that proposes what plain decode emitted next after the
    history: every draft is right until the request's budget ends."""

    def __init__(self, reqs, plain):
        self.seqs = [np.concatenate([p, plain[rid].output]) for rid, (p, *_) in enumerate(reqs)]

    def propose_many(self, histories):
        out = []
        for h in histories:
            seq = next(s for s in self.seqs if len(s) >= len(h) and np.array_equal(s[:len(h)], h))
            cont = seq[len(h):len(h) + K]
            out.append(np.concatenate([cont, np.zeros(K - len(cont), np.int64)]))
        return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_matches_plain_and_accepts_right_drafts(engines, kind):
    """Within the port, spec decode gives plain decode's tokens, with the
    n-gram drafter and with one whose drafts are all right; the latter
    accepts drafts, emits more than one token per verify step, and still
    gives plain decode's tokens."""
    _, teng = engines
    reqs = spec_requests(teng.cfg.vocab_size, seed=1)
    plain = serve(make(kind, teng, 0, 8), reqs)
    ngram = serve(make(kind, teng, K, 8), reqs)
    assert_streams_match(teng, reqs, ngram, plain)
    sched = make(kind, teng, K, 8)
    sched.drafter = PlainContinuation(reqs, plain)
    oracle = serve(sched, reqs)
    assert_streams_match(teng, reqs, oracle, plain)
    st = sched.stats
    assert st["spec_accepted"] > 0 and st["spec_emitted"] > 1.5 * st["spec_slot_steps"]
    if kind == "paged":
        sched.alloc.audit()


def _admit(teng, kind, plens, seed=0):
    """Two slots prefilled with random prompts of ``plens`` tokens -> (caches,
    block tables or None, first tokens, prompts)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, teng.cfg.vocab_size, int(n)).astype(np.int32) for n in plens]
    toks = np.zeros((2, max(plens)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    admit = np.ones(2, bool)
    if kind == "paged":
        caches = teng.init_paged_caches(2, 17, 8)
        bt = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
        first = teng.prefill_into_slots_paged(caches, toks, admit, np.asarray(plens),
                                              np.zeros(2, np.int32), np.asarray(plens), bt)
    else:
        caches, bt = teng.init_slot_caches(2), None
        first = teng.prefill_into_slots(caches, toks, admit, np.asarray(plens))
    return caches, bt, first, prompts


def _assert_same_or_tie(teng, prompt, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want)
    if not np.array_equal(got, want):
        t = int(np.argmax(got != want))
        assert top2_gap(teng, prompt, want[:t]) < TIE_GAP


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_exact_fit_at_cache_end(engines, kind):
    """Slots whose budgets fill the cache exactly, with drafts that are
    always rejected: each step writes K + 1 entries, the last ones past the
    cache's end, which are dropped (dense) or sink into the null block
    (paged) instead of landing on the entry at S - 1; the tokens are plain
    decode's and the frontier ends exactly at S."""
    _, teng = engines
    S, plens = MAX_LEN, np.array([MAX_LEN - 4, MAX_LEN - 6], np.int32)
    caches, bt, first, prompts = _admit(teng, kind, plens)
    state = dict(pos=plens.copy(), done=np.zeros(2, bool), remaining=S - plens,
                 eos=np.full(2, -1, np.int32))
    plain = copy.deepcopy(caches)
    toks, *_ = teng.decode_slots(plain, first, **state, n=6, block_tables=bt)
    want = [toks[:S - p, i] for i, p in enumerate(plens)]
    got = [[], []]
    tok, pos, done, rem = first, state["pos"], state["done"], state["remaining"]
    for _ in range(8):
        vt = np.full((2, K + 1), teng.cfg.vocab_size - 1, np.int32)
        vt[:, 0] = tok
        tg, ne, tok, pos, done, rem = teng.verify_slots(caches, vt, pos, done, rem,
                                                        state["eos"], block_tables=bt)
        for i in range(2):
            got[i].extend(tg[i, :ne[i]].tolist())
        if done.all():
            break
    assert pos.tolist() == [S, S]
    for i in range(2):
        _assert_same_or_tie(teng, prompts[i], got[i], want[i])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_verify_rewinds_active_rows_and_leaves_frozen_rows(engines, kind):
    """After a verify step the active slot's position row marks exactly
    [0, pos + n_emit) valid, and the frozen slot's K/V and position row
    keep their bytes (it is neither computed nor written)."""
    _, teng = engines
    plens = np.array([12, 16], np.int32)
    caches, bt, first, _ = _admit(teng, kind, plens, seed=1)
    keys = [k for k in POOL_KEYS if k in caches]
    frozen = ([caches[k][:, 1].clone() for k in keys] if bt is None
              else [caches[k][:, torch.from_numpy(bt[1]).long()].clone() for k in keys])
    frozen.append(caches["pos"][1].clone())
    vt = np.full((2, K + 1), teng.cfg.vocab_size - 1, np.int32)
    vt[:, 0] = first
    tg, ne, nxt, pos, done, rem = teng.verify_slots(
        caches, vt, plens, np.array([False, True]), np.array([20, 10], np.int32),
        np.full(2, -1, np.int32), block_tables=bt)
    assert ne[1] == 0 and pos[1] == plens[1] and nxt[1] == vt[1, 0] and rem[1] == 10
    assert 1 <= ne[0] <= K + 1 and pos[0] == plens[0] + ne[0] and rem[0] == 20 - ne[0]
    idx = np.arange(caches["pos"].shape[1])
    np.testing.assert_array_equal(caches["pos"][0].numpy(), np.where(idx < pos[0], idx, -1))
    after = ([caches[k][:, 1] for k in keys] if bt is None
             else [caches[k][:, torch.from_numpy(bt[1]).long()] for k in keys])
    after.append(caches["pos"][1])
    assert all(torch.equal(a, b) for a, b in zip(after, frozen))


def test_paged_blocks_track_the_rewound_frontier(engines):
    """The paged allocator's audit passes after every verify step, each
    active slot then holds exactly the blocks of its valid positions (the
    ones claimed for rejected drafts are freed), and every block returns
    when the requests drain."""
    _, teng = engines
    reqs = spec_requests(teng.cfg.vocab_size, n=4, seed=2)
    sched = make("paged", teng, K, 8)
    for prompt, max_new, eos, arrival in reqs:
        sched.submit(prompt, max_new, eos_id=eos, arrival_step=arrival)
    sched._init_caches()
    steps = 0
    while sched._serve_round():
        sched.alloc.audit()
        if sched.stats["spec_steps"] > steps:
            steps = sched.stats["spec_steps"]
            for i in sched._active_slots():
                assert len(sched.slot_blocks[i]) == -(-int(sched.pos[i]) // sched.bs)
    sched._retire()
    sched.alloc.audit()
    assert steps > 0 and sched.alloc.used_count() == 0 and len(sched.done) == len(reqs)
