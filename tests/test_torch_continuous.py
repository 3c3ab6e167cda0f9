"""Continuous batching over the dense slot cache: per-request greedy tokens
of the port's ``ContinuousScheduler`` against the JAX package's, on the
same weights.

The JAX side runs ``use_pallas=True`` (Pallas in interpret mode); both
sides run ``prefill_chunk=0``, the whole-prompt bucketed admission (chunked
admission and spec decode are held in tests/test_torch_chunked.py and
tests/test_torch_spec.py); head_dim 128 and max_len 64.  Two workloads: the stragglers
of tests/test_paged.py (staggered arrivals, mixed budgets, an EOS id on
every third request) and a shared system prompt in front of every request.

Two implementations that round bf16 activations at different places can
flip a greedy choice where the top two logits nearly tie.  A stream that
differs is certified at its first differing step: the port's logits there,
teacher-forced along the JAX stream, must show a top-2 gap below 1e-2, as
tests/test_torch_serve.py certifies waves.  A slot's stream depends on its
own prompt only (other rows and the bucket's padding never reach it), so
the teacher-forced forward is the prompt followed by the JAX tokens.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401
from repro import compat
from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro_torch import bridge
from repro_torch.configs import SamplingConfig, get_config
from repro_torch.models import model as TM
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import ContinuousScheduler
from test_paged import straggler_requests
from test_torch_model import GQA, jax_engine

MAX_LEN, TIE_GAP = 64, 1e-2


def shared_prompt_requests(vocab, n=6, prefix=16, seed=4):
    """A 16-token system prompt (two 8-token blocks) before each request's
    own 3..10 tokens; budgets 4..12, arrivals every 2 decode steps, so later
    requests find the prefix resident in a request still running."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, prefix).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, vocab, int(rng.integers(3, 11)))
                             .astype(np.int32)]), int(rng.integers(4, 13)), None, 2 * i)
            for i in range(n)]


WORKLOADS = {"stragglers": lambda cfg: straggler_requests(cfg),
             "shared_prompt": lambda cfg: shared_prompt_requests(cfg.vocab_size)}


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same weights."""
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **GQA)
    tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **GQA)
    jeng, tree = jax_engine(jcfg, MAX_LEN, use_pallas=True, prefill_chunk=0)
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    return jeng, teng


def serve(sched, reqs):
    """Submit (prompt, max_new, eos, arrival) requests; run; rid -> Request."""
    for prompt, max_new, eos, arrival in reqs:
        sched.submit(prompt, max_new, eos_id=eos, arrival_step=arrival)
    return {r.rid: r for r in sched.run()}


def top2_gap(teng, prompt, tokens) -> float:
    """Top-2 logit gap of the port's greedy choice after ``prompt`` + ``tokens``."""
    seq = np.concatenate([prompt, np.asarray(tokens, np.int64)]).astype(np.int64)
    with torch.inference_mode():
        logits = TM.forward(teng.params, torch.from_numpy(seq)[None], teng.cfg,
                            last_only=True)[0, -1].numpy()
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


_JAX_FORWARD = {}


def jax_top2_gap(jeng, prompt, tokens) -> float:
    """Top-2 logit gap of the reference's own forward after ``prompt`` +
    ``tokens`` (its prefill, teacher-forced)."""
    if id(jeng) not in _JAX_FORWARD:
        sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)
        fwd = lambda p, t: JM.forward(p, t, jeng.ctx, seq_sharded=True)[0]
        _JAX_FORWARD[id(jeng)] = jax.jit(sm(fwd, in_specs=(JM.param_specs(jeng.ctx),
                                                           P("data", None)),
                                            out_specs=P("data", None, None)))
    seq = np.concatenate([prompt, np.asarray(tokens, np.int32)]).astype(np.int32)[None]
    logits = _JAX_FORWARD[id(jeng)](jeng.params, jnp.asarray(seq))
    top2 = np.sort(np.asarray(logits)[0, -1])[-2:]
    return float(top2[1] - top2[0])


def assert_streams_match(teng, reqs, port, ref, max_flips=1, ref_other=None, jeng=None,
                         certify=None):
    """Per request: identical greedy tokens, or a first difference at a
    certified near-tie.  ``ref_other`` holds the JAX package's streams from
    its other KV backend: where the reference's own two backends disagree on
    a request, the port may equal either.  With the reference engine
    ``jeng``, a near-tie in its own teacher-forced logits certifies a
    parting too (where the reference's decode and prefill paths
    themselves pick apart).  ``certify(prompt, tokens, token)`` (an MoE
    model) may certify a parting after the reference's ``tokens``, where
    the port chose ``token`` (None past the end of its stream), that the
    logits' gaps do not."""
    assert sorted(port) == sorted(ref) == list(range(len(reqs)))
    flips = 0
    for rid, (prompt, *_) in enumerate(reqs):
        a, b = port[rid].output, ref[rid].output
        assert a.dtype == np.int32 and ((a >= 0) & (a < teng.cfg.vocab_size)).all()
        if np.array_equal(a, b):
            assert port[rid].finish_reason == ref[rid].finish_reason
            continue
        if ref_other is not None and np.array_equal(a, ref_other[rid].output):
            continue
        n = min(len(a), len(b))
        t = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
        gap = top2_gap(teng, prompt, b[:t])
        if gap >= TIE_GAP and jeng is not None:
            gap = jax_top2_gap(jeng, prompt, b[:t])
        if gap >= TIE_GAP and certify is not None and certify(prompt, b[:t],
                                                              a[t] if t < len(a) else None):
            gap = 0.0
        assert gap < TIE_GAP, f"request {rid} differs at step {t} with top-2 gap {gap}"
        flips += 1
    assert flips <= max_flips          # flips are rare ties, not systematic drift


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_continuous_tokens_match_jax(engines, workload):
    jeng, teng = engines
    reqs = WORKLOADS[workload](teng.cfg)
    jsched = JContinuousScheduler(jeng, n_slots=3, block_steps=4)
    tsched = ContinuousScheduler(teng, n_slots=3, block_steps=4, prefill_chunk=0)
    ref, port = serve(jsched, reqs), serve(tsched, reqs)
    assert_streams_match(teng, reqs, port, ref)
    for key in ("decode_steps", "prefill_calls", "prefill_tokens", "admission_rounds",
                "in_flight_admissions", "emitted", "active_slot_steps"):
        assert tsched.stats[key] == jsched.stats[key], key
    assert tsched.stats["in_flight_admissions"] > 0


def test_admission_leaves_live_slots_untouched(engines):
    """An admission into slot 1 writes only slot 1: the live slot 0 keeps
    its K/V and positions bit for bit (the in-place counterpart of the JAX
    package's merge_slots)."""
    _, teng = engines
    caches = teng.init_slot_caches(2)
    toks = np.zeros((2, 8), np.int32)
    toks[0, :5] = np.arange(5) + 7
    toks[1, :6] = np.arange(6) + 40
    teng.prefill_into_slots(caches, toks, np.array([True, False]), np.array([5, 1]))
    before = [caches["k"][:, 0].clone(), caches["v"][:, 0].clone(), caches["pos"][0].clone()]
    first = teng.prefill_into_slots(caches, toks, np.array([False, True]), np.array([1, 6]))
    after = [caches["k"][:, 0], caches["v"][:, 0], caches["pos"][0]]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    np.testing.assert_array_equal(caches["pos"][1].numpy(),
                                  np.where(np.arange(MAX_LEN) < 6, np.arange(MAX_LEN), -1))
    assert first[0] == 0 and 0 <= first[1] < teng.cfg.vocab_size


def test_decode_slots_freezes_finished_rows(engines):
    """Inside one block of masked steps a row that runs out of budget or
    is already done keeps its token and position (the device's rule that
    the scheduler replays)."""
    _, teng = engines
    caches = teng.init_slot_caches(3)
    toks = np.tile(np.arange(8, dtype=np.int32) + 3, (3, 1))
    first = teng.prefill_into_slots(caches, toks, np.ones(3, bool), np.full(3, 8))
    out, pos, done, rem = teng.decode_slots(
        caches, first, np.full(3, 8), np.array([False, False, True]), np.array([4, 2, 0]),
        np.full(3, -1), n=4)
    assert out.shape == (4, 3)
    np.testing.assert_array_equal(pos, [12, 10, 8])
    np.testing.assert_array_equal(done, [True, True, True])
    np.testing.assert_array_equal(rem, [0, 0, 0])
    assert (out[2:, 1] == out[1, 1]).all() and (out[:, 2] == first[2]).all()
    np.testing.assert_array_equal(out[:2, 0], out[:2, 1])    # same prompt, both active
