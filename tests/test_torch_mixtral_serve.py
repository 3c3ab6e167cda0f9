"""mixtral-8x7b's greedy streams through the continuous scheduler against
the JAX package's on the same weights: chunks of 16 (every prompt in
several) and spec decode of 4 drafts, prompts and budgets long enough that
chunks and verify steps land on slot rings that have wrapped, over bf16 and
int8 K/V, and held to the port's own whole-prompt admission and plain
decode, as the reference holds itself; and chunks of 64 into 5 slots past
256 tokens, where the rows not admitted take expert capacity
(``moe.RowLayout`` over the ring).

Config and reference as tests/test_torch_mixtral.py.  Streams are identical
except at a certified near-tie: either side's top-2 gap below 1e-2, or
``test_torch_mixtral.router_parting`` (the port teacher-forced along the
reference's tokens, routing as the reference routed, within 5e-2 of its
logits, and the port's token within 5e-2 of the reference's top or a
router near-tie on the way).  Random 4-expert routing parts most streams of
this length somewhere, so every stream may part, each certified.
"""
import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro_torch.models import moe
from repro_torch.runtime.scheduler import ContinuousScheduler
from test_torch_continuous import assert_streams_match, serve
from test_torch_mixtral import CHUNK, SPEC_K, engines, requests, router_parting


def assert_parted_at_ties(port, ref, reqs, teng, certify, what):
    """Per request: ``port``'s stream (``what``: against the reference or the
    port's other path) equals ``ref``'s, or parts where the logits' top-2
    gap or ``certify`` allows it."""
    assert_streams_match(teng, reqs, port, ref, max_flips=len(reqs), certify=certify)
    return {rid: bool(np.array_equal(port[rid].output, ref[rid].output)) for rid in port}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_chunked_streams_match_jax(kv_quant, monkeypatch):
    """The continuous scheduler in chunks of 16 (every prompt in several)
    on a ring that wraps while the slots decode: the reference's chunked
    streams, and the port's own whole-prompt admission's, per request
    equal or parted at a certified near-tie (random 4-expert routing parts
    most streams of this length somewhere; each parting is held to the
    reference's logits along its tokens, ``router_parting``)."""
    jeng, _, teng = engines(kv_quant=kv_quant)
    reqs = requests(teng.cfg.vocab_size, seed=3)
    kw = dict(n_slots=2, block_steps=4, prefill_chunk=CHUNK)
    sched = ContinuousScheduler(teng, **kw)
    chunked = serve(sched, reqs)
    assert sched.stats["chunked_admissions"] == len(reqs)
    assert sched.stats["mixed_decode_steps"] > 0
    certify = router_parting(jeng, teng, monkeypatch)
    assert_parted_at_ties(chunked, serve(JContinuousScheduler(jeng, **kw), reqs), reqs, teng,
                          certify, "reference")
    whole = serve(ContinuousScheduler(teng, n_slots=2, block_steps=4, prefill_chunk=0), reqs)
    assert_parted_at_ties(chunked, whole, reqs, teng, certify, "whole")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_spec_streams_match_jax(kv_quant, monkeypatch):
    """Spec decode of 4 drafts (a 68-entry ring: 4 slack entries) in chunks
    of 16, verify steps at frontiers past the wrap, drafts partly rejected:
    the reference's spec streams, and the port's plain decode's, per
    request equal or parted at a certified near-tie."""
    jeng, _, teng = engines(kv_quant=kv_quant)
    reqs = requests(teng.cfg.vocab_size, seed=13, budget=(16, 28))
    kw = dict(n_slots=2, block_steps=2, prefill_chunk=CHUNK)
    sched = ContinuousScheduler(teng, spec_k=SPEC_K, **kw)
    spec = serve(sched, reqs)
    st = sched.stats
    assert st["spec_steps"] > 0 and st["spec_accepted"] < st["spec_proposed"]
    assert sched.caches["pos"].shape[1] == teng.cfg.window + SPEC_K
    assert any(len(p) + m > teng.cfg.window + SPEC_K for p, m, *_ in reqs)
    certify = router_parting(jeng, teng, monkeypatch, chunk=SPEC_K + 1)
    assert_parted_at_ties(spec, serve(JContinuousScheduler(jeng, spec_k=SPEC_K, **kw), reqs),
                          reqs, teng, certify, "reference")
    plain = serve(ContinuousScheduler(teng, spec_k=0, **kw), reqs)
    assert_parted_at_ties(spec, plain, reqs, teng, certify, "plain")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_chunks_past_256_tokens_route_the_full_width(kv_quant, monkeypatch):
    """Chunks of 64 into 5 slots with staggered arrivals: a mixed step whose
    rows are not all admitted routes 5 x 64 = 320 tokens in the reference
    (C = 200, assignments dropped), the rows not admitted as a ring chunk
    at offset 0 with one real column over their own ring.  The port
    carries those rows so (``moe.RowLayout`` over the ring) and serves the
    reference's streams."""
    jeng, _, teng = engines(kv_quant=kv_quant)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, teng.cfg.vocab_size, int(rng.integers(50, 65))).astype(np.int32),
             10, None, 3 * i) for i in range(5)]
    kw = dict(n_slots=5, block_steps=4, prefill_chunk=64)
    monkeypatch.setattr(moe, "LOG", [])
    port = serve(ContinuousScheduler(teng, **kw), reqs)
    full = [r for r in moe.LOG if r["T"] == 320]
    assert full and sum(len(moe.dropped(r)) for r in full) > 0
    monkeypatch.setattr(moe, "LOG", None)
    assert_streams_match(teng, reqs, port, serve(JContinuousScheduler(jeng, **kw), reqs),
                         jeng=jeng, certify=router_parting(jeng, teng, monkeypatch, chunk=64))
