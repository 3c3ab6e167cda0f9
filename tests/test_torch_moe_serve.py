"""deepseek-moe-16b's greedy streams through every scheduler against the JAX
package's on the same weights: the wave, the dense slot engine (whole
prompts, chunks of 16 with spec decode of 3 drafts) and the paged pool
(behind a shared prompt), in bf16, int4 weights and over the int8 KV
cache; and a whole-prompt admission whose reference forward routes 512
tokens, so that the pad rows of the slots not admitted take expert
capacity (``moe.RowLayout``).

Config and reference as tests/test_torch_moe.py (``deepseek-moe-16b.reduced()``,
the pure-JAX path).  Streams are identical except at a near-tie certified
by the port's or the reference's top-2 gap (< 1e-2,
``test_torch_continuous.assert_streams_match`` with ``jeng``).
"""
import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch.models import moe
from repro_torch.runtime.scheduler import ContinuousScheduler, WaveScheduler
from test_torch_continuous import assert_streams_match, serve, shared_prompt_requests
from test_torch_mla import _sched, requests
from test_torch_moe import engines

# one cache length for every engine of this file: the 128-token bucket of
# the full-width admission fits, and each setting builds its engines once
CHUNK, SPEC_K, MAX_LEN = 16, 3, 160


def test_wave_tokens_match_jax():
    jeng, _, teng = engines(max_len=MAX_LEN)
    reqs = [(p, m, None, 0) for p, m, *_ in requests(teng.cfg.vocab_size, seed=1)]
    port, ref_ = serve(WaveScheduler(teng, 2), reqs), serve(JWaveScheduler(jeng, batch_size=2),
                                                            reqs)
    assert_streams_match(teng, reqs, port, ref_, jeng=jeng)


@pytest.mark.parametrize("mode,kv_quant,kind,chunk,spec_k", [
    ("none", False, "dense", CHUNK, SPEC_K),
    ("none", False, "paged", 0, 0), ("none", False, "paged", CHUNK, SPEC_K),
    ("int4", False, "paged", CHUNK, SPEC_K), ("none", True, "paged", CHUNK, SPEC_K)])
def test_slot_tokens_match_jax(mode, kv_quant, kind, chunk, spec_k):
    """The dense slot engine in chunks of 16 with spec decode (its
    whole-prompt admission is the next test's) and the paged pool (behind
    a shared 16-token prompt: prefix reuse), whole prompts or chunks of 16
    with spec decode, in bf16, int4 weights and over the int8 KV cache."""
    jeng, _, teng = engines(mode, kv_quant, MAX_LEN)
    vocab = teng.cfg.vocab_size
    reqs = shared_prompt_requests(vocab, n=4, seed=8) if kind == "paged" else requests(vocab)
    kw = dict(prefill_chunk=chunk, spec_k=spec_k)
    tsched = _sched(kind, teng, False, **kw)
    port, ref_ = serve(tsched, reqs), serve(_sched(kind, jeng, True, **kw), reqs)
    assert_streams_match(teng, reqs, port, ref_, jeng=jeng)
    if kind == "paged":
        tsched.alloc.audit()
        assert tsched.stats["prefill_tokens_saved"] > 0
    if spec_k:
        assert tsched.stats["spec_steps"] > 0


def test_admission_past_256_tokens_routes_the_full_width(monkeypatch):
    """Whole-prompt admission into 4 slots at a 128-token bucket: the
    reference routes all 4 x 128 tokens, pad rows of the slots not admitted
    included (C = 320, and the pad tokens, which all route alike, overflow
    their experts).  The port carries those rows (``RowLayout``), drops
    assignments at T = 512, and serves the reference's streams."""
    jeng, _, teng = engines(max_len=MAX_LEN)
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, teng.cfg.vocab_size, int(rng.integers(70, 120))).astype(np.int32),
             6, None, 4 * i) for i in range(3)]
    monkeypatch.setattr(moe, "LOG", [])
    kw = dict(n_slots=4, block_steps=4, prefill_chunk=0)
    port = serve(ContinuousScheduler(teng, **kw), reqs)
    full = [r for r in moe.LOG if r["T"] == 512]
    assert full and sum(len(moe.dropped(r)) for r in full) > 0
    assert_streams_match(teng, reqs, port, serve(JContinuousScheduler(jeng, **kw), reqs),
                         jeng=jeng)
