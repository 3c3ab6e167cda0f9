"""The int8 KV cache through the schedulers: the port's greedy streams
against the JAX package's with ``kv_quant=True``, on the same weights.

Reduced yi-9b with the GQA head_dim-128 variant, max_len 64; the JAX side
runs ``use_pallas=True`` (interpret mode), whose int8 paths dequantize the
cache in jnp and attend it through its Pallas kernels or jnp, while the
port quantizes and writes with its kv_quant_write kernel's plain version
and reads the int8 cache through its decode kernels' int8 path (plain
versions here).  The wave, the dense slot engine (whole prompts, chunks of
8, chunks with spec decode) and the paged pool behind a shared system
prompt (whole prompts, chunks, chunks with spec decode).  The paged int8
path attends a cached prefix through a dequantized view, a second
approximation of the same cache in the reference too, so a paged stream is
held to the JAX paged stream, and may follow the JAX dense stream where the
reference's two backends part.  Per request the tokens agree up to
certified near-ties (a top-2 gap below 1e-2 in the port's logits at the
first differing step, tests/test_torch_continuous.py), and the stats the
schedulers share agree exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                           WaveScheduler)
from test_torch_chunked import long_requests
from test_torch_continuous import MAX_LEN, assert_streams_match, serve, shared_prompt_requests
from test_torch_model import GQA, jax_engine

CHUNK, K = 8, 3
STATS = ("decode_steps", "emitted", "prefill_calls", "prefill_tokens", "admission_rounds",
         "in_flight_admissions")
PAGED_STATS = ("prefill_tokens_saved", "shared_block_hits", "preemptions", "blocks_hwm")
SPEC_STATS = ("spec_steps", "spec_proposed", "spec_accepted", "spec_emitted")


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same weights, both with the int8
    KV cache."""
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **GQA)
    tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **GQA)
    jeng, tree = jax_engine(jcfg, MAX_LEN, use_pallas=True, prefill_chunk=0, kv_quant=True)
    teng = Engine(tcfg, parallel=ParallelConfig(kv_quant=True),
                  sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    return jeng, teng


def test_caches_are_int8(engines):
    jeng, teng = engines
    for caches in (teng.init_caches(2), teng.init_slot_caches(2),
                   teng.init_paged_caches(2, 9, 8)):
        assert caches["k"].dtype == caches["v"].dtype == torch.int8
        assert caches["k_scale"].dtype == caches["v_scale"].dtype == torch.bfloat16
        assert caches["k_scale"].shape == caches["v_scale"].shape == caches["k"].shape[:-1]
    assert jeng.parallel.kv_quant


def test_wave_tokens_match_jax(engines):
    """Prompts of 5-30 tokens in waves of two, 12 new tokens; a stream that
    parts is certified on its wave's right-padded prompt (pad id 0), which
    is what the wave ran."""
    jeng, teng = engines
    rng = np.random.default_rng(21)
    reqs = [(rng.integers(0, teng.cfg.vocab_size, int(n)).astype(np.int32), 12, None, 0)
            for n in (30, 5, 17, 22)]
    port, ref = serve(WaveScheduler(teng, 2), reqs), serve(JWaveScheduler(jeng, batch_size=2), reqs)
    wave_len = lambda rid: max(len(p) for p, *_ in reqs[rid - rid % 2: rid - rid % 2 + 2])
    padded = [(np.concatenate([p, np.zeros(wave_len(i) - len(p), np.int32)]), *rest)
              for i, (p, *rest) in enumerate(reqs)]
    assert_streams_match(teng, padded, port, ref)


def _make(kind, eng, jax_side, **kw):
    if kind == "paged":
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, block_size=8, **kw)
    cls = JContinuousScheduler if jax_side else ContinuousScheduler
    return cls(eng, n_slots=3, block_steps=4, **kw)


@pytest.mark.parametrize("kind,mode", [("dense", "whole"), ("paged", "whole"),
                                       ("dense", "chunked"), ("paged", "chunked"),
                                       ("dense", "spec"), ("paged", "spec")])
def test_slot_streams_match_jax(engines, kind, mode):
    """A shared 16-token system prompt before every request: the paged pool
    reuses it (its cached prefix read through the dequantized view), and
    chunks of 8 resume after it."""
    jeng, teng = engines
    kw = {"whole": dict(prefill_chunk=0), "chunked": dict(prefill_chunk=CHUNK),
          "spec": dict(prefill_chunk=CHUNK, spec_k=K)}[mode]
    reqs = (shared_prompt_requests(teng.cfg.vocab_size, n=5, seed=8) if mode != "chunked"
            else long_requests(teng.cfg.vocab_size, n=4))
    jsched, tsched = _make(kind, jeng, True, **kw), _make(kind, teng, False, **kw)
    ref, port = serve(jsched, reqs), serve(tsched, reqs)
    other = None
    if kind == "paged":     # the reference's dense stream, where its two backends part
        other = serve(_make("dense", jeng, True, **kw), reqs)
    assert_streams_match(teng, reqs, port, ref, ref_other=other)
    keys = STATS + (PAGED_STATS if kind == "paged" else ()) + (SPEC_STATS if mode == "spec" else ())
    for key in keys:
        assert tsched.stats[key] == jsched.stats[key], key
    if kind == "paged":
        tsched.alloc.audit()
        assert (tsched.stats["prefill_tokens_saved"] > 0) == (mode != "chunked")
    if mode != "whole":
        assert tsched.stats["prefill_chunks"] > 0
    if mode == "spec":
        assert tsched.stats["spec_steps"] > 0
