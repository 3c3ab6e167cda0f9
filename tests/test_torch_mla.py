"""Multi-head latent attention (minicpm3-4b) against the JAX package on the
same weights: the parameter tree and bridge, the latent cache in its three
layouts, prefill and decode logits in bf16 and int8/int4 weights, greedy
streams through the wave, the dense slot engine and the paged pool (whole
prompts, chunks of 16, spec decode with 3 drafts), and the identities the
reference's own MLA tests assert: chunked admission == whole-prompt
admission == solo generation, and spec decode == plain decode.

Config: ``minicpm3-4b.reduced()`` (2 layers, d 256, 4 heads, latent rank
32, nope 32 + rope 16, v 32, vocab 512), the reference built as
tests/test_torch_model.py builds it (``tp=1, dp=1, remat=False``, greedy,
seeded nonzero norm gammas) on its pure-JAX path: MLA runs in jnp there
whatever ``use_pallas`` says.

Tolerances: logits 5e-2, as tests/test_torch_model.py; streams identical
except where they part at a certified near-tie: a top-2 gap below 1e-2 in
the port's logits, as tests/test_torch_continuous.py certifies, or in the
reference's own teacher-forced logits (``assert_streams_match``'s ``jeng``).  The
latter is needed where the reference itself is at the tie: at one such
parting here its decode path and its own prefill forward pick different
tokens (gap 0.002 in its logits, 0.011 in the port's, whose MLA layer
equals the reference's bit for bit).  The port's own identities are
asserted token for token, as the reference asserts its own.
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
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import model as TM
from repro_torch.runtime import kvcache
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                           WaveScheduler)
from test_torch_continuous import assert_streams_match, serve, shared_prompt_requests
from test_torch_model import assert_logits_match, jax_engine

ARCH, MAX_LEN, CHUNK, SPEC_K = "minicpm3-4b", 64, 16, 3
MIXER = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_o")


def configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


def port_engine(tree, cfg, **parallel_kw):
    return Engine(cfg, parallel=ParallelConfig(**parallel_kw), sampling=SamplingConfig(top_k=1),
                  max_len=MAX_LEN, params=bridge.params_from_jax(tree, cfg, device="cpu"),
                  device="cpu")


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = configs()
    jeng, tree = jax_engine(jcfg, MAX_LEN)
    return jeng, tree, port_engine(tree, tcfg)


def requests(vocab, n=4, seed=0):
    """Prompts of 10..40 tokens (most longer than one 16-token chunk), some a
    repeated phrase (n-gram drafts find continuations), budgets 6..12, an
    arrival every 2 decode steps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = (np.tile(rng.integers(0, vocab, 5), 5) if i % 2 else
             rng.integers(0, vocab, int(rng.integers(10, 41))))
        out.append((p.astype(np.int32), int(rng.integers(6, 13)), None, 2 * i))
    return out


# ---------------------------------------------------------------------------
# Config, parameter tree, cache
# ---------------------------------------------------------------------------


def test_supported_at_tp1_refused_at_tp2():
    cfg = get_config(ARCH)
    for mode in ("none", "int8", "int4"):
        for tp in (1, 2, 4, 8):       # head-sharded at tp>1 (40 heads: 5 a rank at tp 8)
            TM.check_supported(cfg, ParallelConfig(tp=tp, weight_quant=mode))
    # the overlapped loop serves at tp>1 (world rank 0's round records);
    # what stays refused there: windowed MLA layers and kv_seq_shard
    TM.check_supported(cfg, ParallelConfig(tp=2, overlap_decode=True))
    with pytest.raises(NotImplementedError, match="kv_seq_shard with mla"):
        TM.check_supported(cfg, ParallelConfig(tp=2, dp=2, kv_seq_shard=True))
    with pytest.raises(NotImplementedError, match="mla with windowed"):
        TM.check_supported(dataclasses.replace(cfg, window=64, layer_pattern=("local_attn",)),
                           ParallelConfig(tp=2))
    caps = ArchCapabilities.from_config(cfg)
    assert caps.blockers == {} and caps.cache_layouts == ("dense", "latent", "paged")


def test_param_tree_and_bridge_follow_jax(engines):
    """The MLA mixer's leaves flatten into the layer dict with the JAX
    shapes, bit for bit; a fresh draw has the same shapes."""
    _, tree, teng = engines
    cfg = teng.cfg
    sub = tree["groups"][0]["sub0"]
    jleaves = {"norm1": sub["norm1"], "norm2": sub["norm2"], **sub["mixer"], **sub["ffn"]}
    assert set(TM.layer_param_defs(cfg, "mla")) == set(jleaves) == {*MIXER, "norm1", "norm2",
                                                                    "w_up", "w_gate", "w_down"}
    assert TM.layer_families(cfg) == {"mla": [0, 1]}
    bits = lambda t: t.view(torch.int16).numpy()
    for i, layer in enumerate(teng.params["layers"]):
        for name, leaf in jleaves.items():
            np.testing.assert_array_equal(bits(layer[name]), leaf[i].view(np.int16), err_msg=name)
    fresh = TM.init_params(cfg, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh["layers"][0].items()} == \
        {k: tuple(v.shape[1:]) for k, v in jleaves.items()}


_QUANT = {}


def quant_engines(mode):
    """(JAX engine, port engine) on the same ``mode``-quantized weights,
    built once per module."""
    if mode not in _QUANT:
        jcfg, tcfg = configs()
        jeng, tree = jax_engine(jcfg, MAX_LEN, weight_quant=mode)
        _QUANT[mode] = jeng, port_engine(tree, tcfg, weight_quant=mode)
    return _QUANT[mode]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_weight_quant_leaves_mixer_bf16(mode):
    """The MLA mixer stays bf16; the MLP and the lm_head quantize, with the
    JAX package's bytes across the bridge."""
    _, tcfg = configs()
    params = quant_engines(mode)[1].params
    layer = params["layers"][0]
    assert {k for k, v in layer.items() if isinstance(v, QuantWeight)} == {"w_up", "w_gate",
                                                                           "w_down"}
    assert isinstance(params["lm_head"], QuantWeight)
    fresh = TM.init_params(tcfg, ParallelConfig(weight_quant=mode), device="cpu")
    assert not any(isinstance(fresh["layers"][0][k], QuantWeight) for k in MIXER)
    ref_p = TM.quantize_params(TM.init_params(tcfg, device="cpu"),
                               ParallelConfig(weight_quant=mode))
    for name in ("w_up", "w_down"):
        assert torch.equal(fresh["layers"][1][name].q, ref_p["layers"][1][name].q)
    wb = TM.decode_weight_bytes(tcfg, ParallelConfig(weight_quant=mode))
    assert wb["quantized_ref_einsum"] == 0 and wb["quantized"] > 0


@pytest.mark.parametrize("layout", ["wave", "slots", "paged"])
def test_latent_cache_layouts(layout):
    """ckv/krope with a unit head axis in every layout; kv_quant leaves the
    latents bf16 with no scales, as the reference's latent cache."""
    cfg = get_config(ARCH).reduced()
    kw = dict(per_slot=True) if layout == "slots" else \
        dict(paged=(9, 8)) if layout == "paged" else {}
    c = TM.init_caches(cfg, 3, 32, device="cpu", kv_quant=True, **kw)
    lead = (2, 9, 1, 8) if layout == "paged" else (2, 3, 1, 32)
    assert set(c) == {"ckv", "krope", "pos"}
    assert c["ckv"].shape == (*lead, 32) and c["krope"].shape == (*lead, 16)
    assert c["ckv"].dtype == c["krope"].dtype == torch.bfloat16
    assert set(kvcache.POOL_KEYS) >= {"ckv", "krope"}


# ---------------------------------------------------------------------------
# Logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
def test_prefill_and_decode_logits_match_jax(engines, mode):
    """Prefill and 8 teacher-forced decode steps within 5e-2."""
    jeng, _, teng = engines if mode == "none" else (*quant_engines(mode)[:1], None,
                                                    quant_engines(mode)[1])
    assert_logits_match(jeng, teng.cfg, teng.params)


def test_rope_covers_the_rope_dims_only(engines):
    """A planted fault, RoPE tables at the GQA head_dim (64) where MLA
    rotates 16 dims, must fail the tolerance."""
    jeng, _, teng = engines
    bad = dataclasses.replace(teng.cfg, mla=dataclasses.replace(teng.cfg.mla,
                                                                qk_rope_head_dim=8))
    with pytest.raises((AssertionError, RuntimeError)):
        assert_logits_match(jeng, bad, teng.params)


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------


def test_wave_tokens_match_jax(engines):
    jeng, _, teng = engines
    reqs = [(p, m, None, 0) for p, m, *_ in requests(teng.cfg.vocab_size, seed=1)]
    port, ref_ = serve(WaveScheduler(teng, 2), reqs), serve(JWaveScheduler(jeng, batch_size=2),
                                                            reqs)
    for rid, (p, m, *_) in enumerate(reqs):
        assert len(port[rid].output) == m
        np.testing.assert_array_equal(port[rid].output, ref_[rid].output)


def _sched(kind, eng, jax_side, **kw):
    if kind == "paged":
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, block_size=8, **kw)
    cls = JContinuousScheduler if jax_side else ContinuousScheduler
    return cls(eng, n_slots=3, block_steps=4, **kw)


@pytest.mark.parametrize("kind,chunk,spec_k", [("dense", 0, 0), ("dense", CHUNK, 0),
                                               ("paged", 0, 0), ("dense", CHUNK, SPEC_K),
                                               ("paged", CHUNK, SPEC_K)])
def test_slot_tokens_match_jax(engines, kind, chunk, spec_k):
    """Continuous batching over the dense latent stripes and the paged
    latent pools (behind a shared 16-token prompt: prefix reuse), whole
    prompts or chunks of 16, with and without spec decode."""
    jeng, _, teng = engines
    vocab = teng.cfg.vocab_size
    reqs = shared_prompt_requests(vocab, n=5, seed=8) if kind == "paged" else requests(vocab)
    kw = dict(prefill_chunk=chunk, spec_k=spec_k)
    tsched = _sched(kind, teng, False, **kw)
    port, ref_ = serve(tsched, reqs), serve(_sched(kind, jeng, True, **kw), reqs)
    assert_streams_match(teng, reqs, port, ref_, jeng=jeng)
    if kind == "paged":
        tsched.alloc.audit()
        assert tsched.stats["prefill_tokens_saved"] > 0
    if chunk and kind == "dense":
        assert tsched.stats["chunked_admissions"] > 0 and tsched.stats["mixed_decode_steps"] > 0
    if spec_k:
        assert tsched.stats["spec_steps"] > 0


def test_int4_slot_tokens_match_jax():
    """int4 weights through the paged pool in chunks with spec decode (int8
    weights are held at the logits)."""
    jeng, teng = quant_engines("int4")
    reqs = shared_prompt_requests(teng.cfg.vocab_size, n=4, seed=9)
    kw = dict(prefill_chunk=CHUNK, spec_k=SPEC_K)
    port = serve(_sched("paged", teng, False, **kw), reqs)
    assert_streams_match(teng, reqs, port, serve(_sched("paged", jeng, True, **kw), reqs),
                         jeng=jeng)


def test_chunked_equals_whole_and_solo(engines):
    """The reference's MLA identity: chunked admission (chunks of 8, every
    prompt in more than one) gives whole-prompt admission's tokens and
    each request's solo generation's, token for token."""
    _, _, teng = engines
    reqs = [(p, m, None, 0) for p, m, *_ in requests(teng.cfg.vocab_size, seed=3)]
    whole = serve(ContinuousScheduler(teng, n_slots=2, block_steps=4, prefill_chunk=0), reqs)
    sched = ContinuousScheduler(teng, n_slots=2, block_steps=4, prefill_chunk=8)
    chunked = serve(sched, reqs)
    assert sched.stats["chunked_admissions"] == len(reqs)
    for rid, (p, m, *_) in enumerate(reqs):
        np.testing.assert_array_equal(chunked[rid].output, whole[rid].output)
        np.testing.assert_array_equal(chunked[rid].output, teng.generate(p[None], m)[0])


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_equals_plain(engines, kind):
    """The reference's MLA identity: greedy spec decode emits plain
    decode's tokens, token for token."""
    _, _, teng = engines
    reqs = requests(teng.cfg.vocab_size, seed=13)
    base = serve(_sched(kind, teng, False, prefill_chunk=CHUNK), reqs)
    sched = _sched(kind, teng, False, prefill_chunk=CHUNK, spec_k=4)
    spec = serve(sched, reqs)
    assert sched.stats["spec_steps"] > 0
    for rid in base:
        np.testing.assert_array_equal(spec[rid].output, base[rid].output)
