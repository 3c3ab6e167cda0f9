"""The parallel residual (gptj-parallel) against the JAX package on the same
weights: the plain fused_dual_matmul against the Pallas kernel, the
parameter tree and bridge, prefill and decode logits, greedy streams
through every scheduler the port has, and weight quantization.

Config: ``gptj-parallel.reduced()`` (2 layers, d 256, 4 MHA heads of 64,
plain GELU FFN of 512, vocab 512), the reference built as ROADMAP's
parity contract says (``tp=1, dp=1, remat=False``, greedy) with
``use_pallas=True`` for the schedulers, so its flash-prefill, decode,
paged and top-k Pallas kernels run in interpret mode.  Norm gammas are
zero at init; they are overwritten with seeded values on both sides first.

Tolerances: the plain kernel 1e-4 in fp32 and 0.05 in bf16, as
tests/test_kernels.py holds the Pallas kernel; logits 5e-2, as
tests/test_torch_model.py.  The port's layer rounds differently from the
reference's on purpose: JAX rounds the attention and FFN partials to bf16
each and adds them in bf16, the fused kernel sums both products in fp32 and
rounds once.  Greedy streams that part are certified at a near-tie (top-2
gap < 1e-2) as tests/test_torch_continuous.py does; paged against dense
and spec by slot as ROADMAP Queue 3 records.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core.capabilities import ArchCapabilities as JArchCapabilities
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.core.wquant import QuantWeight
from repro_torch.kernels import ops, ref
from repro_torch.models import model as TM
from repro_torch.models import transformer
from repro_torch.models.common import rms_norm
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                           WaveScheduler)
from test_torch_continuous import (TIE_GAP, assert_streams_match, serve, shared_prompt_requests,
                                   top2_gap)
from test_torch_kernels import DTYPES, _both, _np
from test_torch_model import assert_logits_match, jax_engine

ARCH, MAX_LEN, K = "gptj-parallel", 64, 4
# the JAX package's kernel sweep (tests/test_kernels.py)
SWEEP = [(1, 64, 64, 64), (100, 300, 700, 200), (128, 512, 1728, 512), (257, 129, 65, 33)]


def configs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def engines():
    """(JAX engine with Pallas on, its numpy tree, port engine on the same
    weights)."""
    jcfg, tcfg = configs()
    jeng, tree = jax_engine(jcfg, MAX_LEN, use_pallas=True)
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    return jeng, tree, teng


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("t,ka,kb,d", SWEEP)
def test_fused_dual_matmul_plain_matches_jax(t, ka, kb, d, dtype):
    rng = np.random.default_rng(t + ka)
    ja, ta = _both(rng.standard_normal((t, ka)), dtype)
    jwa, twa = _both(rng.standard_normal((ka, d)) / np.sqrt(ka), dtype)
    jb, tb = _both(rng.standard_normal((t, kb)), dtype)
    jwb, twb = _both(rng.standard_normal((kb, d)) / np.sqrt(kb), dtype)
    out = ops.fused_dual_matmul(ta, twa, tb, twb)
    assert out.dtype == ta.dtype and out.shape == (t, d)
    tol = 1e-4 if dtype == "fp32" else 0.05
    for want in (jops.fused_dual_matmul(ja, jwa, jb, jwb), jref.fused_residual_ref(ja, jwa, jb, jwb)):
        np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused_dual_matmul_reads_heads_in_place(dtype):
    """Heads (n, h, s, hd) and w_o (h, hd, d) give the JAX kernel's result on
    the transposed (n * s, h * hd) matrix and the (h * hd, d) weight."""
    n, h, s, hd, kb, d = 2, 4, 5, 16, 24, 40
    rng = np.random.default_rng(7)
    heads, wo = rng.standard_normal((n, h, s, hd)), rng.standard_normal((h, hd, d)) / 8
    bmat, wb = rng.standard_normal((n * s, kb)), rng.standard_normal((kb, d)) / 5
    flat = heads.transpose(0, 2, 1, 3).reshape(n * s, h * hd)
    ja, jwa, jb, jwb = (_both(x, dtype)[0] for x in (flat, wo.reshape(h * hd, d), bmat, wb))
    out = ops.fused_dual_matmul(*(_both(x, dtype)[1] for x in (heads, wo, bmat, wb)))
    tol = 1e-4 if dtype == "fp32" else 0.05
    np.testing.assert_allclose(_np(out), _np(jops.fused_dual_matmul(ja, jwa, jb, jwb)),
                               atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="do not agree"):
        ops.fused_dual_matmul(*(_both(x, dtype)[1] for x in (heads, wo, bmat[1:], wb)))


# ---------------------------------------------------------------------------
# Config, parameter tree, capabilities
# ---------------------------------------------------------------------------


def test_config_and_capabilities_match_jax():
    """The same fields and parameter count; no capability blocker (JAX's
    docs/arch_capabilities.txt: chunked, spec and paged all served)."""
    for t, j in ((get_config(ARCH), jget_config(ARCH)), configs()[::-1]):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.param_count() == j.param_count()
        caps = ArchCapabilities.from_config(t)
        assert caps.blockers == {} and caps.cache_layouts == ("dense", "paged")
        assert dataclasses.asdict(caps) == dataclasses.asdict(JArchCapabilities.from_config(j))
    assert get_config(ARCH).param_count() == 6_050_021_376
    TM.check_supported(get_config(ARCH))
    for mode in ("int8", "int4"):
        TM.check_supported(get_config(ARCH), ParallelConfig(weight_quant=mode))


def test_param_tree_and_bridge_follow_jax(engines):
    """No norm2 in a parallel-residual layer: the port's defs, init_params
    and the bridged tree carry the JAX sub-layer's leaves with its shapes,
    bit for bit across the bridge."""
    _, tree, teng = engines
    cfg = teng.cfg
    sub = tree["groups"][0]["sub0"]
    jleaves = {"norm1": sub["norm1"], **sub["mixer"], **sub["ffn"]}
    assert "norm2" not in sub and set(TM.layer_param_defs(cfg)) == set(jleaves)
    bits = lambda t: t.view(torch.int16).numpy()
    for i, layer in enumerate(teng.params["layers"]):
        assert set(layer) == set(jleaves)
        for name, leaf in jleaves.items():
            np.testing.assert_array_equal(bits(layer[name]), leaf[i].view(np.int16), err_msg=name)
    fresh = TM.init_params(cfg, seed=3, device="cpu")
    for layer in fresh["layers"]:
        assert {k: tuple(v.shape) for k, v in layer.items()} == \
            {k: tuple(v.shape[1:]) for k, v in jleaves.items()}
    wb = TM.decode_weight_bytes(cfg)["swept"]
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    assert wb == 2 * (L * (d + 4 * d * d + 2 * d * f) + d + d * cfg.vocab_size)


# ---------------------------------------------------------------------------
# Logits
# ---------------------------------------------------------------------------


@pytest.fixture
def fused_calls(monkeypatch):
    """Calls of the fused_dual_matmul wrapper, counted on the CPU too."""
    calls = []
    real = ops.fused_dual_matmul

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(ops, "fused_dual_matmul", spy)
    return calls


def test_prefill_and_decode_logits_match_jax(engines, fused_calls):
    """Prefill and 8 teacher-forced decode steps within 5e-2; every layer of
    every forward goes through one fused_dual_matmul."""
    jeng, _, teng = engines
    assert_logits_match(jeng, teng.cfg, teng.params)
    assert len(fused_calls) == teng.cfg.n_layers * 9
    assert fused_calls[0] == (2, teng.cfg.n_heads, 12, 64)       # the prefill's heads, in place


def _sequential_sublayer(p, x, cfg, kind="attn", index=0, *, rope, step, length_mask=None,
                         policy=None):
    """The planted fault: a sequential residual, the FFN reading the norm of
    x + attn (with norm1's gamma: the layer has no norm2)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.mlp import mlp_forward

    xa = rms_norm(x, p["norm1"], cfg.rms_eps)
    x = x + attn.gqa_forward(p, xa, cfg, rope=rope, step=step, layer=index)
    return x + mlp_forward(p, rms_norm(x, p["norm1"], cfg.rms_eps), cfg)


def test_planted_sequential_residual_fails_the_tolerance(engines, monkeypatch):
    jeng, _, teng = engines
    monkeypatch.setattr(transformer, "sublayer_forward", _sequential_sublayer)
    with pytest.raises(AssertionError):
        assert_logits_match(jeng, teng.cfg, teng.params)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_logits_match_jax(mode, fused_calls):
    """Both partials kept apart, as the JAX path computes them: w_o
    dequantized at its einsum, w_down through dequant_matmul; the fused
    kernel does not run."""
    jcfg, tcfg = configs()
    jeng, tree = jax_engine(jcfg, max_len=32, use_pallas=True, weight_quant=mode)
    params = bridge.params_from_jax(tree, tcfg, device="cpu")
    assert isinstance(params["layers"][0]["w_down"], QuantWeight)
    assert isinstance(params["layers"][0]["w_o"], QuantWeight)
    assert_logits_match(jeng, tcfg, params)
    assert fused_calls == []


# ---------------------------------------------------------------------------
# Schedulers
# ---------------------------------------------------------------------------


def _requests(vocab, n=5, seed=0):
    """Prompts of 5..20 tokens, some a repeated phrase (n-gram drafts find
    continuations), budgets 4..12, an arrival every 2 decode steps."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        p = (np.tile(rng.integers(0, vocab, 4), 4) if i % 2 else
             rng.integers(0, vocab, int(rng.integers(5, 21))))
        reqs.append((p.astype(np.int32), int(rng.integers(4, 13)), None, 2 * i))
    return reqs


def test_wave_tokens_match_jax(engines):
    """Waves of two right-padded prompts.  A stream that parts at step t > 0
    is certified along the padded prompt, which its decode steps attend."""
    jeng, _, teng = engines
    reqs = [(p, m, None, 0) for p, m, *_ in _requests(teng.cfg.vocab_size, seed=1)]
    port, ref_ = serve(WaveScheduler(teng, 2), reqs), serve(JWaveScheduler(jeng, batch_size=2), reqs)
    assert sorted(port) == sorted(ref_) == list(range(len(reqs)))
    flips = 0
    for rid, (p, m, *_) in enumerate(reqs):
        a, b = port[rid].output, ref_[rid].output
        assert len(a) == m and ((a >= 0) & (a < teng.cfg.vocab_size)).all()
        if np.array_equal(a, b):
            continue
        t = int(np.argmax(a != b))
        plen = max(len(q) for q, *_ in reqs[rid - rid % 2: rid - rid % 2 + 2])
        prompt = np.pad(p, (0, plen - len(p))) if t else p
        gap = top2_gap(teng, prompt, b[:t])
        assert gap < TIE_GAP, f"request {rid} parts at step {t} with top-2 gap {gap}"
        flips += 1
    assert flips <= 2          # rare ties (top-2 gaps of 8e-6 and 1.2e-3 here), not drift


def _slot_sched(kind, eng, jax_side, **kw):
    if kind == "paged":
        cls = JPagedScheduler if jax_side else PagedContinuousScheduler
        return cls(eng, n_slots=3, block_steps=4, block_size=8, **kw)
    cls = JContinuousScheduler if jax_side else ContinuousScheduler
    return cls(eng, n_slots=3, block_steps=4, **kw)


@pytest.mark.parametrize("kind,chunk,spec_k", [("dense", 0, 0), ("dense", 8, 0),
                                               ("paged", 0, 0), ("dense", 8, K),
                                               ("paged", 8, K)])
def test_slot_tokens_match_jax(engines, kind, chunk, spec_k):
    """Continuous batching over the dense slot cache, whole-prompt and in
    chunks of 8; over the paged pool behind a shared 16-token system
    prompt (prefix reuse); and spec decode with K n-gram drafts.  Paged
    streams may follow the JAX dense scheduler's where the reference's two
    backends part (tests/test_torch_paged.py); the spec reference may part
    at another near-tie by slot, so its streams are certified, not
    counted."""
    jeng, _, teng = engines
    vocab = teng.cfg.vocab_size
    reqs = shared_prompt_requests(vocab, n=5, seed=8) if kind == "paged" else _requests(vocab)
    kw = dict(prefill_chunk=chunk, spec_k=spec_k)
    tsched = _slot_sched(kind, teng, False, **kw)
    ref_, port = serve(_slot_sched(kind, jeng, True, **kw), reqs), serve(tsched, reqs)
    other = None
    if kind == "paged":
        other = serve(_slot_sched("dense", jeng, True, **kw), reqs)
        tsched.alloc.audit()
        assert tsched.stats["prefill_tokens_saved"] > 0
    assert_streams_match(teng, reqs, port, ref_, max_flips=len(reqs) - 2 if spec_k else 1,
                         ref_other=other)
    if chunk:
        assert tsched.stats["chunked_admissions"] > 0 and tsched.stats["mixed_decode_steps"] > 0
    if spec_k:
        assert tsched.stats["spec_steps"] > 0
