"""mamba2-1.3b (the Mamba-2 SSD mixer, tied embeddings) against the JAX
package on the same weights: the config and its capability record; one
SSD layer's forward at s 1, s = chunk and s = 3 chunks from a nonzero
state under a length mask; the bridge bit for bit, the tied head, the
weight bytes; prefill and decode logits; greedy streams of the wave, the
continuous scheduler and the paged pool (which reserves no block for an
attention-free model); and the chunked-admission and spec-decode refusals
and fallbacks, as the reference's registry gives them.

Config: ``mamba2-1.3b.reduced()`` (2 SSD layers, d 256, d_inner 512, 16
SSD heads of 32, state 32, chunk 32, vocab 512), the reference built as
tests/test_torch_model.py builds it, on its pure-JAX path, its norm gammas
and its ``dt_bias``, ``A_log`` and ``D`` drawn nonzero.

Tolerances: one layer's output 2e-2 + 1e-2 relative (values up to ~5, a
bf16 ulp); its fp32 state ``h`` (values up to ~13, fed by the bf16 conv
output, where one rounding apart moves a term by ~4e-3) 1e-2 + 1e-3
relative; its bf16 conv tail one bf16 ulp (the projections' rounding);
logits 5e-2; streams identical except at a near-tie certified by either
side's top-2 gap (< 1e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core.capabilities import ArchCapabilities as JArchCapabilities
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.models.common import Dist as JDist
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.core.capabilities import ArchCapabilities
from repro_torch.core.wquant import QuantWeight
from repro_torch.models import model as TM
from repro_torch.models import ssm
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                           WaveScheduler)
from test_torch_continuous import assert_streams_match, serve
from test_torch_model import assert_logits_match, jax_engine

ARCH, MAX_LEN = "mamba2-1.3b", 96

_ENGINES = {}


def engines(mode="none"):
    """(JAX engine, its numpy tree, port engine) on the same weights, the
    SSD scalars drawn nonzero; built once per module and weight mode."""
    if mode not in _ENGINES:
        jeng, tree = jax_engine(jget_config(ARCH).reduced(), MAX_LEN, weight_quant=mode)
        rng = np.random.default_rng(5)
        for group in tree["groups"]:
            mixer = group["sub0"]["mixer"]
            for name, scale in (("dt_bias", 0.5), ("A_log", 0.5), ("D", 1.0)):
                mixer[name] = (rng.standard_normal(mixer[name].shape) * scale).astype(np.float32)
        jeng.params = jax.tree.map(jnp.asarray, tree)
        cfg = get_config(ARCH).reduced()
        teng = Engine(cfg, parallel=ParallelConfig(weight_quant=mode),
                      sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                      params=bridge.params_from_jax(tree, cfg, device="cpu"), device="cpu")
        _ENGINES[mode] = jeng, tree, teng
    return _ENGINES[mode]


def requests(vocab, n=4, seed=0, lens=(10, 33)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(*lens))).astype(np.int32),
             int(rng.integers(6, 14)), None, 2 * i) for i in range(n)]


# ---------------------------------------------------------------------------
# Config, capabilities, refusals
# ---------------------------------------------------------------------------


def test_config_and_capabilities_equal_jax():
    for reduce in (False, True):
        tcfg, jcfg = get_config(ARCH), jget_config(ARCH)
        if reduce:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        for f in dataclasses.fields(tcfg):
            t, j = getattr(tcfg, f.name), getattr(jcfg, f.name)
            assert (dataclasses.asdict(t) == dataclasses.asdict(j)
                    if dataclasses.is_dataclass(t) else t == j), f.name
        assert tcfg.param_count() == jcfg.param_count()
        caps = ArchCapabilities.from_config(tcfg)
        assert dataclasses.asdict(caps) == dataclasses.asdict(JArchCapabilities.from_config(jcfg))
    assert get_config(ARCH).param_count() == 1_342_390_272
    assert caps.blockers == {"chunked": "recurrent", "spec": "recurrent", "disagg": "recurrent"}


def test_served_at_tp1_chunks_and_spec_refused_or_fall_back():
    """tp=1 in bf16 (and under int8/int4, which quantize no SSD leaf, as in
    the reference), and tp 2/4/8 (head-sharded SSD, the tied head over the
    vocab-sharded table); SSD heads that tp does not divide raise a
    ValueError naming the arch; an explicit chunk or spec_k raises the
    registry's error, the config's default falls back to whole prompts and
    plain decode; a chunk forward refuses the recurrent state."""
    cfg = get_config(ARCH)
    for mode in ("none", "int8", "int4"):
        TM.check_supported(cfg, ParallelConfig(weight_quant=mode))
        for tp in (2, 4, 8):
            TM.check_supported(cfg, ParallelConfig(tp=tp, weight_quant=mode))
    wide = dataclasses.replace(cfg.reduced(), ssm=dataclasses.replace(cfg.ssm, head_dim=128))
    with pytest.raises(ValueError, match=f"{wide.name}: ssd heads 4 not divisible by tp 8"):
        TM.check_supported(wide, ParallelConfig(tp=8))
    _, _, teng = engines()
    with pytest.raises(ValueError, match="does not support chunked prefill"):
        ContinuousScheduler(teng, n_slots=2, prefill_chunk=8)
    with pytest.raises(ValueError, match="does not support speculative decoding"):
        PagedContinuousScheduler(teng, n_slots=2, spec_k=4)
    quiet = Engine(teng.cfg, parallel=ParallelConfig(prefill_chunk=8, spec_k=4),
                   sampling=SamplingConfig(top_k=1), max_len=MAX_LEN, params=teng.params,
                   device="cpu")
    for cls in (ContinuousScheduler, PagedContinuousScheduler):
        sched = cls(quiet, n_slots=2)
        assert sched.chunk == 0 and sched.spec_k == 0 and sched.drafter is None
    with pytest.raises(NotImplementedError, match="carries no recurrent state"):
        quiet.mixed_step(quiet.init_slot_caches(2), np.zeros((2, 8), np.int32), [True, False],
                         [8, 1], [0, 0], [8, 1], np.zeros(2, np.int32), np.zeros(2, np.int32),
                         [True, True], [0, 0], [-1, -1])


# ---------------------------------------------------------------------------
# The SSD layer, the bridge
# ---------------------------------------------------------------------------


def _bf16(a) -> torch.Tensor:
    return bridge.to_torch(np.asarray(jnp.asarray(a, jnp.bfloat16)))


@pytest.mark.parametrize("s", [1, 32, 96], ids=["step", "chunk", "3-chunks"])
def test_ssd_forward_matches_jax(s):
    """One SSD layer of the bridged weights from a nonzero state (h and the
    conv tail), right-padded rows of 3 lengths under a length mask (a
    decode step takes none): output, h and conv tail against the
    reference's ``ssd_forward``."""
    jeng, tree, teng = engines()
    cfg, jcfg = teng.cfg, jeng.cfg
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["groups"][0]["sub0"]["mixer"])
    p = teng.params["layers"][0]["mixer"]
    rng = np.random.default_rng(s)
    b, nh, P, N = 3, 16, 32, 32
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((b, nh, P, N)) * 0.3).astype(np.float32)
    conv0 = rng.standard_normal((b, 3, 512 + 2 * N)).astype(np.float32)
    lens = np.array([s, max(1, s - 5), max(1, s // 2)])
    lm = (np.arange(s)[None, :] < lens[:, None]) if s > 1 else None
    jstate = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0, jnp.bfloat16)}
    jout, jnew = jax.jit(lambda p, x, st, lm: jssm.ssd_forward(
        p, x, jcfg, JDist(), state=st, length_mask=lm))(
            jp, jnp.asarray(x, jnp.bfloat16), jstate, None if lm is None else jnp.asarray(lm))
    with torch.inference_mode():
        out, new = ssm.ssd_forward(p, _bf16(x), cfg,
                                   state={"h": torch.from_numpy(h0), "conv": _bf16(conv0)},
                                   length_mask=None if lm is None else torch.from_numpy(lm))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), atol=2e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(new["h"].numpy(), np.asarray(jnew["h"]), atol=1e-2, rtol=1e-3)
    np.testing.assert_allclose(new["conv"].float().numpy(), np.asarray(jnew["conv"], np.float32),
                               rtol=2 ** -7)
    if s > cfg.ssm.chunk:
        with pytest.raises(ValueError, match="not divisible by ssd chunk"):
            ssm.ssd_forward(p, _bf16(x[:, :s - 1]), cfg)


def test_bridge_is_bit_exact_with_the_tied_head():
    """The SSD leaves under ``mixer`` (dt_bias, A_log and D fp32), no FFN and
    no norm2, no lm_head leaf: the logits read the embed table, kept as
    one fp32 copy of its transpose; the weight bytes as the reference
    counts them, the table counted as the head's sweep."""
    jeng, tree, teng = engines()
    cfg = teng.cfg
    assert "lm_head" not in tree and "lm_head" not in teng.params
    assert TM.layer_families(cfg) == {"ssd": [0, 1]}
    layer = teng.params["layers"][1]
    assert set(layer) == {"norm1", "mixer"}
    jmix = tree["groups"][0]["sub0"]["mixer"]
    for name, a in jmix.items():
        mine = layer["mixer"][name]
        if a.dtype == np.float32:
            assert mine.dtype == torch.float32
            np.testing.assert_array_equal(mine.numpy(), a[1], err_msg=name)
        else:
            np.testing.assert_array_equal(mine.view(torch.int16).numpy(), a[1].view(np.int16),
                                          err_msg=name)
    table = teng.params["embed"]["table"]
    assert teng.head_f32.shape == (cfg.d_model, cfg.vocab_size)
    assert torch.equal(teng.head_f32, table[0].float().t())
    for mode in ("none", "int8"):
        want = JM.decode_weight_bytes(engines(mode)[0].ctx)
        assert TM.decode_weight_bytes(cfg, ParallelConfig(weight_quant=mode)) == want
    fresh = TM.init_params(cfg, seed=2, device="cpu")
    assert "lm_head" not in fresh and fresh["layers"][0]["mixer"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_logits_match_jax(mode):
    """A 64-token prompt (two SSD chunks) and 8 decode steps, in bf16 and
    under int8 weights, which quantize no leaf of this model (in the
    reference neither)."""
    jeng, _, teng = engines(mode)
    assert not any(isinstance(t, QuantWeight) for t in teng.params["layers"][0]["mixer"].values())
    assert_logits_match(jeng, teng.cfg, teng.params, plen=64, max_len=MAX_LEN)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def test_wave_tokens_match_jax():
    """Waves of 2, each right-padded to its longest prompt (<= one chunk),
    the pad steps kept out of the state by the length mask."""
    jeng, _, teng = engines()
    reqs = [(p, m, None, 0) for p, m, *_ in requests(teng.cfg.vocab_size, seed=1)]
    assert_streams_match(teng, reqs, serve(WaveScheduler(teng, 2), reqs),
                         serve(JWaveScheduler(jeng, batch_size=2), reqs), jeng=jeng)


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_slot_tokens_match_jax(kind):
    """Whole-prompt admission in pow-2 buckets (prompts of 10..60 tokens:
    buckets of 16, 32 and 64, two SSD chunks) into 3 slots, each slot's
    state reset at admission and carried through decode; the paged pool
    reserves no block (``blocks_hwm`` 0), as the reference's."""
    jeng, _, teng = engines()
    reqs = requests(teng.cfg.vocab_size, n=5, seed=4, lens=(10, 61))
    kw = dict(n_slots=3, block_steps=4)
    if kind == "paged":
        tsched, jsched = (PagedContinuousScheduler(teng, block_size=8, **kw),
                          JPagedScheduler(jeng, block_size=8, **kw))
    else:
        tsched, jsched = ContinuousScheduler(teng, **kw), JContinuousScheduler(jeng, **kw)
    port, ref_ = serve(tsched, reqs), serve(jsched, reqs)
    assert_streams_match(teng, reqs, port, ref_, jeng=jeng)
    assert tsched.stats["in_flight_admissions"] > 0
    if kind == "paged":
        assert tsched.stats["blocks_hwm"] == jsched.stats["blocks_hwm"] == 0
        tsched.alloc.audit()
