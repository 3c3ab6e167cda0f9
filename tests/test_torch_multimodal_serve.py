"""Serving internvl2-26b and musicgen-medium (reduced) through the port's
wave and continuous schedulers against the JAX package's, on the same
weights: ``Engine.generate`` with and without seeded stub features, the
``WaveScheduler`` and the ``ContinuousScheduler`` (whole prompts behind the
prefix, staggered arrivals, spread budgets, an EOS id on codebook 0), in
bf16, and internvl2-26b over the int8 KV cache (the same checks in int4
weights run in tests/test_torch_multimodal.py, which builds those
engines); and the serve CLI's workload, the same requests as the JAX CLI
draws.

The reference is built as tests/test_torch_model.py builds it, on its
pure-JAX path, with max_len 48 and max_new <= 8 (its one-step decode
program).  Greedy streams are held to identity; a stream that parts is
certified at its first differing step (a frame parts where any of its
codebooks does), as the parity contract says: every codebook that differs
there must show a top-2 gap below 1e-2 in the port's logits, teacher-forced
along the reference's stream, or in the reference's own forward.
"""
import argparse
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
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import ContinuousScheduler, WaveScheduler
from test_torch_model import jax_engine

MAX_LEN, TIE_GAP, BATCH = 48, 1e-2, 3
# (arch, weight mode, int8 KV cache); the int4 weights' streams are held in
# tests/test_torch_multimodal.py, on that file's engines
CASES = [("internvl2-26b", "none", False), ("internvl2-26b", "none", True),
         ("musicgen-medium", "none", False)]
IDS = ["-".join(str(v) for v in c) for c in CASES]

_ENGINES = {}


def engines(arch, mode, kvq):
    """(JAX engine, port engine) on the same weights; one per case."""
    key = arch, mode, kvq
    if key not in _ENGINES:
        jeng, tree = jax_engine(jget_config(arch).reduced(), MAX_LEN, weight_quant=mode,
                                kv_quant=kvq)
        cfg = get_config(arch).reduced()
        teng = Engine(cfg, parallel=ParallelConfig(weight_quant=mode, kv_quant=kvq),
                      sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                      params=bridge.params_from_jax(tree, cfg, device="cpu"), device="cpu")
        _ENGINES[key] = jeng, teng
    return _ENGINES[key]


def prompts_for(cfg, lens, seed):
    """Prompts (frames) of the given lengths, seeded token ids."""
    rng = np.random.default_rng(seed)
    frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
    return [rng.integers(0, cfg.vocab_size, (n, *frame)).astype(np.int32) for n in lens]


# the wave prompts: two waves of BATCH, each padded to 13 tokens, so that the
# generate test's wave (the first) and the scheduler's share one prefill
# program of the reference; the slot prompts fit one admission bucket of 8
WAVE_LENS, SLOT_LENS = (9, 13, 5, 13, 7, 11), (5, 8, 6, 8, 7, 5)


def port_gaps(teng, seq, features) -> np.ndarray:
    """The port's top-2 gaps (per codebook) after ``seq`` (L[, ncb]) behind
    ``features`` (prefix, feature_dim)."""
    with torch.inference_mode():
        lg = TM.forward(teng.params, torch.from_numpy(seq)[None].long(), teng.cfg,
                        last_only=True, features=torch.from_numpy(features)[None])
    top2 = np.sort(lg[0, -1].numpy().reshape(-1, lg.shape[-1]), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


_JAX_FORWARD = {}


def jax_gaps(jeng, seq, features) -> np.ndarray:
    """The reference's own top-2 gaps (per codebook) after ``seq``."""
    if id(jeng) not in _JAX_FORWARD:
        sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)
        fwd = lambda p, t, f: JM.forward(p, t, jeng.ctx, features=f, seq_sharded=True)[0]
        _JAX_FORWARD[id(jeng)] = jax.jit(
            lambda p, t, f: sm(fwd, in_specs=(JM.param_specs(jeng.ctx),
                                              P("data", *(None,) * (t.ndim - 1)),
                                              P("data", None, None)),
                               out_specs=P("data", *(None,) * t.ndim))(p, t, f))
    lg = np.asarray(_JAX_FORWARD[id(jeng)](jeng.params, jnp.asarray(seq[None]),
                                           jnp.asarray(features[None])))
    top2 = np.sort(lg[0, -1].reshape(-1, lg.shape[-1]), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assert_parity(jeng, teng, a, b, prefix_seq, features):
    """Port stream ``a`` equals reference stream ``b`` (tokens or frames),
    or parts first at a step where every differing codebook is a near-tie
    of either side, teacher-forced after ``prefix_seq`` and b's tokens
    before.  -> whether it parted."""
    assert a.dtype == np.int32 and ((a >= 0) & (a < teng.cfg.vocab_size)).all()
    if a.shape == b.shape and np.array_equal(a, b):
        return False
    n = min(len(a), len(b))
    diff = (a[:n] != b[:n]).reshape(n, -1)
    assert diff.any(), "streams of different lengths with no differing step"
    t = int(np.argmax(diff.any(axis=1)))
    seq = np.concatenate([prefix_seq, b[:t]]).astype(np.int32)
    cbs = np.flatnonzero(diff[t])
    gap = np.minimum(port_gaps(teng, seq, features)[cbs], jax_gaps(jeng, seq, features)[cbs])
    assert (gap < TIE_GAP).all(), f"parts at step {t}, codebooks {cbs}, top-2 gaps {gap}"
    return True


def check_generate(jeng, teng):
    """``Engine.generate`` against the reference's: a wave of 3
    right-padded prompts of 5..13 tokens (frames), 8 new, with zero
    features (none given) and with seeded non-zero ones."""
    cfg = teng.cfg
    work = prompts_for(cfg, WAVE_LENS[:BATCH], 12)
    plen = max(len(p) for p in work)
    prompts = np.zeros((BATCH, plen, *work[0].shape[1:]), np.int32)
    for i, p in enumerate(work):
        prompts[i, :len(p)] = p
    feats = np.random.default_rng(13).standard_normal((BATCH, 8, 64)).astype(np.float32)
    parted = 0
    for f in (None, feats):
        ref = jeng.generate(prompts, 8, f)
        out = teng.generate(prompts, 8, f)
        assert out.shape == ref.shape == (BATCH, 8, *prompts.shape[2:])
        given = np.zeros((BATCH, 8, 64), np.float32) if f is None else f
        parted += sum(assert_parity(jeng, teng, out[i], ref[i], prompts[i], given[i])
                      for i in range(BATCH))
    assert parted <= 2                     # partings are rare ties, not drift


def check_wave_scheduler(jeng, teng):
    """The WaveScheduler against the reference's: six requests in waves of
    3, budgets 3..8, EOS on codebook 0 at a token the first request
    reaches."""
    cfg = teng.cfg
    work = prompts_for(cfg, WAVE_LENS, 12)
    budgets = [8, 5, 8, 3, 6, 8]
    free = WaveScheduler(teng, BATCH)
    for p, m in zip(work, budgets):
        free.submit(p, m)
    eos = int(np.asarray(free.run()[0].output[2]).reshape(-1)[0])
    runs = {}
    for name, sched in (("port", WaveScheduler(teng, BATCH)),
                        ("ref", JWaveScheduler(jeng, batch_size=BATCH))):
        for p, m in zip(work, budgets):
            sched.submit(p, m, eos_id=eos)
        runs[name] = {r.rid: r for r in sched.run()}
    zeros = np.zeros((8, 64), np.float32)
    parted = 0
    for rid, p in enumerate(work):
        a, b = runs["port"][rid].output, runs["ref"][rid].output
        wave = work[rid - rid % BATCH: rid - rid % BATCH + BATCH]
        padded = np.zeros((max(len(q) for q in wave), *p.shape[1:]), np.int32)
        padded[:len(p)] = p
        if assert_parity(jeng, teng, a, b, padded, zeros):
            parted += 1
            continue
        assert runs["port"][rid].finish_reason == runs["ref"][rid].finish_reason
    assert runs["port"][0].finish_reason == "stop" and len(runs["port"][0].output) <= 3
    assert parted <= 2


def check_continuous_scheduler(jeng, teng):
    """The ContinuousScheduler against the reference's: six requests into
    3 slots, whole prompts behind the prefix (the default chunk falls
    back, as in the reference), arrivals every 2 decode steps, budgets
    3..8, an EOS id on codebook 0 for every third request; the schedulers'
    counts agree too."""
    cfg = teng.cfg
    work = prompts_for(cfg, SLOT_LENS, 15)
    rng = np.random.default_rng(16)
    budgets = [int(rng.integers(3, 9)) for _ in work]
    free = teng.generate(work[0][None], 8)[0]
    eos_tok = int(np.asarray(free[1]).reshape(-1)[0])
    eos = [eos_tok if i % 3 == 0 else None for i in range(len(work))]
    runs, stats = {}, {}
    for name, sched in (("port", ContinuousScheduler(teng, n_slots=3, block_steps=2)),
                        ("ref", JContinuousScheduler(jeng, n_slots=3, block_steps=2))):
        assert sched.chunk == 0
        for i, (p, m) in enumerate(zip(work, budgets)):
            sched.submit(p, m, eos_id=eos[i], arrival_step=2 * i)
        runs[name] = {r.rid: r for r in sched.run()}
        stats[name] = sched.stats
    zeros = np.zeros((8, 64), np.float32)
    parted = sum(assert_parity(jeng, teng, runs["port"][rid].output, runs["ref"][rid].output,
                               p, zeros) for rid, p in enumerate(work))
    assert parted <= 2
    assert runs["port"][0].finish_reason == "stop"
    if not parted:
        for key in ("decode_steps", "prefill_calls", "prefill_tokens", "admission_rounds",
                    "in_flight_admissions", "emitted", "active_slot_steps"):
            assert stats["port"][key] == stats["ref"][key], key


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_generate_matches_jax_with_and_without_features(case):
    check_generate(*engines(*case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wave_scheduler_matches_jax(case):
    check_wave_scheduler(*engines(*case))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_continuous_scheduler_matches_jax(case):
    check_continuous_scheduler(*engines(*case))


class Recorder:
    """A scheduler stand-in that keeps what the serve CLI submits."""

    def __init__(self):
        self.reqs = []

    def submit(self, prompt, max_new, arrival_step=0, **kw):
        self.reqs.append((np.asarray(prompt), max_new, arrival_step))


@pytest.mark.parametrize("arch", ["internvl2-26b", "musicgen-medium"])
def test_serve_cli_submits_the_jax_cli_requests(arch):
    """The two CLIs draw the same requests from the same seed: (plen, 4)
    frames for musicgen-medium, which takes no shared system prompt."""
    args = argparse.Namespace(requests=6, shared_prefix=16, prompt_len=24, max_new=12,
                              max_new_spread=4, arrival_every=2, class_mix="")
    port, ref = Recorder(), Recorder()
    serve.submit_workload(port, get_config(arch).reduced(), args)
    jserve.submit_workload(ref, jget_config(arch).reduced(), args)
    assert len(port.reqs) == len(ref.reqs) == 6
    for (a, m, t), (b, n, u) in zip(port.reqs, ref.reqs):
        np.testing.assert_array_equal(a, b)
        assert (m, t) == (n, u)
    ncb = get_config(arch).n_codebooks
    assert all(a.ndim == (1 if ncb == 1 else 2) for a, _, _ in port.reqs)
