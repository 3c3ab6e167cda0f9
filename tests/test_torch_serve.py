"""Wave serving end to end: per-request greedy tokens of the port's
``WaveScheduler`` against the JAX package's, on the same weights.

The JAX side runs with ``use_pallas=True`` (interpret mode) at head_dim 128
and max_len 128, so its flash-prefill, decode-attention and top-k kernels
all serve the run.  Seven requests of mixed prompt lengths go in waves of
three; short prompts are right-padded, and two requests stop at an EOS that
their stream reaches.  max_new stays at or below 8, which keeps the JAX
engine on its one-step decode program.

Two implementations that round bf16 activations at different places can
flip a greedy choice where the top two logits nearly tie.  A stream that
differs is therefore certified at its first differing step: the port's
logits there (teacher-forced along the JAX stream) must show a top-2 gap
below 1e-2, the same accounting as tests/test_specdecode.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import SamplingConfig, get_config
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import WaveScheduler
from test_torch_model import GQA, jax_engine

MAX_LEN, BATCH, TIE_GAP = 128, 3, 1e-2


def _workload(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(3, 9))) for _ in range(7)]


def _run(sched, work, eos):
    for (prompt, max_new), e in zip(work, eos):
        sched.submit(prompt, max_new=max_new, eos_id=e)
    return {r.rid: r for r in sched.run()}


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **GQA)
    tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **GQA)
    jeng, tree = jax_engine(jcfg, MAX_LEN, use_pallas=True)
    params = bridge.params_from_jax(tree, tcfg, device="cpu")
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=params, device="cpu")
    work = _workload(tcfg.vocab_size)
    # EOS ids that the streams reach: the third token of requests 0 and 4
    free = _run(WaveScheduler(teng, BATCH), work, [None] * 7)
    eos = [int(free[i].output[2]) if i in (0, 4) else None for i in range(7)]
    port = _run(WaveScheduler(teng, BATCH), work, eos)
    ref = _run(JWaveScheduler(jeng, batch_size=BATCH), work, eos)
    return teng, work, eos, port, ref


def _certify_tie(teng, work, rid, ref_tokens, t):
    """Port logits at step t of request rid along the reference stream."""
    wave = work[rid - rid % BATCH: rid - rid % BATCH + BATCH]
    plen = max(len(p) for p, _ in wave)
    seq = np.zeros(plen + t, np.int64)
    seq[:len(work[rid][0])] = work[rid][0]
    seq[plen:] = ref_tokens[:t]
    with torch.inference_mode():
        logits = TM.forward(teng.params, torch.from_numpy(seq)[None], teng.cfg,
                            last_only=True)[0, -1].numpy()
    top2 = np.sort(logits)[-2:]
    return top2[1] - top2[0]


def test_wave_tokens_match_jax(served):
    teng, work, eos, port, ref = served
    assert sorted(port) == sorted(ref) == list(range(7))
    flips = 0
    for rid in range(7):
        a, b = port[rid].output, ref[rid].output
        assert a.dtype == np.int32 and ((a >= 0) & (a < teng.cfg.vocab_size)).all()
        if np.array_equal(a, b):
            assert port[rid].finish_reason == ref[rid].finish_reason
            continue
        t = int(np.argmax(a[:min(len(a), len(b))] != b[:min(len(a), len(b))]))
        gap = _certify_tie(teng, work, rid, b, t)
        assert gap < TIE_GAP, f"request {rid} differs at step {t} with top-2 gap {gap}"
        flips += 1
    assert flips <= 2          # flips are rare ties, not systematic drift


def test_wave_eos_and_budgets(served):
    _, work, eos, port, _ = served
    for rid, r in port.items():
        if eos[rid] is not None:
            assert r.finish_reason == "stop" and r.output[-1] == eos[rid]
            assert len(r.output) <= 3
        else:
            assert r.finish_reason == "length" and len(r.output) == work[rid][1]
        assert r.stats["wave_batch"] == (BATCH if rid < 6 else 1)


def test_serve_main_on_cpu(capsys):
    done = serve.main(["--device", "cpu", "--requests", "5", "--batch", "2",
                       "--prompt-len", "9", "--max-new", "6", "--top-k", "1"])
    assert [len(r.output) for r in sorted(done, key=lambda r: r.rid)] == [6] * 5
    assert "ms/token (wave; arch=yi-9b-smoke, tp=1, device=cpu)" in capsys.readouterr().out
    again = serve.main(["--device", "cpu", "--requests", "5", "--batch", "2",
                        "--prompt-len", "9", "--max-new", "6", "--top-k", "1"])
    for r1, r2 in zip(done, again):
        np.testing.assert_array_equal(r1.output, r2.output)     # greedy repeats


def test_sampling_is_seeded():
    cfg = get_config("yi-9b").reduced()
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6)
    outs = [Engine(cfg, sampling=SamplingConfig(top_k=40), seed=5, device="cpu")
            .generate(prompts, 8) for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
