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

import torch_threads  # noqa: F401
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


def test_serve_main_paged_on_cpu(capsys):
    done = serve.main(["--device", "cpu", "--scheduler", "paged", "--shared-prefix", "16",
                        "--top-k", "1", "--requests", "6", "--arrival-every", "2",
                        "--max-new-spread", "4", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "ms/token (paged; arch=yi-9b-smoke" in out and "reused" in out
    assert len(done) == 6 and all(len(r.output) > 0 for r in done)
    dense = serve.main(["--device", "cpu", "--scheduler", "continuous", "--shared-prefix", "16",
                         "--top-k", "1", "--requests", "6", "--arrival-every", "2",
                         "--max-new-spread", "4", "--max-len", "64"])
    by_rid = {r.rid: r.output for r in dense}
    for r in done:       # random weights: greedy streams of both backends agree
        np.testing.assert_array_equal(r.output, by_rid[r.rid])


def test_chunk_and_spec_flags_fall_back_like_the_jax_cli():
    """``--prefill-chunk 64 --spec-k 4`` on reduced recurrentgemma-9b, whose
    recurrent state blocks chunks and spec decode: both CLIs' argument paths
    (``repro.launch.serve`` and the port's) carry the values on
    ParallelConfig, serve, fall back to whole-prompt admission and plain
    decode, and give the same greedy streams on the same weights (near-ties
    certified as tests/test_torch_rglru.py does).  Asking the scheduler
    itself for a chunk still raises, as the JAX scheduler does."""
    import jax

    from repro.launch import serve as jserve
    from repro_torch.runtime.scheduler import ContinuousScheduler
    from test_torch_rglru import _certify

    argv = ["--arch", "recurrentgemma-9b", "--scheduler", "continuous", "--prefill-chunk", "64",
            "--spec-k", "4", "--top-k", "1", "--requests", "3", "--prompt-len", "12",
            "--max-new", "6", "--arrival-every", "2", "--slots", "2", "--max-len", "64"]
    jargs = jserve.build_parser().parse_args(argv)
    jeng = jserve.build_engine(jargs)
    targs = serve.build_parser().parse_args(argv + ["--device", "cpu"])
    tree = jax.tree.map(np.asarray, jeng.params)
    params = bridge.params_from_jax(tree, get_config("recurrentgemma-9b").reduced(), device="cpu")
    built = serve.build_engine(targs)       # the CLI's engine; its weights are random
    assert (built.parallel.prefill_chunk, built.parallel.spec_k) == (64, 4)
    teng = Engine(built.cfg, parallel=built.parallel, sampling=built.sampling,
                  max_len=built.max_len, params=params, device="cpu")
    jsched, tsched = jserve.make_scheduler(jeng, jargs), serve.make_scheduler(teng, targs)
    assert jsched.chunk == tsched.chunk == 0 and jsched.spec_k == tsched.spec_k == 0
    jserve.submit_workload(jsched, jeng.cfg, jargs)
    serve.submit_workload(tsched, teng.cfg, targs)
    ref = {r.rid: r for r in jsched.run()}
    port = {r.rid: r for r in tsched.run()}
    work = [(ref[rid].prompt, ref[rid].max_new) for rid in sorted(ref)]
    for rid, (prompt, _) in enumerate(work):
        np.testing.assert_array_equal(port[rid].prompt, prompt)     # the same draws
    _certify(jeng, teng, work, port, ref)
    assert tsched.stats["prefill_chunks"] == 0 and "spec_steps" not in tsched.stats
    with pytest.raises(ValueError, match="does not support chunked prefill"):
        ContinuousScheduler(teng, n_slots=2, prefill_chunk=64)
    with pytest.raises(ValueError, match="does not support speculative decoding"):
        ContinuousScheduler(teng, n_slots=2, spec_k=4)


def test_sampling_is_seeded():
    cfg = get_config("yi-9b").reduced()
    prompts = np.arange(12, dtype=np.int32).reshape(2, 6)
    outs = [Engine(cfg, sampling=SamplingConfig(top_k=40), seed=5, device="cpu")
            .generate(prompts, 8) for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])


def _options(parser):
    """Every option string of ``parser`` -> its action."""
    return {o: a for a in parser._actions for o in a.option_strings}


def test_parser_flags_match_the_jax_cli():
    """The port's serve flags are the JAX CLI's, less the set left for later
    (--no-flash-prefill) and plus the port's own --device, --seed and
    --dist-backend; the shared flags keep the JAX defaults and choices
    (the data axis's --dp, --prefill-shards and the disagg scheduler among
    them).  A later change cannot drop a flag unnoticed."""
    from repro.launch import serve as jserve

    jopts, topts = _options(jserve.build_parser()), _options(serve.build_parser())
    later = {"--no-flash-prefill"}
    own = {"--device", "--seed", "--dist-backend"}
    assert set(jopts) - later == set(topts) - own
    assert later.isdisjoint(topts)
    for flag in set(jopts) - later - {"-h", "--help"}:
        j, t = jopts[flag], topts[flag]
        assert j.default == t.default, flag
        if j.choices is not None and flag != "--arch":
            assert list(j.choices) == list(t.choices), flag


def test_class_mix_draws_match_the_jax_cli():
    """``--class-mix`` draws each request's class from a stream of its own:
    the port's workload has the JAX CLI's prompts, budgets and classes."""
    from repro.launch import serve as jserve

    argv = ["--scheduler", "continuous", "--requests", "12", "--max-new-spread", "4",
            "--class-mix", "interactive=0.25,standard=0.5,batch=0.25", "--arrival-every", "2"]
    got = {}
    for name, mod in (("jax", jserve), ("port", serve)):
        args = mod.build_parser().parse_args(argv)

        reqs = got[name] = []

        class Recorder:
            def submit(self, prompt, max_new, arrival_step=0, priority="standard"):
                reqs.append((prompt.tolist(), max_new, arrival_step, priority))

        mod.submit_workload(Recorder(), get_config("yi-9b").reduced(), args)
    assert got["jax"] == got["port"]
    assert {r[3] for r in got["port"]} == {"interactive", "standard", "batch"}
    with pytest.raises(ValueError, match="unknown priority class"):
        serve.parse_class_mix("vip=1")


def test_serve_main_control_plane_flags(capsys, tmp_path):
    """The control-plane flags through the CLI: overlap, a fault plan and the
    class mix on the paged scheduler; the report and --stats-json show the
    quarantine, the retries and the landings."""
    path = tmp_path / "stats.json"
    done = serve.main(["--device", "cpu", "--scheduler", "paged", "--top-k", "1",
                       "--requests", "6", "--arrival-every", "2", "--max-len", "64",
                       "--overlap", "--fault-plan", "step:at=3,times=2;poison:slot=1,at=6",
                       "--retry-backoff-s", "0", "--class-mix", "interactive=1,batch=1",
                       "--responsive-blocks", "--stats-json", str(path)])
    out = capsys.readouterr().out
    assert "1 quarantined" in out and "landings" in out and "class batch" in out
    assert sorted(r.finish_reason for r in done).count("error") == 1
    import json

    stats = json.loads(path.read_text())
    assert stats["stats"]["step_retries"] == 2 and stats["stats"]["landings"] > 0
    assert stats["request_summary"]["overlap"]["enabled"]
