"""Serving at tp=2: the port's schedulers on two gloo ranks on the CPU
(tests/torch_tp_ranks.py, one spawn for every run) against the JAX
package's tp=1 schedulers on the same bridged weights.

Reduced yi-9b with 8 q heads over 2 KV heads of head_dim 128, so each rank
holds one KV head and four q heads.  Runs: waves of odd prompt lengths,
continuous batching over the dense slot cache, the paged pool behind a
shared system prompt, chunked admission with spec decode at spec_k 3
(dense) and 4 (paged, verify width 5, which the JAX package cannot run at
tp=2: its ``shard_residual`` drops rows where tp does not divide the
sequence), and the int8 KV cache.  Per request the greedy tokens equal the
JAX stream's, or part first at a near-tie certified as
tests/test_torch_continuous.py certifies one (the port's tp=1 logits,
teacher-forced along the JAX stream, with a top-2 gap below 1e-2; a wave
request along its right-padded prompt).  The certificate is the guard, as
in tests/test_torch_rglru.py: a tp=2 rank sums its partials in another
order than tp=1, one bf16 rounding apart, which flips such near-ties (spec
decode on random weights meets several), while a wrong shard moves logits
by O(1); at least one stream of each run must equal the JAX one.  A top_k
40 run shows the ranks draw the same tokens, and every run ends in
``Engine.check_replicated``.  The features left for later raise by name.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.launch import mesh
from repro_torch.models import model as TM
from repro_torch.models.common import ShardPlan
from repro_torch.runtime.engine import Engine
from test_paged import straggler_requests
from test_torch_continuous import assert_streams_match, shared_prompt_requests
from test_torch_model import GQA, jax_engine
from test_torch_spec import spec_requests
from test_torch_tp import _torch_tree
import torch_tp_ranks

MAX_LEN, TP = 64, 2
SLOT = dict(n_slots=3, block_steps=4)


def wave_requests(vocab):
    """Seven prompts of 3..11 tokens (odd lengths split unevenly over the
    ranks), budgets 3..8, in waves of 3."""
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(3, 9)), None, 0) for _ in range(7)]


def _runs(cfg):
    """name -> (scheduler, its kw, engine ParallelConfig kw, requests,
    top_k); the JAX side runs the same (its kv_quant on its own engine)."""
    straggle = straggler_requests(cfg)
    return {
        "wave": ("wave", {"batch_size": 3}, {}, wave_requests(cfg.vocab_size), 1),
        "continuous": ("continuous", dict(SLOT, prefill_chunk=0), {}, straggle, 1),
        "paged-shared-prefix": ("paged", dict(SLOT, prefill_chunk=0, block_size=8), {},
                                shared_prompt_requests(cfg.vocab_size), 1),
        "chunked-spec3": ("continuous", dict(SLOT, prefill_chunk=8, spec_k=3), {},
                          spec_requests(cfg.vocab_size), 1),
        "paged-chunked-spec4": ("paged", dict(SLOT, prefill_chunk=8, spec_k=4, block_size=8),
                                {}, spec_requests(cfg.vocab_size, seed=1), 1),
        "int8-kv": ("continuous", dict(SLOT, prefill_chunk=0), {"kv_quant": True}, straggle, 1),
        "top_k40": ("wave", {"batch_size": 3}, {}, wave_requests(cfg.vocab_size), 40),
    }


def _jax_serve(jeng, kind, kw, reqs):
    if kind == "wave":
        sched = JWaveScheduler(jeng, **kw)
    elif kind == "paged":
        sched = JPagedScheduler(jeng, **kw)
    else:
        sched = JContinuousScheduler(jeng, **kw)
    for prompt, max_new, eos, arrival in reqs:
        sched.submit(prompt, max_new, eos_id=eos, arrival_step=arrival)
    return {r.rid: r for r in sched.run()}


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **GQA)
    tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **GQA)
    jeng, tree = jax_engine(jcfg, MAX_LEN)
    jeng_q, _ = jax_engine(jcfg, MAX_LEN, kv_quant=True)
    jeng_q.params = jeng.params                  # the same weights, an int8 cache
    runs = _runs(tcfg)
    got = mesh.spawn(torch_tp_ranks.run_serve_cases, TP, tcfg, _torch_tree(tree), runs,
                     device="cpu")
    ref = {name: _jax_serve(jeng_q if par.get("kv_quant") else jeng, kind, kw, reqs)
           for name, (kind, kw, par, reqs, top_k) in runs.items() if top_k == 1}
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    jengs = {name: jeng_q if par.get("kv_quant") else jeng
             for name, (_, _, par, *_) in runs.items()}
    return runs, got, ref, teng, jengs


def _requests(streams):
    return {rid: SimpleNamespace(output=out, finish_reason=why)
            for rid, (out, why) in streams.items()}


def _as_run(reqs, kind, kw):
    """The prompts as the scheduler ran them: a wave's right-padded to its
    longest (pad id 0), which the certificate's teacher-forced forward
    must see."""
    if kind != "wave":
        return reqs
    n, out = kw["batch_size"], []
    for i, (prompt, *rest) in enumerate(reqs):
        plen = max(len(p) for p, *_ in reqs[i - i % n:i - i % n + n])
        out.append((np.concatenate([prompt, np.zeros(plen - len(prompt), prompt.dtype)]), *rest))
    return out


@pytest.mark.parametrize("name", ["wave", "continuous", "paged-shared-prefix", "chunked-spec3",
                                  "paged-chunked-spec4", "int8-kv"])
def test_tp2_streams_match_jax_tp1(served, name):
    """Each rank's streams against the reference's at tp=1, a parting
    certified by either side's teacher-forced top-2 gap."""
    runs, got, ref, teng, jengs = served
    kind, kw, _, reqs = runs[name][:4]
    for rank in range(TP):
        streams, stats = got[rank][name]
        assert_streams_match(teng, _as_run(reqs, kind, kw), _requests(streams), ref[name],
                             max_flips=len(reqs) - 1, jeng=jengs[name])
    stats = got[0][name][1]
    if kw.get("spec_k"):
        assert stats["spec_steps"] > 0 and stats["prefill_chunks"] > 0
    if kind == "paged" and name == "paged-shared-prefix":
        assert stats["shared_block_hits"] > 0


def test_top_k40_streams_are_the_same_on_every_rank(served):
    """Stochastic sampling: every rank seeds its generator alike and draws
    the same tokens (each run also checks it itself)."""
    _, got, _, _, _ = served
    a, b = (got[r]["top_k40"][0] for r in range(TP))
    assert sorted(a) == sorted(b) and len(a) == 7
    for rid in a:
        np.testing.assert_array_equal(a[rid][0], b[rid][0])
    assert len({tuple(a[rid][0]) for rid in a}) > 1


def test_tp_refusals_name_what_is_left_for_later():
    yi, ssd = get_config("yi-9b"), get_config("mamba2-1.3b")
    # the control plane serves at tp>1 and dp>1 (world rank 0's round records)
    for cfg, par in ((ssd, ParallelConfig(tp=2, fault_plan="step:at=1")),
                     (ssd, ParallelConfig(tp=2, overload_degrade=True)),
                     (ssd, ParallelConfig(tp=2, overlap_decode=True)),
                     (yi, ParallelConfig(tp=2, dp=2, fault_plan="delay:at=1,s=0.1"))):
        TM.check_supported(cfg, par)
    for cfg, par, kw, name in (
            (ssd, ParallelConfig(tp=2, dp=2, kv_seq_shard=True), {}, r"kv_seq_shard with mla"),
            (yi, ParallelConfig(tp=2, weight_quant="int4"), {"wq_cache": "x.npz"},
             r"wq_cache at tp>1"),
            (yi, ParallelConfig(tp=3), {}, r"tp=3")):
        with pytest.raises(NotImplementedError, match=name):
            TM.check_supported(cfg, par, **kw)
    for arch in ("yi-9b", "qwen-72b", "gptj-parallel", "qwen2.5-14b", "qwen2.5-32b",
                 "recurrentgemma-9b", "deepseek-moe-16b", "mixtral-8x7b", "minicpm3-4b",
                 "mamba2-1.3b", "internvl2-26b", "musicgen-medium"):
        for tp in (2, 4, 8):
            TM.check_supported(get_config(arch), ParallelConfig(tp=tp, weight_quant="int4",
                                                                kv_quant=True))
    with pytest.raises(ValueError, match="not a multiple of n_kv"):
        TM.check_supported(dataclasses.replace(yi.reduced(), n_heads=6, n_kv_heads=3),
                           ParallelConfig(tp=4))
    with pytest.raises(ValueError, match="d_ff"):
        TM.check_supported(dataclasses.replace(yi.reduced(), d_ff=510), ParallelConfig(tp=4))
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.check_backend(2, "nccl", "cpu")
    with pytest.raises(ValueError, match="tp 2"):
        Engine(yi.reduced(), parallel=ParallelConfig(tp=2), device="cpu")
    assert ShardPlan.make(yi, 8).kv_rep == 2


def test_serve_cli_at_tp2(capfd):
    """``serve --device cpu --tp 2 --dist-backend gloo``: two ranks, rank 0
    prints the serve line; here paged, chunked, spec decode, and the
    baseline that gathers the whole logits row (``--no-topk-sync``)."""
    from repro_torch.launch import serve
    done = serve.main(["--device", "cpu", "--tp", "2", "--dist-backend", "gloo", "--top-k", "1",
                       "--scheduler", "paged", "--prefill-chunk", "16", "--spec-k", "4",
                       "--requests", "3", "--max-new", "6", "--no-topk-sync"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.output) == 6 for r in done)
    assert "(paged; arch=yi-9b-smoke, tp=2, device=cpu, gloo)" in capfd.readouterr().out
