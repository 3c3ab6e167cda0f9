"""Serving mamba2-1.3b, internvl2-26b and musicgen-medium at tp=2: the port's
schedulers on two gloo ranks on the CPU (tests/torch_tp_ranks.py, one spawn
for every run) against the JAX package's tp=1 schedulers on the same
bridged weights.

Runs (reduced configs, the workloads of their tp=1 test files):

* mamba2-1.3b (16 SSD heads, 8 a rank; the tied head over the
  vocab-sharded table; its SSD scalars drawn nonzero): waves of 2, the
  continuous scheduler and the paged pool (which reserves no block), whole
  prompts into 3 slots (tests/test_torch_ssm.py);
* internvl2-26b (an 8-position prefix of zero features before every
  prompt): waves of 3, and the continuous scheduler (whole prompts behind
  the prefix, arrivals every 2 decode steps, an EOS id on every third
  request) over the bf16 and the int8 KV cache; and int4 weights in waves;
* musicgen-medium ((n, 4) frames, EOS on codebook 0): waves of 3 and the
  continuous scheduler (tests/test_torch_multimodal_serve.py);
* the serve CLI at ``--tp 2`` for each arch.

Per request the greedy tokens (every codebook of a frame) equal the JAX
stream's, or part first where every differing codebook is certified: a
top-2 gap below 1e-2 in the port's tp=1 logits or the reference's own,
teacher-forced along the reference's stream behind the prefix, or the tp=2
token within 5e-2, the tp logits' tolerance (tests/test_torch_tp_ssd_modal.py),
of the top of the reference's logits there.  A rank sums its partials in
another order than tp=1, one bf16 rounding apart, which flips such
near-ties; a wrong shard moves logits by O(1).  Every rank serves the same
streams (``Engine.check_replicated`` ends every run, and the ranks' streams
are compared here).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.launch import mesh
from repro_torch.runtime.engine import Engine
from test_torch_continuous import assert_streams_match
from test_torch_model import jax_engine
from test_torch_multimodal_serve import (_JAX_FORWARD, SLOT_LENS, WAVE_LENS, jax_gaps,
                                         port_gaps, prompts_for)
from test_torch_ssm import engines as ssm_engines
from test_torch_ssm import requests as ssm_requests
from test_torch_tp import _torch_tree
from test_torch_tp_families_serve import _near_top
from test_torch_tp_serve import _jax_serve, _requests
import torch_tp_ranks

TP, TOL, TIE_GAP, MM_MAX_LEN = 2, 5e-2, 1e-2, 48
SSM, VLM, AUD = "mamba2-1.3b", "internvl2-26b", "musicgen-medium"


def _mm_work(teng, wave: bool):
    """The multimodal workloads (tests/test_torch_multimodal_serve.py):
    six prompts (frames) in waves of 3, budgets 3..8; or six into 3 slots,
    arrivals every 2 steps, an EOS id on codebook 0 (a token the port's
    first stream reaches) on every third."""
    cfg = teng.cfg
    if wave:
        budgets = [8, 5, 8, 3, 6, 8]
        return [(p, m, None, 0) for p, m in zip(prompts_for(cfg, WAVE_LENS, 12), budgets)]
    work = prompts_for(cfg, SLOT_LENS, 15)
    rng = np.random.default_rng(16)
    budgets = [int(rng.integers(3, 9)) for _ in work]
    eos = int(np.asarray(teng.generate(work[0][None], 8)[0][1]).reshape(-1)[0])
    return [(p, m, eos if i % 3 == 0 else None, 2 * i)
            for i, (p, m) in enumerate(zip(work, budgets))]


def _sides():
    """arch key -> {jeng: {kv_quant: JAX engine}, teng (the port's tp=1
    engine on the bridged weights), tree, max_len, runs: name ->
    (scheduler, its kw, engine ParallelConfig kw, requests)}."""
    sides = {}
    jeng, tree, teng = ssm_engines()
    vocab = teng.cfg.vocab_size
    slot = dict(n_slots=3, block_steps=4)
    sides[SSM] = dict(jeng={False: jeng}, teng=teng, tree=tree, max_len=jeng.max_len, runs={
        "wave": ("wave", {"batch_size": 2}, {},
                 [(p, m, None, 0) for p, m, *_ in ssm_requests(vocab, seed=1)]),
        "continuous": ("continuous", slot, {}, ssm_requests(vocab, n=5, seed=4, lens=(10, 61))),
        "paged": ("paged", dict(slot, block_size=8), {},
                  ssm_requests(vocab, n=5, seed=4, lens=(10, 61))),
    })
    for key, arch, mode in ((VLM, VLM, "none"), (f"{VLM} int4", VLM, "int4"), (AUD, AUD, "none")):
        jeng, tree = jax_engine(jget_config(arch).reduced(), MM_MAX_LEN, weight_quant=mode)
        cfg = get_config(arch).reduced()
        teng = Engine(cfg, parallel=ParallelConfig(weight_quant=mode),
                      sampling=SamplingConfig(top_k=1), max_len=MM_MAX_LEN,
                      params=bridge.params_from_jax(tree, cfg, device="cpu"), device="cpu")
        par = {"weight_quant": mode} if mode != "none" else {}
        slots = dict(n_slots=3, block_steps=2)
        runs = {"wave": ("wave", {"batch_size": 3}, par, _mm_work(teng, True))}
        jengs = {False: jeng}
        if mode == "none":
            runs["continuous"] = ("continuous", slots, {}, _mm_work(teng, False))
        if key == VLM:
            runs["int8-kv"] = ("continuous", slots, {"kv_quant": True}, _mm_work(teng, False))
            jengs[True], _ = jax_engine(jget_config(arch).reduced(), MM_MAX_LEN, kv_quant=True)
            jengs[True].params = jeng.params             # the same weights, an int8 cache
        sides[key] = dict(jeng=jengs, teng=teng, tree=tree, max_len=MM_MAX_LEN, runs=runs)
    return sides


@pytest.fixture(scope="module")
def served():
    """Each arch's JAX side with the reference's streams per run, and the
    tp=2 ranks' streams (the spawn runs while the references serve)."""
    sides = _sides()
    arg = {key: (side["teng"].cfg, _torch_tree(side["tree"]), side["max_len"],
                 {name: (*run, 1) for name, run in side["runs"].items()})
           for key, side in sides.items()}

    def reference(side):
        return {name: _jax_serve(side["jeng"][bool(par.get("kv_quant"))], kind, kw, reqs)
                for name, (kind, kw, par, reqs) in side["runs"].items()}

    # the references in threads of their own (XLA compiles outside the GIL)
    with ThreadPoolExecutor(1 + len(sides)) as pool:
        ranks = pool.submit(mesh.spawn, torch_tp_ranks.run_family_serve_cases, TP, arg,
                            device="cpu")
        refs = {key: pool.submit(reference, side) for key, side in sides.items()}
        for key, ref in refs.items():
            sides[key]["ref"] = ref.result()
        got = ranks.result()
    return sides, got


def _padded(reqs, rid, kind, batch):
    """The prompt as the scheduler ran it: a wave's right-padded (pad id 0)
    to its longest."""
    prompt = reqs[rid][0]
    if kind != "wave":
        return prompt
    w0 = rid - rid % batch
    plen = max(len(p) for p, *_ in reqs[w0:w0 + batch])
    out = np.zeros((plen, *prompt.shape[1:]), np.int32)
    out[:len(prompt)] = prompt
    return out


def _certify(side, jeng, prompt, a, b, features):
    """Port stream ``a`` (tp=2) equals reference stream ``b``, or parts
    first where every differing codebook is certified (module docstring)
    -> whether it parted."""
    teng = side["teng"]
    assert ((a >= 0) & (a < teng.cfg.vocab_size)).all()
    if a.shape == b.shape and np.array_equal(a, b):
        return False
    n = min(len(a), len(b))
    diff = (a[:n] != b[:n]).reshape(n, -1)
    assert diff.any(), "streams of different lengths with no differing step"
    t = int(np.argmax(diff.any(axis=1)))
    seq = np.concatenate([prompt, b[:t]]).astype(np.int32)
    cbs = np.flatnonzero(diff[t])
    gap = np.minimum(port_gaps(teng, seq, features)[cbs], jax_gaps(jeng, seq, features)[cbs])
    if (gap < TIE_GAP).all():
        return True
    # the reference's logits there (its forward compiled by jax_gaps)
    lg = np.asarray(_JAX_FORWARD[id(jeng)](jeng.params, seq[None], features[None]))[0, -1]
    lg = lg.reshape(-1, lg.shape[-1])[cbs]
    tok = np.asarray(a[t]).reshape(-1)[cbs]
    slack = lg.max(axis=-1) - lg[np.arange(len(cbs)), tok]
    assert (slack < TOL).all(), (f"parts at step {t}, codebooks {cbs}: top-2 gaps {gap}, "
                                 f"the tp token {slack} below the reference's top")
    return True


STREAM_RUNS = [(SSM, "wave"), (SSM, "continuous"), (SSM, "paged"), (VLM, "wave"),
               (VLM, "continuous"), (VLM, "int8-kv"), (f"{VLM} int4", "wave"), (AUD, "wave"),
               (AUD, "continuous")]


@pytest.mark.parametrize("key,name", STREAM_RUNS)
def test_tp2_streams_match_jax_tp1(served, key, name):
    """Each rank's streams against the reference's at tp=1, a parting
    certified (module docstring), at most half of a run's parted; both
    ranks the same streams; the paged pool reserves no block for mamba2."""
    sides, got = served
    side = sides[key]
    kind, kw, par, reqs = side["runs"][name]
    jeng = side["jeng"][bool(par.get("kv_quant"))]
    ref = side["ref"][name]
    f = side["teng"].cfg.frontend
    zeros = np.zeros((f.prefix_len, f.feature_dim), np.float32) if f else None
    streams = [got[rank][f"{key} {name}"][0] for rank in range(TP)]
    assert sorted(streams[0]) == sorted(ref) == list(range(len(reqs)))
    for rid, (a, _) in streams[0].items():
        np.testing.assert_array_equal(streams[1][rid][0], a)
    prompts = [_padded(reqs, rid, kind, kw.get("batch_size", 1)) for rid in range(len(reqs))]
    if f is None:            # mamba2: no prefix, single tokens
        assert_streams_match(side["teng"], [(p,) for p in prompts], _requests(streams[0]), ref,
                             max_flips=len(reqs) // 2, jeng=jeng, certify=_near_top(jeng))
    else:
        parted = 0
        for rid, (a, why) in streams[0].items():
            if _certify(side, jeng, prompts[rid], a, ref[rid].output, zeros):
                parted += 1
            else:
                assert why == ref[rid].finish_reason, rid
        assert parted <= len(reqs) // 2
    stats = got[0][f"{key} {name}"][1]
    if kind == "paged":
        assert stats["blocks_hwm"] == 0
    if kind == "continuous":
        assert stats["in_flight_admissions"] > 0


@pytest.mark.parametrize("arch", [SSM, VLM, AUD])
def test_serve_cli_at_tp2(arch, capfd):
    """``serve --arch ARCH --tp 2``: two ranks draw their shards (the SSD
    heads, the prefix's projector replicated, the codebook head split on
    V), and rank 0 prints the serve line; mamba2 through the paged pool,
    the others through the continuous scheduler."""
    from repro_torch.launch import serve as serve_cli
    sched = "paged" if arch == SSM else "continuous"
    done = serve_cli.main(["--arch", arch, "--device", "cpu", "--tp", "2", "--dist-backend",
                           "gloo", "--top-k", "1", "--scheduler", sched, "--requests", "3",
                           "--max-new", "5", "--max-len", "64"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.output) == 5 for r in done)
    frame = (get_config(arch).n_codebooks,) if arch == AUD else ()
    assert all(np.asarray(r.output).shape == (5, *frame) for r in done)
    assert f"({sched}; arch={arch}-smoke, tp=2, device=cpu, gloo)" in capfd.readouterr().out
