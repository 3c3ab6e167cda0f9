"""Serving the RG-LRU, MoE and MLA families at tp=2: the port's schedulers on
two gloo ranks on the CPU (tests/torch_tp_ranks.py, one spawn for every
run) against the JAX package's tp=1 schedulers on the same bridged
weights.

Runs (reduced configs, as their tp=1 test files serve them):

* deepseek-moe-16b: a wave, continuous batching over the dense slot cache,
  the paged pool behind a shared system prompt, chunks of 16 with spec
  decode of 3 drafts, the int8 KV cache, and a whole-prompt admission into
  4 slots at a 128-token bucket, whose reference forward routes all 512
  tokens: the rows not admitted ride along (``moe.RowLayout``) through the
  same gathers and reductions as the admitted ones, and drop assignments;
* minicpm3-4b: a wave, continuous, paged, and paged in chunks of 16 with
  spec decode of 3;
* mixtral-8x7b: chunks of 16 with spec decode of 4 drafts over its slot
  rings, which wrap while the slots decode and verify;
* recurrentgemma-9b: a wave of prompts longer than its 64-token window and
  continuous batching whose decode wraps the ring;
* the serve CLI at ``--tp 2`` (deepseek-moe-16b, int4 weights).

Per request the greedy tokens equal the JAX stream's, or part first at a
certified near-tie, as each family's tp=1 serving test certifies one: the
port's tp=1 or the reference's teacher-forced top-2 gap below 1e-2 (the
RG-LRU hybrid: below the reference's own spread where that is larger), or
the tp=2 token within 5e-2, the tp logits' tolerance, of the top of the
reference's teacher-forced logits; for an MoE model that witness is taken
with the port at tp=1 routing as the reference routed, within 5e-2 of its
logits along the reference's tokens, or a router near-tie on the way
certifies it (``test_torch_mixtral.router_parting``).  A rank sums its partials in
another order than tp=1, one bf16 rounding apart, which flips such
near-ties and router ties; a wrong shard or a wrong expert moves logits by
O(1).  Every rank serves the same streams (``Engine.check_replicated``
ends every run) and routes the same experts.
"""
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro_torch import bridge
from repro_torch.configs import SamplingConfig, get_config
from repro_torch.launch import mesh
from repro_torch.runtime.engine import Engine
from test_torch_continuous import (_JAX_FORWARD, assert_streams_match, jax_top2_gap,
                                   shared_prompt_requests)
from test_torch_mixtral import requests as ring_requests
from test_torch_mixtral import routed_logits, router_parting
from test_torch_mla import requests
from test_torch_model import jax_engine
from test_torch_rglru import _certify, _past_window, _wave_work, hybrid_engine
from test_torch_tp import _torch_tree
from test_torch_tp_serve import _as_run, _jax_serve, _requests
import torch_tp_ranks

TP = 2
SLOT = dict(n_slots=3, block_steps=4)
TOL = 5e-2


def _past_256(vocab):
    """Three prompts of 70-120 tokens into 4 slots, whole: every admission
    runs the reference's 4 x 128 rows."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, int(rng.integers(70, 120))).astype(np.int32), 6, None, 4 * i)
            for i in range(3)]


def _arch_runs():
    """arch -> (max_len, name -> (scheduler, its kw, engine ParallelConfig
    kw, requests)), each run greedy."""
    ds = get_config("deepseek-moe-16b").reduced().vocab_size
    mc = get_config("minicpm3-4b").reduced().vocab_size
    mx = get_config("mixtral-8x7b").reduced().vocab_size
    rg = get_config("recurrentgemma-9b").reduced().vocab_size
    wave = lambda v: [(p, m, None, 0) for p, m, *_ in requests(v, n=4, seed=1)]
    paged = dict(SLOT, block_size=8, prefill_chunk=0)
    spec = dict(SLOT, prefill_chunk=16, spec_k=3)
    return {
        "deepseek-moe-16b": (160, {
            "wave": ("wave", {"batch_size": 2}, {}, wave(ds)),
            "continuous": ("continuous", dict(SLOT, prefill_chunk=0), {}, requests(ds)),
            "paged": ("paged", paged, {}, shared_prompt_requests(ds, n=4, seed=8)),
            "chunked-spec": ("continuous", spec, {}, requests(ds, seed=2)),
            "int8-kv": ("continuous", dict(SLOT, prefill_chunk=0), {"kv_quant": True},
                        requests(ds, seed=3)),
            "past-256": ("continuous", dict(n_slots=4, block_steps=4, prefill_chunk=0), {},
                         _past_256(ds)),
        }),
        "minicpm3-4b": (64, {
            "wave": ("wave", {"batch_size": 2}, {}, wave(mc)),
            "continuous": ("continuous", dict(SLOT, prefill_chunk=0), {}, requests(mc)),
            "paged": ("paged", paged, {}, shared_prompt_requests(mc, n=4, seed=8)),
            "paged-chunked-spec": ("paged", dict(spec, block_size=8), {}, requests(mc, seed=2)),
        }),
        "mixtral-8x7b": (128, {
            "chunked-spec": ("continuous", dict(n_slots=2, block_steps=2, prefill_chunk=16,
                                                spec_k=4), {},
                             ring_requests(mx, seed=13, budget=(16, 28))),
        }),
        "recurrentgemma-9b": (96, {
            "wave": ("wave", {"batch_size": 2}, {}, _wave_work(rg)),
            "continuous": ("continuous", dict(n_slots=2, block_steps=4), {}, _past_window(rg)),
        }),
    }


def _jax_side(arch, max_len, runs):
    """The reference's engines (bf16 K/V, and int8 K/V on the same weights
    where a run asks for it), its numpy tree and the port's tp=1 engine on
    the bridged weights."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if jcfg.rglru is not None:
        jeng, tree = hybrid_engine(jcfg, max_len)
    else:
        jeng, tree = jax_engine(jcfg, max_len)
    engs = {False: jeng}
    if any(par.get("kv_quant") for _, _, par, _ in runs.values()):
        engs[True], _ = jax_engine(jcfg, max_len, kv_quant=True)
        engs[True].params = jeng.params
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=max_len,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    return {"tcfg": tcfg, "tree": tree, "engs": engs, "teng": teng}


@pytest.fixture(scope="module")
def served():
    """Each arch's JAX side with the reference's streams per run, and the
    tp=2 ranks' streams (the spawn runs while the reference serves)."""
    archs = _arch_runs()
    sides = {arch: _jax_side(arch, max_len, runs) for arch, (max_len, runs) in archs.items()}
    arg = {arch: (sides[arch]["tcfg"], _torch_tree(sides[arch]["tree"]), max_len,
                  {name: (*run, 1) for name, run in runs.items()})
           for arch, (max_len, runs) in archs.items()}

    def reference(arch):
        engs, runs = sides[arch]["engs"], archs[arch][1]
        return {name: _jax_serve(engs[bool(par.get("kv_quant"))], kind, kw, reqs)
                for name, (kind, kw, par, reqs) in runs.items()}

    # the archs' references in threads of their own (XLA compiles outside
    # the GIL), beside the ranks
    with ThreadPoolExecutor(1 + len(archs)) as pool:
        ranks = pool.submit(mesh.spawn, torch_tp_ranks.run_family_serve_cases, TP, arg,
                            device="cpu")
        refs = {arch: pool.submit(reference, arch) for arch in archs}
        for arch, ref in refs.items():
            sides[arch]["ref"] = ref.result()
        got = ranks.result()
    return archs, sides, got


def _moe_certify(side, monkeypatch, ring):
    """router_parting for the MoE archs (chunks of 16 into a slot ring on
    mixtral; the whole-prompt forward alone on deepseek, which has none)."""
    jeng, teng = side["engs"][False], side["teng"]
    if ring:
        return router_parting(jeng, teng, monkeypatch)

    def certify(prompt, tokens, token):
        seq = np.concatenate([prompt, np.asarray(tokens, np.int32)]).astype(np.int32)
        want, got, ties = routed_logits(jeng, teng, seq, (0,), monkeypatch)
        err = np.abs(got[0][-1] - want[-1]).max()
        slack = np.inf if token is None else want[-1].max() - want[-1][token]
        return bool(err <= TOL and (slack < TOL or ties))

    return certify


def _near_top(jeng):
    """``assert_streams_match``'s ``certify`` where no router replays: the
    port's token lies within TOL, the tolerance of the tp logits
    (tests/test_torch_tp_families.py), of the top of the reference's
    logits, teacher-forced along its tokens to the parting."""

    def certify(prompt, tokens, token):
        if token is None:
            return False
        jax_top2_gap(jeng, prompt, tokens)          # the reference's forward, compiled once
        seq = np.concatenate([prompt, np.asarray(tokens, np.int32)]).astype(np.int32)[None]
        logits = np.asarray(_JAX_FORWARD[id(jeng)](jeng.params, jnp.asarray(seq)))[0, -1]
        return bool(logits.max() - logits[token] < TOL)

    return certify


STREAM_RUNS = [(arch, name) for arch, (_, runs) in _arch_runs().items() for name in runs]


@pytest.mark.parametrize("arch,name", STREAM_RUNS)
def test_tp2_streams_match_jax_tp1(served, arch, name, monkeypatch):
    """Each rank's streams against the reference's at tp=1, a parting
    certified (module docstring); at least one stream of each run equal."""
    archs, jax_side, got = served
    side = jax_side[arch]
    kind, kw, par, reqs = archs[arch][1][name]
    ref, teng = side["ref"][name], side["teng"]
    jeng = side["engs"][bool(par.get("kv_quant"))]
    for rank in range(TP):
        streams, stats = got[rank][f"{arch} {name}"]
        port = _requests(streams)
        if side["tcfg"].rglru is not None:
            wave_len = lambda rid: max(len(p) for p, *_ in reqs[rid - rid % 2:rid - rid % 2 + 2])
            _certify(jeng, teng, reqs, port, ref, pad_to=wave_len if kind == "wave" else None)
        else:
            certify = (_near_top(jeng) if side["tcfg"].moe is None or par.get("kv_quant") else
                       _moe_certify(side, monkeypatch, ring=side["tcfg"].window > 0))
            assert_streams_match(teng, _as_run(reqs, kind, kw), port, ref,
                                 max_flips=len(reqs) - 1, jeng=jeng, certify=certify)
    stats = got[0][f"{arch} {name}"][1]
    if kw.get("spec_k"):
        assert stats["spec_steps"] > 0 and stats["prefill_chunks"] > 0
    if kind == "paged" and not kw.get("prefill_chunk"):
        assert stats["shared_block_hits"] > 0


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_every_rank_routes_alike_in_serving(served, arch):
    """Every MoE layer call of every run: the same top experts and the same
    dropped assignments on both ranks; deepseek's 512-token admissions
    drop some."""
    _, _, got = served
    a, b = (got[r][f"{arch} routes"] for r in range(TP))
    assert len(a) == len(b) > 0
    for (e0, d0), (e1, d1) in zip(a, b):
        np.testing.assert_array_equal(e0, e1)
        np.testing.assert_array_equal(d0, d1)
    if arch == "deepseek-moe-16b":
        assert sum(len(d) for e, d in a if len(e) == 512) > 0


def test_serve_cli_at_tp2_serves_an_moe_arch(capfd):
    """``serve --arch deepseek-moe-16b --weight-quant int4 --tp 2``: two
    ranks draw their int4 shards, and rank 0 prints the serve line."""
    from repro_torch.launch import serve as serve_cli
    done = serve_cli.main(["--arch", "deepseek-moe-16b", "--device", "cpu", "--tp", "2",
                           "--dist-backend", "gloo", "--top-k", "1", "--weight-quant", "int4",
                           "--requests", "3", "--max-new", "6"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.output) == 6 for r in done)
    assert "arch=deepseek-moe-16b-smoke, tp=2, device=cpu, gloo)" in capfd.readouterr().out
