"""Tensor parallelism of the RG-LRU, MoE and MLA families
(recurrentgemma-9b, deepseek-moe-16b, mixtral-8x7b, minicpm3-4b) against
the JAX package.

The ranks are processes on the CPU joined over gloo, each running the
kernels' plain versions on its shard; every rank group (tp 2, tp 4) is
spawned once for all its cases (tests/torch_tp_ranks.py, no jax in the
ranks).  What they are held to:

* The plans: ``moe.moe_plan``, the RG-LRU ``_dims`` and the MLA head
  counts of ``ShardPlan`` equal the JAX package's for every config and tp
  1/2/4/8, raising the same ValueErrors, and ``check_supported`` admits a
  config at a tp exactly where they split.
* The shards: every leaf of a rank's bridged tree equals the JAX tp=1
  tree cut by the JAX package's ``param_specs`` at that tp (its expert
  blocks laid out as ``moe_plan``'s blocks, where ffn_tp > 1); quantized
  expert blocks and shared experts are bit for bit the JAX quantization of
  the global leaf sliced (int8 scales over the whole K, int4 groups local
  to the rank's rows: ``quantize(k_shards=ffn_tp)``).
* Logits at tp 2 and 4 against the JAX package at **tp=1** on the same
  bridged weights, within 5e-2: a 16- and a 13-token prefill, a decode step
  and a width-5 verify chunk (none on recurrentgemma: a chunk carries no
  recurrent state), for reduced deepseek-moe-16b in bf16 and int4 weights
  (groups of 32, so that the shared experts' int4 rows split at tp 4),
  mixtral-8x7b at a window of 16 (the decode step and the chunk wrap its
  ring), minicpm3-4b and recurrentgemma-9b (its embed table vocab-sharded;
  its tolerance the reference's own spread where that is larger, as
  tests/test_torch_rglru.py documents), and deepseek with 2 experts at tp 4,
  which takes the ffn_tp = 2 path no real config reaches at tp <= 8.
* Every rank routes the same experts and drops the same assignments (the
  MoE LOG of each forward, a cacheless 2 x 160-token prefill past 256
  tokens included, whose repeated tokens overflow their experts).
* Every collective of the 16-token prefill and of a decode step equals the
  JAX package's ``comm_stats`` at the same tp (kind, tag, bytes), its
  scanned groups' bodies repeated once a layer; JAX traces in a subprocess
  with 4 virtual CPU devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import get_config as jget_config
from repro.core import embedding as jemb
from repro.core import wquant as jwq
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models.common import ShardPlan as JShardPlan
from repro.models.transformer import build_groups
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS, ParallelConfig, get_config
from repro_torch.core import embedding as temb
from repro_torch.core import wquant
from repro_torch.launch import mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models.common import Dist, ShardPlan
from test_torch_mixtral import ROUTER_TIE, _ROUTE_LOG, _logged_route
from test_torch_model import jax_engine
from test_torch_rglru import reference_logits
from test_torch_tp import JAX_COMM, LAYER_TAGS, PHASES, _bits, _torch_tree
import torch_tp_ranks

FAMILIES = ("recurrentgemma-9b", "deepseek-moe-16b", "mixtral-8x7b", "minicpm3-4b")
TOL = 5e-2
B, T = 2, 17
GS = 32       # int4 group: the shared experts' 128 rows split 4 ways
# name -> (arch, config overrides ("moe": MoEConfig overrides), weight_quant,
# tps, vocab-sharded table)
CASES = {
    "deepseek": ("deepseek-moe-16b", {}, "none", (2, 4), False),
    "deepseek-int4": ("deepseek-moe-16b", {}, "int4", (2, 4), False),
    "deepseek-ffn_tp2": ("deepseek-moe-16b", {"moe": {"n_experts": 2}}, "none", (4,), False),
    "mixtral": ("mixtral-8x7b", {"window": 16}, "none", (2, 4), False),
    "minicpm3": ("minicpm3-4b", {}, "none", (2, 4), False),
    "recurrentgemma": ("recurrentgemma-9b", {}, "none", (2, 4), True),
}


def _cfg(get, arch, over, reduced=True):
    cfg = get(arch).reduced() if reduced else get(arch)
    over = dict(over)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return dataclasses.replace(cfg, **over)


def _jax_parallel(quant):
    return dict(weight_quant=quant, wq_group_size=GS) if quant != "none" else {}


# the JAX package's records, with the overrides of CASES applied
JAX_FAMILY_COMM = JAX_COMM.replace(
    "    cfg = dataclasses.replace(get_config(arch).reduced(), **over)\n",
    "    cfg = get_config(arch).reduced()\n"
    "    if 'moe' in over:\n"
    "        over = dict(over, moe=dataclasses.replace(cfg.moe, **over['moe']))\n"
    "    cfg = dataclasses.replace(cfg, **over)\n")
assert JAX_FAMILY_COMM != JAX_COMM


@pytest.fixture(scope="module")
def jax_comm_proc():
    """The JAX package's records per (case, tp, phase), traced in a
    subprocess with 4 virtual devices (started at once, read when needed)."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    specs = [(n, a, o, q, t, _jax_parallel(q), sh) for n, (a, o, q, t, sh) in CASES.items()]
    proc = subprocess.Popen([sys.executable, "-c", JAX_FAMILY_COMM, json.dumps(specs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_comm(jax_comm_proc, runs):
    out, err = jax_comm_proc.communicate(timeout=300)
    assert jax_comm_proc.returncode == 0, err[-3000:]
    return json.loads(out)


def _long_tokens(vocab):
    """2 x 160 tokens, most of them one id: past 256 tokens, the repeated
    token's experts overflow their capacity."""
    rng = np.random.default_rng(9)
    long = np.full((2, 160), 7, np.int64)
    long[:, ::5] = rng.integers(0, vocab, (2, 32))
    return long


@pytest.fixture(scope="module")
def runs(jax_comm_proc):
    """JAX tp=1 reference logits (and the reference's spread, the tolerance
    of the RG-LRU hybrid) per case, the port's tp=1 drops of the long
    prefill, and each rank group's results (one spawn per tp, both at
    once) -> (refs, tols, drops, {tp: rank results})."""
    refs, tols, drops, cases = {}, {}, {}, {}
    for name, (arch, over, quant, tps, sharded) in CASES.items():
        jcfg, tcfg = _cfg(jget_config, arch, over), _cfg(get_config, arch, over)
        jeng, tree = jax_engine(jcfg, max_len=32, **_jax_parallel(quant))
        tokens = np.random.default_rng(len(arch)).integers(0, jcfg.vocab_size, (B, T))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmoe, "route", _logged_route)
            _ROUTE_LOG.clear()
            default, exact = reference_logits(jeng, tokens)
            jax.effects_barrier()
        refs[name] = default
        tols[name] = max(TOL, float(np.abs(default - exact).max())) if jcfg.rglru else TOL
        cases[name] = {"cfg": tcfg, "tree": _torch_tree(tree), "tokens": tokens,
                       "parallel": _jax_parallel(quant), "tps": tps, "sharded_table": sharded,
                       "verify": tcfg.rglru is None}
        if tcfg.moe is not None:
            # the default compilation's routes: (B, T, k) a MoE layer, in order
            n_moe = sum(tcfg.is_moe_layer(i) for i in range(tcfg.n_layers))
            cases[name]["jax_routes"] = [np.asarray(r, np.int64).reshape(B, T, -1)
                                         for r in _ROUTE_LOG[:n_moe]]
            cases[name]["long"] = _long_tokens(tcfg.vocab_size)
            teng = torch_tp_ranks._engine(Dist(), "cpu", tcfg, cases[name]["tree"],
                                          _jax_parallel(quant))
            tmoe.LOG = []
            with torch.inference_mode():
                teng.forward(torch.from_numpy(cases[name]["long"]))
            drops[name] = [tmoe.dropped(r).numpy() for r in tmoe.LOG]
            cases[name]["long_routes"] = [r["top_e"].numpy() for r in tmoe.LOG]
            tmoe.LOG = None
    temb.REPLICATE_BYTES_LIMIT = 512 * 2**20
    cfg = get_config("yi-9b").reduced()
    table = torch.randn((1, 510, cfg.d_model),
                        generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    with ThreadPoolExecutor(2) as pool:
        futures = {tp: pool.submit(mesh.spawn, torch_tp_ranks.run_model_cases, tp, cases,
                                   (cfg, table), device="cpu") for tp in (2, 4)}
        got = {tp: f.result() for tp, f in futures.items()}
    return refs, tols, drops, got


# -- the plans ---------------------------------------------------------------


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_family_plans_equal_jax(arch, tp, reduced):
    """moe_plan, the experts a rank serves, the RG-LRU dims and the MLA
    head counts (``ShardPlan``'s padded and local heads) as the JAX
    package's, or the same ValueError; check_supported admits the four
    archs at tp exactly where every plan splits."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    splits = True
    if tcfg.moe is not None:
        want = _outcome(lambda: jmoe.moe_plan(jcfg.moe, tp))
        assert _outcome(lambda: tmoe.moe_plan(tcfg.moe, tp)) == want
        if want[0] != "ValueError":
            n_blocks, _, local_blocks, _ = want
            for rank in range(tp):
                blk0 = rank * local_blocks
                assert tmoe.local_experts(tcfg.moe, tp, rank) == (
                    blk0 * jcfg.moe.n_experts // n_blocks,
                    max(1, local_blocks * jcfg.moe.n_experts // n_blocks))
        splits &= want[0] != "ValueError"
    if tcfg.rglru is not None:
        want = _outcome(lambda: jrglru._dims(jcfg, tp))
        assert _outcome(lambda: trglru._dims(tcfg, tp)) == want
        splits &= want[0] != "ValueError"
    if tcfg.mla is not None:
        jp, tplan = JShardPlan.make(jcfg, tp), ShardPlan.make(tcfg, tp)
        assert (tplan.n_heads_p, tplan.local_q) == (jp.n_heads_p, jp.local_q)
    if arch in FAMILIES:
        par = ParallelConfig(tp=tp, weight_quant="int4", kv_quant=True)
        if splits:
            TM.check_supported(tcfg, par)
        else:
            with pytest.raises(ValueError):
                TM.check_supported(tcfg, par)


def test_plans_refuse_what_does_not_split():
    """The JAX plans' refusals reach check_supported as ValueErrors naming
    the arch: 6 experts at tp 4, tp 8 over 3 experts, an expert d_ff that
    ffn_tp does not divide, 6 RG-LRU gate blocks at tp 4; the features
    left at tp=1 stay refused by name."""
    ds, rg = get_config("deepseek-moe-16b").reduced(), get_config("recurrentgemma-9b").reduced()
    moe = lambda **kw: dataclasses.replace(ds, moe=dataclasses.replace(ds.moe, **kw))
    for cfg, tp, msg in ((moe(n_experts=6), 4, "n_experts 6 not divisible by tp 4"),
                         (moe(n_experts=3), 8, "tp 8 not divisible by n_experts 3"),
                         (moe(n_experts=2, expert_d_ff=126), 8, "expert_d_ff not divisible"),
                         (moe(shared_d_ff=130), 4, "shared_d_ff 130"),
                         (dataclasses.replace(rg, n_heads=6, d_model=384), 4, "n_blocks 6")):
        with pytest.raises(ValueError, match=f"{cfg.name}: .*{msg}"):
            TM.check_supported(cfg, ParallelConfig(tp=tp))
    for arch in ("mamba2-1.3b", "internvl2-26b", "musicgen-medium"):
        for tp in (2, 4, 8):        # served at every tp since the SSD heads split
            TM.check_supported(get_config(arch), ParallelConfig(tp=tp))
    # the control plane serves every family at tp>1 and dp>1; the packed
    # weight file stays refused at tp>1
    for par in (ParallelConfig(tp=2, fault_plan="step:at=1"),
                ParallelConfig(tp=2, overload_degrade=True)):
        TM.check_supported(get_config("musicgen-medium"), par)
    for par in (ParallelConfig(tp=2, dp=2, overlap_decode=True),
                ParallelConfig(tp=2, overlap_decode=True)):
        TM.check_supported(ds, par)
    for par, kw, name in ((ParallelConfig(tp=2, dp=2, overlap_decode=True,
                                          weight_quant="int8"), {"wq_cache": "x.npz"},
                           "wq_cache at tp>1"),
                          (ParallelConfig(tp=2, weight_quant="int8"), {"wq_cache": "x.npz"},
                           "wq_cache at tp>1")):
        with pytest.raises(NotImplementedError, match=name):
            TM.check_supported(ds, par, **kw)
    # the sequence-sharded cache serves full-causal GQA layers (MoE FFNs
    # beside them too), not MLA's latents or a sliding-window ring
    TM.check_supported(ds, ParallelConfig(tp=2, dp=2, kv_seq_shard=True))
    for arch in ("minicpm3-4b", "mixtral-8x7b"):
        with pytest.raises(NotImplementedError, match="kv_seq_shard with mla"):
            TM.check_supported(get_config(arch), ParallelConfig(tp=2, kv_seq_shard=True))


# -- the shards -----------------------------------------------------------------


def _jax_layout(path: str, a: np.ndarray, cfg, tp: int) -> np.ndarray:
    """A tp=1 leaf in the JAX package's global layout at ``tp``: an expert
    block (E, d, f) / (E, f, d) as moe_plan's (E * ffn_tp, d, f / ffn_tp)
    blocks where ffn_tp > 1; every other leaf as it is."""
    name = path.rsplit("'", 2)[-2]
    if cfg.moe is None or "'shared'" in path or name not in ("w_up", "w_gate", "w_down"):
        return a
    m, d = cfg.moe, cfg.d_model
    block = (m.n_experts, m.expert_d_ff, d) if name == "w_down" else (m.n_experts, d,
                                                                       m.expert_d_ff)
    _, dff_b, _, ffn_tp = jmoe.moe_plan(m, tp)
    if ffn_tp == 1 or a.shape[-3:] != block:      # a dense FFN's leaf
        return a
    *lead, E, k, n = a.shape
    if name == "w_down":                       # (E, f, d): rows of each expert
        return a.reshape(*lead, E * ffn_tp, dff_b, n)
    a = a.reshape(*lead, E, k, ffn_tp, dff_b)
    return np.moveaxis(a, -2, -3).reshape(*lead, E * ffn_tp, k, dff_b)


def _spec_slice(a: np.ndarray, spec, tp: int, rank: int) -> np.ndarray:
    """This rank's block of ``a`` under PartitionSpec ``spec``."""
    for axis, entry in enumerate(tuple(spec)):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            n = a.shape[axis] // tp
            a = np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)
    return a


@pytest.mark.parametrize("name,tp", [(n, tp) for n, c in CASES.items() if c[2] == "none"
                                     for tp in c[3]])
def test_shards_equal_jax_param_specs_slice(name, tp):
    """Every leaf of every rank's bridged tree (layers, table, lm_head)
    equals the JAX tp=1 tree cut by ``param_specs`` at tp, bit for bit."""
    arch, over, _, _, sharded = CASES[name]
    jcfg, tcfg = _cfg(jget_config, arch, over), _cfg(get_config, arch, over)
    lim = 0 if sharded else 512 * 2**20
    jemb.REPLICATE_BYTES_LIMIT = temb.REPLICATE_BYTES_LIMIT = lim
    try:
        _, tree = jax_engine(jcfg, max_len=32)
        specs = JM.param_specs(JM.ModelCtx.make(jcfg, JParallelConfig(tp=tp, dp=1,
                                                                     remat=False)))
        ttree = _torch_tree(tree)
        for rank in range(tp):
            cut = jax.tree_util.tree_map_with_path(
                lambda p, a, s: _spec_slice(_jax_layout(jax.tree_util.keystr(p), a, jcfg, tp),
                                            s, tp, rank), tree, specs)
            want = bridge._tree_layers(_torch_tree(cut), tcfg)
            got = bridge.params_from_jax(ttree, tcfg, "cpu", Dist(tp, rank))
            for i, layer in enumerate(got["layers"]):
                leaves = TM._flat_leaves(layer)
                assert sorted(leaves) == sorted(want[i]), i
                for leaf, t in leaves.items():
                    np.testing.assert_array_equal(_bits(t.contiguous()), _bits(want[i][leaf][0]),
                                                  err_msg=f"layer {i} {leaf} rank {rank}")
            for key, t in (("table", got["embed"]["table"]), ("lm_head", got["lm_head"])):
                w = cut["embed"]["table"] if key == "table" else cut["lm_head"]
                np.testing.assert_array_equal(_bits(t), _bits(bridge.to_torch(w)), err_msg=key)
            assert (got["embed"]["table"].shape[1] < tcfg.vocab_size) == sharded
    finally:
        jemb.REPLICATE_BYTES_LIMIT = temb.REPLICATE_BYTES_LIMIT = 512 * 2**20


@pytest.mark.parametrize("n_experts,tp", [(4, 2), (4, 4), (2, 4)])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_expert_shards_are_the_jax_quantization_sliced(mode, n_experts, tp):
    """init_params at tp: each rank's expert blocks are bit for bit the JAX
    package's ``quantize(global (E, K, N) block)`` sliced to its experts,
    and where ffn_tp > 1 (2 experts at tp 4) to its columns of w_up/w_gate
    and its rows of w_down: int8 scales over the whole K, int4 groups
    local to the rank's rows (``k_shards=ffn_tp``); the shared experts'
    w_down as a dense row-parallel FFN's (``k_shards=tp``).  The global
    leaves are the tp=1 draws of the same seed."""
    ds = get_config("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(ds, moe=dataclasses.replace(ds.moe, n_experts=n_experts))
    glob = TM.init_params(cfg, seed=2, device="cpu")
    _, dff_b, _, ffn_tp = tmoe.moe_plan(cfg.moe, tp)
    for rank in range(tp):
        par = ParallelConfig(tp=tp, weight_quant=mode, wq_group_size=GS)
        mine = TM.init_params(cfg, par, seed=2, device="cpu", dist=Dist(tp, rank))
        e_lo, local_e = tmoe.local_experts(cfg.moe, tp, rank)
        j = rank % ffn_tp
        for name in ("w_up", "w_gate", "w_down", "shared.w_up", "shared.w_down"):
            leaf = TM._flat_leaves(glob["layers"][1])[name]
            w = leaf.view(torch.int16).numpy().view(jax.numpy.bfloat16)
            shared = name.startswith("shared.")
            ks = tp if name == "shared.w_down" else ffn_tp if name == "w_down" else 1
            want = jwq.quantize(w, mode, GS, k_shards=ks)
            q, s = np.asarray(want.q), np.asarray(want.scale)
            if not shared:
                q, s = q[e_lo:e_lo + local_e], s[e_lo:e_lo + local_e]
            n = cfg.moe.shared_d_ff // tp if shared else dff_b
            i = rank if shared else j
            if name.endswith("w_down") and (shared or ffn_tp > 1):
                per = 2 if mode == "int4" else 1
                q = q[..., i * n // per:(i + 1) * n // per, :]
                if mode == "int4":
                    s = s[..., i * n // want.group:(i + 1) * n // want.group, :]
            elif shared or ffn_tp > 1:
                q, s = q[..., i * n:(i + 1) * n], s[..., i * n:(i + 1) * n]
            got = TM._flat_leaves(mine["layers"][1])[name]
            assert isinstance(got, wquant.QuantWeight), name
            np.testing.assert_array_equal(_bits(got.q), q, err_msg=name)
            np.testing.assert_array_equal(_bits(got.scale), s.view(np.int16), err_msg=name)


# -- logits, routes and collectives at tp 2 and 4 -------------------------------


LOGIT_CASES = [(n, tp) for n, c in CASES.items() for tp in c[3]]


@pytest.mark.parametrize("name,tp", LOGIT_CASES)
def test_logits_match_jax_tp1(runs, name, tp):
    refs, tols, _, got = runs
    ref, tol = refs[name], tols[name]
    phases = {k: v for k, v in PHASES.items() if k != "verify5" or CASES[name][0] !=
              "recurrentgemma-9b"}
    for rank, res in enumerate(r["cases"][name] for r in got[tp]):
        assert set(phases) <= set(res)
        for phase, sl in phases.items():
            assert res[phase].shape == ref[sl].shape
            np.testing.assert_allclose(res[phase], ref[sl], atol=tol, rtol=TOL,
                                       err_msg=f"{name} tp {tp} rank {rank} {phase}")
            np.testing.assert_array_equal(res[phase], got[tp][0]["cases"][name][phase])


@pytest.mark.parametrize("name,tp", [(n, tp) for n, tp in LOGIT_CASES
                                     if CASES[n][0] in ("deepseek-moe-16b", "mixtral-8x7b")])
def test_every_rank_routes_alike(runs, name, tp):
    """The 320-token prefill routed by the ranks' own routers: each MoE
    layer call's top experts and dropped assignments are the same on every
    rank.  Routed as the port routed it at tp=1, it drops the same
    assignments (some, but none with 2 experts of top 2: every token takes
    both).  Every token a rank's router ranks apart from a replayed route
    (there, and where the logits' forwards route as the reference routed)
    is a router near-tie, within ROUTER_TIE."""
    _, _, drops, got = runs
    cases = [r["cases"][name] for r in got[tp]]
    routes = [c["routes"] for c in cases]
    assert len(routes[0]) == len(drops[name])
    for other in routes[1:]:
        assert len(other) == len(routes[0])
        for (e0, d0), (e1, d1) in zip(routes[0], other):
            np.testing.assert_array_equal(e0, e1)
            np.testing.assert_array_equal(d0, d1)
    cfg = _cfg(get_config, *CASES[name][:2])
    for c in cases:
        for (_, d), want in zip(c["long_replayed"], drops[name]):
            np.testing.assert_array_equal(d, want)
        assert all(m < ROUTER_TIE for m in c["router_ties"])
    n_drops = sum(len(d) for d in drops[name])
    assert (n_drops > 0) == (cfg.moe.n_experts > cfg.moe.top_k)


def _expand_groups(records, cfg):
    """JAX's records with each scanned group's body repeated n times (an
    unrolled group is traced once a layer already)."""
    idx = [i for i, r in enumerate(records) if r[1] in LAYER_TAGS]
    if not idx:
        return records
    lo, hi = idx[0], idx[-1] + 1
    body, groups = records[lo:hi], build_groups(cfg)
    per = len(body) // sum(len(g.subs) for g in groups)
    out, k = [], 0
    for g in groups:
        out += body[k:k + per * len(g.subs)] * g.n
        k += per * len(g.subs)
    assert k == len(body)
    return records[:lo] + out + records[hi:]


@pytest.mark.parametrize("name,tp", LOGIT_CASES)
def test_collective_records_equal_jax(runs, jax_comm, name, tp):
    """Every collective of the 16-token prefill (sequence-sharded) and of a
    decode step with its top-k, (kind, tag, bytes), in order: 2 L
    all-reduces and two top-k gathers a decode step, plus the vocab-sharded
    table's all-reduce (recurrentgemma)."""
    _, _, _, got = runs
    arch, over = CASES[name][:2]
    jcfg = _cfg(jget_config, arch, over)
    for phase in ("prefill16", "decode"):
        want = [tuple(r) for r in _expand_groups(jax_comm[f"{name} tp{tp} {phase}"], jcfg)]
        for res in (r["cases"][name] for r in got[tp]):
            assert [tuple(r) for r in res[f"{phase}_records"]] == want, phase
    kinds = [r[:2] for r in want]
    n_ar = 2 * jcfg.n_layers + (1 if CASES[name][4] else 0)
    assert sum(k == "all_reduce" for k, _ in kinds) == n_ar
    assert [t for k, t in kinds if k == "all_gather"] == ["topk_vals", "topk_idx"]
