"""Tensor parallelism of the port (``models/common.py`` Dist and ShardPlan,
``core/collectives.py``, ``core/sync_policy.py``, the sharded weights,
embedding, top-k and layers) against the JAX package.

The ranks are processes on the CPU joined over gloo (``launch/mesh.py``),
each running the kernels' plain versions on its shard; every rank group
(tp 2, tp 4) is spawned once for all its cases (tests/torch_tp_ranks.py,
which imports no jax).  What they are held to:

* ``ShardPlan`` equals the JAX one for every config and tp, raising where
  it raises; quantized shards are bit for bit ``repro.core.wquant.quantize
  (global, k_shards=tp)`` sliced (int8 scales over the whole K, int4
  groups shard-local).
* The collectives give the right values and records at world 2 and 4,
  sequence lengths that tp does not divide included.
* Logits at tp 2 and 4 against the JAX package at **tp=1** on the same
  bridged weights, within 5e-2 (tests/test_torch_model.py's tolerance): a
  16- and a 13-token prefill, a decode step and a width-5 verify chunk,
  the residual stream sequence-sharded or (``seq_parallel=False``)
  replicated.
  The JAX package cannot serve the tp > 1 side where tp does not divide
  the sequence (its ``shard_residual`` takes s // tp rows), so its tp=1
  forward is the reference; its own checks show tp=1 and tp=4 agree where
  it runs.
* Every collective of a 16-token prefill and of a decode step equals the
  JAX package's ``comm_stats`` at the same tp (kind, tag, bytes), its
  scanned layer body repeated once a layer; JAX traces in a subprocess
  with 4 virtual CPU devices, as tests/test_distributed.py runs it.
* The paper's ablations, as tests/dist_checks.py asserts them: top-k
  before the gather samples the same tokens on < 1/10 of the bytes; token
  ids cost 0 bytes against rank 0's activations, and a vocab-sharded
  table gives the replicated one's activations; a parallel-residual layer
  all-reduces once with ``one_shot_sync``, twice without.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import wquant as jwq
from repro.models import model as JM
from repro.models.common import ShardPlan as JShardPlan
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS, ParallelConfig, get_config
from repro_torch.core import wquant
from repro_torch.launch import mesh
from repro_torch.models import model as TM
from repro_torch.models.common import Dist, ShardPlan
from test_torch_model import jax_engine
import torch_tp_ranks

TOL = 5e-2
B, T = 2, 17          # reference rows and positions
LAYER_TAGS = {"pre_mixer", "mixer_reduce", "pre_ffn", "ffn_reduce", "one_shot", "attn_reduce"}
# name -> (arch, config overrides, weight_quant, tps, ParallelConfig kw, vocab-sharded table)
CASES = {
    "yi": ("yi-9b", {}, "none", (2, 4), {}, False),
    "qwen-int4": ("qwen-72b", {}, "int4", (2, 4), {}, True),
    "qwen-int8": ("qwen-72b", {}, "int8", (2, 4), {}, False),
    "gptj": ("gptj-parallel", {}, "none", (2, 4), {}, False),
    "gptj-2sync": ("gptj-parallel", {}, "none", (2, 4), {"one_shot_sync": False}, False),
    # the residual stream replicated at prefill and verify too (no sequence sharding)
    "yi-replicated": ("yi-9b", {}, "none", (2, 4), {"seq_parallel": False}, False),
    # one KV head replicated over the 4 ranks
    "yi-kv_rep": ("yi-9b", {"n_kv_heads": 1}, "none", (4,), {}, False),
    # 6 q heads over 2 KV heads: groups of 3 padded to 4; a vocab of 510 padded to 512
    "yi-padded": ("yi-9b", {"n_heads": 6, "n_kv_heads": 2, "vocab_size": 510}, "none", (4,),
                  {}, False),
}
ABLATION_TABLE_VOCAB = 510


def _cfgs(arch, over):
    return (dataclasses.replace(jget_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _torch_tree(tree):
    """The JAX package's numpy tree with every leaf a torch tensor (a
    quantized leaf the port's QuantWeight), so the ranks unpickle no jax."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch_tree(v) for v in tree)
    return bridge.to_torch(tree)


JAX_COMM = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import ParallelConfig, SamplingConfig, get_config
from repro.core import collectives as cc, embedding as emb
from repro.models import model as M
from repro.runtime.sampling import sample_tokens

out = {}
for name, arch, over, quant, tps, par_kw, sharded in json.loads(sys.argv[1]):
    emb.REPLICATE_BYTES_LIMIT = 0 if sharded else 512 * 2**20
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    for tp in tps:
        ctx = M.ModelCtx.make(cfg, ParallelConfig(tp=tp, dp=1, remat=False, **par_kw))
        mesh = compat.make_mesh((1, tp), ("data", "model"))

        def pre(params, tokens):
            return M.forward(params, tokens, ctx, caches=M.init_caches(ctx, tokens.shape[0], 32),
                             seq_sharded=True)[0]

        def dec(params, tokens):
            caches = M.init_caches(ctx, tokens.shape[0], 32)
            lg = M.forward(params, tokens, ctx, caches=caches, cur_pos=jnp.int32(16))[0]
            return sample_tokens(lg[:, -1], jax.random.key(0),
                                 SamplingConfig(greedy=True, top_k=1), ctx.plan, ctx.dist)

        for phase, fn, s, spec in (("prefill16", pre, 16, P("data", None, "model")),
                                   ("decode", dec, 1, P())):
            with cc.comm_stats() as st:
                jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=(M.param_specs(ctx),
                                                                 P("data", None)),
                                         out_specs=spec, check_vma=False)).lower(
                    M.param_shapes(ctx), jax.ShapeDtypeStruct((%d, s), jnp.int32))
            out[f"{name} tp{tp} {phase}"] = [(r.kind, r.tag, r.bytes) for r in st.records]
print(json.dumps(out))
""" % B


@pytest.fixture(scope="module")
def jax_comm_proc():
    """The JAX package's records per (case, tp, phase), traced in a
    subprocess with 4 virtual devices (started at once, read when needed)."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    specs = [(n, a, o, q, t, k, sh) for n, (a, o, q, t, k, sh) in CASES.items()]
    proc = subprocess.Popen([sys.executable, "-c", JAX_COMM, json.dumps(specs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_comm(jax_comm_proc, runs):
    """The subprocess's records: (case, tp, phase) -> [(kind, tag, bytes)]."""
    out, err = jax_comm_proc.communicate(timeout=300)
    assert jax_comm_proc.returncode == 0, err[-3000:]
    return json.loads(out)


@pytest.fixture(scope="module")
def runs(jax_comm_proc):
    """JAX tp=1 reference logits per case, and each rank group's results
    (one spawn per tp) -> (refs, {tp: rank results})."""
    refs, cases = {}, {}
    for name, (arch, over, quant, tps, par_kw, sharded) in CASES.items():
        jcfg, tcfg = _cfgs(arch, over)
        jeng, tree = jax_engine(jcfg, max_len=32, weight_quant=quant)
        # the same tokens for the cases of one arch (gptj with and without one_shot_sync)
        tokens = np.random.default_rng(len(arch)).integers(0, jcfg.vocab_size, (B, T))
        fwd = jax.jit(lambda p, t, ctx=jeng.ctx: JM.forward(p, t, ctx)[0])
        refs[name] = np.asarray(fwd(jeng.params, tokens.astype(np.int32)), np.float32)
        cases[name] = {"cfg": tcfg, "tree": _torch_tree(tree), "tokens": tokens,
                       "parallel": dict(par_kw, weight_quant=quant), "tps": tps,
                       "sharded_table": sharded}
    cfg = get_config("yi-9b").reduced()
    table = torch.randn((1, ABLATION_TABLE_VOCAB, cfg.d_model),
                        generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    got = {tp: mesh.spawn(torch_tp_ranks.run_model_cases, tp, cases, (cfg, table),
                          device="cpu") for tp in (2, 4)}
    return refs, got, table


# -- ShardPlan ---------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_shard_plan_equals_jax(arch, tp, reduced):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    try:
        want = JShardPlan.make(jcfg, tp)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(":")[-1].strip()):
            ShardPlan.make(tcfg, tp)
        return
    assert dataclasses.asdict(ShardPlan.make(tcfg, tp)) == dataclasses.asdict(want)


@pytest.mark.parametrize("over", [dict(n_heads=6, n_kv_heads=2), dict(n_heads=4, n_kv_heads=3),
                                  dict(n_heads=9, n_kv_heads=3)])
def test_shard_plan_raises_and_pads_as_jax(over):
    """Padded q groups, KV heads padded to a multiple of tp, and the tp that
    n_kv does not divide, which both refuse."""
    for tp in (2, 4, 8):
        jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **over)
        tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **over)
        try:
            want = dataclasses.asdict(JShardPlan.make(jcfg, tp))
        except ValueError:
            with pytest.raises(ValueError):
                ShardPlan.make(tcfg, tp)
            continue
        assert dataclasses.asdict(ShardPlan.make(tcfg, tp)) == want


# -- quantized shards ----------------------------------------------------------


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_shards_are_the_jax_quantization_sliced(mode, tp):
    """init_params at tp: every rank's packed values and scales are bit for
    bit the JAX package's ``quantize(global leaf, k_shards)`` sliced to the
    rank: column-parallel w_q/w_k/w_v/w_up/w_gate and the lm_head, w_o's
    heads, and the row-parallel w_down (int8 scales over the whole K,
    replicated; int4 groups of the shard's rows).  The global leaves are the
    tp=1 draws of the same seed."""
    cfg = dataclasses.replace(get_config("qwen-72b").reduced(), d_ff=1024)
    glob = TM.init_params(cfg, seed=2, device="cpu")
    gs = 64
    for rank in range(tp):
        par = ParallelConfig(tp=tp, weight_quant=mode, wq_group_size=gs)
        mine = TM.init_params(cfg, par, seed=2, device="cpu", dist=Dist(tp, rank))
        plan = ShardPlan.make(cfg, tp)
        for name in ("w_q", "w_k", "w_v", "w_o", "w_up", "w_gate", "w_down", "lm_head"):
            leaf = glob["lm_head"] if name == "lm_head" else glob["layers"][1][name]
            w = leaf.view(torch.int16).numpy().view(jnp.bfloat16)
            want = jwq.quantize(w, mode, gs, k_shards=tp if name == "w_down" else 1)
            q, s = np.asarray(want.q), np.asarray(want.scale)
            if name in ("w_down",):
                k = cfg.d_ff // tp
                q = q[..., rank * k // (2 if mode == "int4" else 1):
                      (rank + 1) * k // (2 if mode == "int4" else 1), :]
                if mode == "int4":
                    s = s[..., rank * k // want.group:(rank + 1) * k // want.group, :]
            elif name == "w_o":
                q, s = (a[rank * plan.local_q:(rank + 1) * plan.local_q] for a in (q, s))
            else:
                n = q.shape[-1] // tp
                q, s = q[..., rank * n:(rank + 1) * n], s[..., rank * n:(rank + 1) * n]
            got = mine["lm_head"] if name == "lm_head" else mine["layers"][1][name]
            assert isinstance(got, wquant.QuantWeight), name
            np.testing.assert_array_equal(_bits(got.q), q, err_msg=name)
            np.testing.assert_array_equal(_bits(got.scale), s.view(np.int16), err_msg=name)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_padded_quantized_shards_alike_from_init_and_bridge(mode):
    """6 q heads over 2 KV heads at tp 4 (groups of 3 padded to 4) and a
    vocab of 510 padded to 512: a tp=1 quantized tree cut by
    ``shard_leaf`` (the bridge's path: the quantized values padded with
    zeros, the scales with the scale of a zero column) is bit for bit
    init_params' shards (the bf16 leaf padded, then quantized)."""
    cfg = dataclasses.replace(get_config("yi-9b").reduced(), n_heads=6, n_kv_heads=2,
                              vocab_size=510)
    tp, gs = 4, 64
    glob = TM.init_params(cfg, ParallelConfig(weight_quant=mode, wq_group_size=gs), seed=2,
                          device="cpu")
    plan = ShardPlan.make(cfg, tp)
    for rank in range(tp):
        mine = TM.init_params(cfg, ParallelConfig(tp=tp, weight_quant=mode, wq_group_size=gs),
                              seed=2, device="cpu", dist=Dist(tp, rank))
        for name in ("w_q", "w_k", "w_v", "w_o", "w_up", "w_gate", "w_down", "lm_head"):
            leaf = glob[name] if name == "lm_head" else glob["layers"][0][name]
            got = TM.shard_leaf(name, leaf, cfg, plan, rank)
            want = mine[name] if name == "lm_head" else mine["layers"][0][name]
            assert (got.mode, got.group, got.k) == (want.mode, want.group, want.k), name
            for a, b in ((got.q, want.q), (got.scale, want.scale)):
                np.testing.assert_array_equal(_bits(a.contiguous()), _bits(b), err_msg=name)


# -- collectives -------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_collectives_values_and_records(runs, tp):
    """Each wrapper against numpy on values every rank can make, a sequence
    of 13 (not a multiple of tp) included, and its records: kind, tag,
    wire bytes (all-reduce twice its payload; the gathers their padded
    local chunk, the reduce-scatter its padded input)."""
    _, got, _ = runs
    parts = np.random.default_rng(0).standard_normal((tp, 2, 13, 6)).astype(np.float32)
    c = -(-13 // tp)
    for rank, res in enumerate(r["collectives"] for r in got[tp]):
        lo, hi = res["chunk"]
        assert (lo, hi) == (min(13, rank * c), min(13, (rank + 1) * c))
        np.testing.assert_allclose(res["all_reduce"], parts.sum(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(res["all_gather"],
                                      np.concatenate([p[:, :3] for p in parts], axis=1))
        np.testing.assert_array_equal(res["gather_odd"], parts[0])
        np.testing.assert_allclose(res["reduce_scatter"], parts.sum(0)[:, lo:hi], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(res["broadcast"], parts[0])
        f4 = 4 * 2 * 6
        assert res["records"] == [("all_reduce", "t_ar", 2 * f4 * 13),
                                  ("all_gather", "t_ag", f4 * 3),
                                  ("all_gather", "t_ago", f4 * c),
                                  ("reduce_scatter", "t_rs", f4 * c * tp),
                                  ("broadcast", "t_bc", f4 * 13)]


# -- logits against the JAX package at tp=1 -----------------------------------


PHASES = {"prefill16": np.s_[:, :16], "prefill13": np.s_[:, :13], "decode": np.s_[:, 16:17],
          "verify5": np.s_[:, 12:17]}
LOGIT_CASES = [(n, tp) for n, c in CASES.items() for tp in c[3]]


@pytest.mark.parametrize("name,tp", LOGIT_CASES)
def test_logits_match_jax_tp1(runs, name, tp):
    refs, got, _ = runs
    ref = refs[name]
    for rank, res in enumerate(r["cases"][name] for r in got[tp]):
        for phase, sl in PHASES.items():
            np.testing.assert_allclose(res[phase], ref[sl], atol=TOL, rtol=TOL,
                                       err_msg=f"{name} tp {tp} rank {rank} {phase}")
            assert res[phase].shape == ref[sl].shape
        # the ranks hold the same replicated logits
        for phase in PHASES:
            np.testing.assert_array_equal(res[phase], got[tp][0]["cases"][name][phase])


def _expand_layers(records, n_layers):
    """JAX's records with its scanned layer body repeated once a layer."""
    idx = [i for i, r in enumerate(records) if r[1] in LAYER_TAGS]
    if not idx:
        return records
    lo, hi = idx[0], idx[-1] + 1
    return records[:lo] + records[lo:hi] * n_layers + records[hi:]


@pytest.mark.parametrize("name,tp", LOGIT_CASES)
def test_collective_records_equal_jax(runs, jax_comm, name, tp):
    """Every collective of the 16-token prefill (sequence-sharded) and of a
    decode step with its top-k, (kind, tag, bytes), in order."""
    _, got, _ = runs
    n_layers = _cfgs(*CASES[name][:2])[1].n_layers
    for phase in ("prefill16", "decode"):
        want = [tuple(r) for r in _expand_layers(jax_comm[f"{name} tp{tp} {phase}"], n_layers)]
        for res in (r["cases"][name] for r in got[tp]):
            assert [tuple(r) for r in res[f"{phase}_records"]] == want, phase
    if name == "qwen-int4":      # the vocab-sharded table's one all-reduce
        assert want[0][:2] == ("all_reduce", "embed_shard_merge")


# -- the paper's ablations ----------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_topk_sync_ablation(runs, tp):
    """Section 2.1b: the same sampled tokens (top_k 16, one seeded draw on
    every rank), on fewer than a tenth of the full-row gather's bytes."""
    _, got, _ = runs
    for res in (r["ablations"] for r in got[tp]):
        (t_sync, b_sync), (t_full, b_full) = res["topk_sync=True"], res["topk_sync=False"]
        np.testing.assert_array_equal(t_sync, t_full)
        assert b_sync < b_full / 10, (b_sync, b_full)
        np.testing.assert_array_equal(t_sync, got[tp][0]["ablations"]["topk_sync=True"][0])


@pytest.mark.parametrize("tp", [2, 4])
def test_id_broadcast_ablation(runs, tp):
    """Section 2.1a: over a replicated table token ids cost 0 bytes and
    rank 0's activations more, with the same activations; a vocab-sharded
    table (vocab 510 padded to a multiple of tp) gives the replicated
    table's activations through one all-reduce."""
    _, got, table = runs
    for res in (r["ablations"] for r in got[tp]):
        x_id, rec_id = res["embed replicated id_broadcast=True"]
        x_bc, rec_bc = res["embed replicated id_broadcast=False"]
        assert rec_id == [] and [r[:2] for r in rec_bc] == [("broadcast", "embed_bcast")]
        np.testing.assert_array_equal(x_id, x_bc)
        x_sh, rec_sh = res["embed sharded id_broadcast=True"]
        np.testing.assert_array_equal(x_sh, x_id)
        assert [r[:2] for r in rec_sh] == [("all_reduce", "embed_shard_merge")]
        x_shb, rec_shb = res["embed sharded id_broadcast=False"]
        np.testing.assert_array_equal(x_shb, x_id)
        assert [r[1] for r in rec_shb] == ["embed_shard_merge", "embed_bcast"]


@pytest.mark.parametrize("tp", [2, 4])
def test_one_shot_sync_ablation(runs, tp):
    """Section 2.2: a decode step of the parallel-residual model all-reduces
    once a layer with ``one_shot_sync`` (the fused kernel's one buffer) and
    twice without, to logits within the bf16 tolerance of each other."""
    _, got, _ = runs
    n_layers = get_config("gptj-parallel").reduced().n_layers
    for r in got[tp]:
        one, two = r["cases"]["gptj"], r["cases"]["gptj-2sync"]
        tags = lambda res: [t for k, t, _ in res["decode_records"] if k == "all_reduce"]
        assert tags(one) == ["one_shot"] * n_layers
        assert tags(two) == ["attn_reduce", "ffn_reduce"] * n_layers
        np.testing.assert_allclose(one["decode"], two["decode"], atol=TOL, rtol=TOL)


def test_bridge_and_init_refuse_what_does_not_split():
    """An int4 w_down whose groups straddle the rank boundary, and bf16
    weights quantized after sharding, are refused."""
    cfg = get_config("yi-9b").reduced()
    w = torch.randn(cfg.d_ff, cfg.d_model).to(torch.bfloat16)
    qw = wquant.quantize(w, "int4", cfg.d_ff)        # one group over the whole K
    with pytest.raises(ValueError, match="straddle"):
        TM.shard_leaf("w_down", qw, cfg, ShardPlan.make(cfg, 2), 0)
    params = TM.init_params(cfg, ParallelConfig(tp=2), device="cpu", dist=Dist(2, 0))
    with pytest.raises(ValueError, match="quantized whole"):
        TM.quantize_params(params, ParallelConfig(tp=2, weight_quant="int8"))
    # the tp=1 layout is untouched by the sharding helpers
    assert TM.shard_leaf("w_q", w, cfg, ShardPlan.make(cfg, 1), 0) is w
