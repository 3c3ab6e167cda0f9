"""Tensor parallelism of the Mamba-2 SSD mixer with its tied head
(mamba2-1.3b), the modality prefix (internvl2-26b) and the multi-codebook
head (musicgen-medium) against the JAX package.

The ranks are processes on the CPU joined over gloo, each running the
kernels' plain versions on its shard; every rank group (tp 2, tp 4) is
spawned once for all its cases (tests/torch_tp_ranks.py, no jax in the
ranks).  Reduced configs: mamba2-1.3b's 2 SSD layers of 16 heads (8 or 4
a rank), internvl2-26b and musicgen-medium behind 8 positions of seeded
non-zero features.  What they are held to:

* The plans: the SSD ``_dims`` equal the JAX package's for the full and
  reduced config at tp 1/2/4/8, raising the same ValueError, and
  ``check_supported`` admits the three archs at every tp.
* The shards: every leaf of a rank's bridged tree equals the JAX tp=1 tree
  cut by the JAX package's ``param_specs`` at that tp, the tied table and
  a vocab-sharded internvl table included; the SSD conv weight, which the
  JAX package keeps whole and slices at forward time, equals what its
  ``_conv_weight_local`` gives each rank (traced with tp virtual devices).
* Logits at tp 2 and 4 against the JAX package at **tp=1** on the same
  bridged weights, within 5e-2: a 16- and a 13-token (frame) prefill and a
  decode step, behind the features; mamba2 also with a vocab of 510 at tp
  4 (its tied table's two pad rows zero, their logits -inf), internvl with
  2 KV heads (one replicated over 2 ranks at tp 4) over its table
  vocab-sharded, and in int4 weights with a vocab of 509 (its lm_head
  padded at tp 2), musicgen in bf16 and int4 (the rank's (4, d, V / tp)
  head dequantized for its einsum).
* The SSD state a rank carries after the prefill and a decode step: its
  heads of ``h`` and its x channels plus the B/C columns of the conv tail,
  against the same slices of the JAX state.
* Every collective of the 16-token prefill (prefix + 16 divides 2 and 4)
  and of a decode step equals the JAX package's ``comm_stats`` at the same
  tp (kind, tag, bytes); JAX traces in a subprocess with 4 virtual CPU
  devices.
* ``decode_weight_bytes``' ``rank_swept``: the bytes of one rank's shard,
  the tied table's vocab shard included.
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401
from repro import compat
from repro.configs import ParallelConfig as JParallelConfig
from repro.configs import get_config as jget_config
from repro.core import embedding as jemb
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.runtime import kvcache as jkvcache
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, get_config
from repro_torch.core import embedding as temb
from repro_torch.core.wquant import QuantWeight
from repro_torch.launch import mesh
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.models.common import Dist, ShardPlan
from test_torch_model import jax_engine
from test_torch_tp import _bits, _torch_tree
from test_torch_tp_families import _expand_groups, _spec_slice
import torch_tp_ranks

ARCHS = ("mamba2-1.3b", "internvl2-26b", "musicgen-medium")
TOL = 5e-2
B, T, MAX_LEN, GS = 2, 17, 32, 32
# name -> (arch, config overrides, weight_quant, tps, vocab-sharded table)
CASES = {
    "mamba2": ("mamba2-1.3b", {}, "none", (2, 4), False),
    "mamba2-padded": ("mamba2-1.3b", {"vocab_size": 510}, "none", (4,), False),
    "internvl": ("internvl2-26b", {"n_kv_heads": 2}, "none", (2, 4), True),
    "internvl-int4": ("internvl2-26b", {"n_kv_heads": 2, "vocab_size": 509}, "int4", (2,),
                      False),
    "musicgen": ("musicgen-medium", {}, "none", (2, 4), False),
    "musicgen-int4": ("musicgen-medium", {}, "int4", (2,), False),
}


def _cfg(get, arch, over):
    return dataclasses.replace(get(arch).reduced(), **over)


def _cuttable(case, tp) -> bool:
    """Whether ``param_specs`` can cut the case's global leaves at tp: no
    vocab padding, no KV head replicated over ranks (the JAX layout then
    holds its copies; an attention-free model has none)."""
    arch, over, quant = case[:3]
    cfg = _cfg(get_config, arch, over)
    return (quant == "none" and "vocab_size" not in over
            and (cfg.ssm is not None or ShardPlan.make(cfg, tp).kv_sharded))


UNPADDED = [(n, tp) for n, c in CASES.items() for tp in c[3] if _cuttable(c, tp)]


def _quant(mode):
    return dict(weight_quant=mode, wq_group_size=GS) if mode != "none" else {}


JAX_COMM = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.configs import ParallelConfig, SamplingConfig, get_config
from repro.core import collectives as cc, embedding as emb
from repro.models import model as M, ssm
from repro.runtime.sampling import sample_tokens

B = %d
out = {}
for name, arch, over, quant, tps, sharded in json.loads(sys.argv[1]):
    emb.REPLICATE_BYTES_LIMIT = 0 if sharded else 512 * 2**20
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    frame = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    f = cfg.frontend
    for tp in tps:
        ctx = M.ModelCtx.make(cfg, ParallelConfig(tp=tp, dp=1, remat=False, **quant))
        mesh = compat.make_mesh((1, tp), ("data", "model"))
        tok_spec = P("data", *(None,) * (1 + len(frame)))

        def pre(params, tokens, *feats):
            return M.forward(params, tokens, ctx, caches=M.init_caches(ctx, B, 32),
                             seq_sharded=True, features=feats[0] if feats else None)[0]

        def dec(params, tokens):
            caches = M.init_caches(ctx, B, 32)
            lg = M.forward(params, tokens, ctx, caches=caches, cur_pos=jnp.int32(16))[0]
            return sample_tokens(lg[:, -1], jax.random.key(0),
                                 SamplingConfig(greedy=True, top_k=1), ctx.plan, ctx.dist)

        feat = [] if f is None else [jax.ShapeDtypeStruct((B, f.prefix_len, f.feature_dim),
                                                          jnp.float32)]
        feat_spec = () if f is None else (P("data", None, None),)
        logit_spec = P("data", None, *(None,) * len(frame), "model")
        for phase, fn, s, specs, extra, spec in (
                ("prefill16", pre, 16, feat_spec, feat, logit_spec),
                ("decode", dec, 1, (), [], P())):
            with cc.comm_stats() as st:
                jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=(M.param_specs(ctx), tok_spec,
                                                                 *specs),
                                         out_specs=spec, check_vma=False)).lower(
                    M.param_shapes(ctx), jax.ShapeDtypeStruct((B, s, *frame), jnp.int32),
                    *extra)
            out[f"{name} tp{tp} {phase}"] = [(r.kind, r.tag, r.bytes) for r in st.records]
        if cfg.ssm is not None:
            # each rank's conv weight as _conv_weight_local slices a seeded leaf
            d_in = cfg.ssm.expand * cfg.d_model
            w = np.random.default_rng(0).standard_normal(
                (cfg.ssm.conv_width, d_in + 2 * cfg.ssm.state_dim)).astype(np.float32)
            local = jax.jit(compat.shard_map(
                lambda w: ssm._conv_weight_local({"conv_w": w}, cfg, ctx.dist)[None],
                mesh=mesh, in_specs=(P(),), out_specs=P("model"), check_vma=False))(w)
            out[f"{name} tp{tp} conv"] = np.asarray(local).tolist()
print(json.dumps(out))
""" % B


@pytest.fixture(scope="module")
def jax_comm_proc():
    """The JAX package's records per (case, tp, phase) and its conv slices,
    traced in a subprocess with 4 virtual devices (started at once, read
    when needed)."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    specs = [(n, a, o, _quant(q), t, sh) for n, (a, o, q, t, sh) in CASES.items()]
    proc = subprocess.Popen([sys.executable, "-c", JAX_COMM, json.dumps(specs)],
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


def _features(cfg, seed):
    """Seeded non-zero stub features (B, prefix, feature_dim), or None."""
    f = cfg.frontend
    if f is None:
        return None
    return np.random.default_rng(seed).standard_normal((B, f.prefix_len, f.feature_dim)).astype(
        np.float32)


def _jax_logits(jeng, tokens, feats):
    """The JAX package's logits (prefix + tokens) without a cache."""
    ctx = jeng.ctx
    tok = P("data", *(None,) * (tokens.ndim - 1))
    sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False,
                 out_specs=P("data", *(None,) * tokens.ndim))
    if feats is None:
        fwd = sm(lambda p, t: JM.forward(p, t, ctx)[0], in_specs=(JM.param_specs(ctx), tok))
        return np.asarray(jax.jit(fwd)(jeng.params, jnp.asarray(tokens)))
    fwd = sm(lambda p, t, f: JM.forward(p, t, ctx, features=f)[0],
             in_specs=(JM.param_specs(ctx), tok, P("data", None, None)))
    return np.asarray(jax.jit(fwd)(jeng.params, jnp.asarray(tokens), jnp.asarray(feats)))


def _jax_state(jeng, tokens):
    """The JAX package's SSD state (h, conv) after a 16-token prefill and a
    decode step at 16, through its cached forward."""
    ctx = jeng.ctx
    cspec = jkvcache.cache_pspecs(ctx, kv_seq_shard=False)
    sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)
    pre = jax.jit(sm(lambda p, t, c: JM.forward(p, t, ctx, caches=c, seq_sharded=True)[1],
                     in_specs=(JM.param_specs(ctx), P("data", None), cspec), out_specs=cspec))
    dec = jax.jit(sm(lambda p, t, c: JM.forward(p, t, ctx, caches=c, cur_pos=jnp.int32(16))[1],
                     in_specs=(JM.param_specs(ctx), P("data", None), cspec), out_specs=cspec))
    t = jnp.asarray(tokens, jnp.int32)
    c = pre(jeng.params, t[:, :16], jeng.init_caches(B))
    c = dec(jeng.params, t[:, 16:17], c)
    sub = c[0]["sub0"]
    return {k: np.asarray(sub[k], np.float32) for k in ("h", "conv")}


@pytest.fixture(scope="module")
def runs(jax_comm_proc):
    """JAX tp=1 reference logits (prefix + 17 positions, no cache) and SSD
    state per case, and each rank group's results (one spawn per tp, both
    at once) -> (refs, states, {tp: rank results})."""
    refs, states, cases = {}, {}, {}
    for name, (arch, over, quant, tps, sharded) in CASES.items():
        jcfg, tcfg = _cfg(jget_config, arch, over), _cfg(get_config, arch, over)
        jeng, tree = jax_engine(jcfg, max_len=MAX_LEN, **_quant(quant))
        if jcfg.ssm is not None:        # the SSD scalars drawn nonzero
            rng = np.random.default_rng(5)
            mixer = tree["groups"][0]["sub0"]["mixer"]
            for leaf, scale in (("dt_bias", 0.5), ("A_log", 0.5), ("D", 1.0)):
                mixer[leaf] = (rng.standard_normal(mixer[leaf].shape) * scale).astype(np.float32)
            jeng.params = jax.tree.map(jnp.asarray, tree)
        frame = (jcfg.n_codebooks,) if jcfg.n_codebooks > 1 else ()
        tokens = np.random.default_rng(len(name)).integers(0, jcfg.vocab_size,
                                                           (B, T, *frame)).astype(np.int32)
        feats = _features(jcfg, len(name) + 1)
        refs[name] = _jax_logits(jeng, tokens, feats)
        if jcfg.ssm is not None:
            states[name] = _jax_state(jeng, tokens)
        cases[name] = {"cfg": tcfg, "tree": _torch_tree(tree), "tokens": tokens.astype(np.int64),
                       "features": feats, "parallel": _quant(quant), "tps": tps,
                       "sharded_table": sharded}
    with ThreadPoolExecutor(2) as pool:
        futures = {tp: pool.submit(mesh.spawn, torch_tp_ranks.run_ssd_modal_cases, tp, cases,
                                   device="cpu") for tp in (2, 4)}
        got = {tp: f.result() for tp, f in futures.items()}
    temb.REPLICATE_BYTES_LIMIT = 512 * 2**20
    return refs, states, got


# -- the plans -------------------------------------------------------------------


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_ssd_plan_equals_jax(tp, reduced):
    """The SSD ``_dims`` (d_inner, heads, a rank's heads) as the JAX
    package's, raising its ValueError (4 heads of 128 at tp 8), and
    check_supported admitting the three archs at tp with int4 weights and
    int8 KV, or naming the arch in that ValueError."""
    jcfg, tcfg = jget_config("mamba2-1.3b"), get_config("mamba2-1.3b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert _outcome(lambda: tssm._dims(tcfg, tp)) == _outcome(lambda: jssm._dims(jcfg, tp))
    wide = lambda c: dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, head_dim=128))
    want = _outcome(lambda: jssm._dims(wide(jcfg), tp))
    assert _outcome(lambda: tssm._dims(wide(tcfg), tp)) == want
    par = ParallelConfig(tp=tp, weight_quant="int4", kv_quant=True)
    if want[0] == "ValueError":
        with pytest.raises(ValueError, match=f"{wide(tcfg).name}: {want[1]}"):
            TM.check_supported(wide(tcfg), par)
    for arch in ARCHS:
        cfg = get_config(arch).reduced() if reduced else get_config(arch)
        TM.check_supported(cfg, par)


# -- the shards --------------------------------------------------------------------


@pytest.mark.parametrize("name,tp", UNPADDED)
def test_shards_equal_jax_param_specs_slice(name, tp, jax_comm):
    """Every leaf of every rank's bridged tree (layers, table, lm_head, the
    frontend's projector) equals the JAX tp=1 tree cut by ``param_specs``
    at tp, bit for bit; the SSD conv weight is the rank's x channels and
    the B/C columns, as ``_conv_weight_local`` slices a seeded leaf; the
    SSD state of ``init_caches`` holds the rank's heads and channels."""
    arch, over, _, _, sharded = CASES[name]
    jcfg, tcfg = _cfg(jget_config, arch, over), _cfg(get_config, arch, over)
    lim = 0 if sharded else 512 * 2**20
    jemb.REPLICATE_BYTES_LIMIT = temb.REPLICATE_BYTES_LIMIT = lim
    try:
        _, tree = jax_engine(jcfg, max_len=MAX_LEN)
        specs = JM.param_specs(JM.ModelCtx.make(jcfg, JParallelConfig(tp=tp, dp=1,
                                                                     remat=False)))
        ttree = _torch_tree(tree)
        plan = TM.ModelCtx.make(tcfg, ParallelConfig(tp=tp), Dist(tp, 0)).plan
        for rank in range(tp):
            cut = jax.tree.map(lambda a, s: _spec_slice(a, s, tp, rank), tree, specs)
            want = bridge._tree_layers(_torch_tree(cut), tcfg)
            got = bridge.params_from_jax(ttree, tcfg, "cpu", Dist(tp, rank))
            for i, layer in enumerate(got["layers"]):
                leaves = TM._flat_leaves(layer)
                assert sorted(leaves) == sorted(want[i]), i
                for leaf, t in leaves.items():
                    if leaf == "mixer.conv_w":     # replicated in the JAX tree
                        continue
                    np.testing.assert_array_equal(_bits(t.contiguous()), _bits(want[i][leaf][0]),
                                                  err_msg=f"layer {i} {leaf} rank {rank}")
            np.testing.assert_array_equal(_bits(got["embed"]["table"]),
                                          _bits(bridge.to_torch(cut["embed"]["table"])))
            if "lm_head" in cut:
                np.testing.assert_array_equal(_bits(got["lm_head"]),
                                              _bits(bridge.to_torch(cut["lm_head"])))
            assert ("lm_head" in got) == ("lm_head" in cut) == (not tcfg.tie_embeddings)
            for leaf, t in got.get("frontend", {}).items():
                np.testing.assert_array_equal(_bits(t), _bits(bridge.to_torch(
                    tree["frontend"][leaf])))
            assert (got["embed"]["table"].shape[1] < tcfg.vocab_size) == (
                sharded or tcfg.tie_embeddings)
        if tcfg.ssm is not None:
            conv = np.asarray(jax_comm[f"{name} tp{tp} conv"], np.float32)
            w = np.random.default_rng(0).standard_normal(conv.shape[1:2] + (
                tcfg.ssm.expand * tcfg.d_model + 2 * tcfg.ssm.state_dim,)).astype(np.float32)
            for rank in range(tp):
                mine = TM.shard_leaf("mixer.conv_w", torch.from_numpy(w), tcfg, plan, rank, "ssd")
                np.testing.assert_array_equal(mine.numpy(), conv[rank], err_msg=f"rank {rank}")
            st = TM.init_caches(tcfg, B, MAX_LEN, device="cpu", tp=tp)
            _, nh, local_h = tssm._dims(tcfg, tp)
            assert st["h"].shape[2] == local_h == nh // tp
            assert st["conv"].shape[-1] == conv.shape[-1]
    finally:
        jemb.REPLICATE_BYTES_LIMIT = temb.REPLICATE_BYTES_LIMIT = 512 * 2**20


def test_rank_swept_is_a_shards_bytes():
    """``decode_weight_bytes(..)["rank_swept"]`` at tp 2 and 4: the bytes of
    rank 0's drawn shard (its layers, final norm and head; the tied table
    as the head, the embed table and the frontend's projector left out
    otherwise); tp=1 keeps the JAX package's keys alone."""
    nbytes = lambda t: (t.q.numel() * t.q.element_size() + t.scale.numel() * 2
                        if isinstance(t, QuantWeight) else t.numel() * t.element_size())
    for arch, mode in (("mamba2-1.3b", "none"), ("internvl2-26b", "int4"),
                       ("musicgen-medium", "none")):
        cfg = get_config(arch).reduced()
        assert "rank_swept" not in TM.decode_weight_bytes(cfg, ParallelConfig(weight_quant=mode))
        for tp in (2, 4):
            par = ParallelConfig(tp=tp, **_quant(mode))
            p = TM.init_params(cfg, par, seed=0, device="cpu", dist=Dist(tp, 0))
            want = sum(nbytes(t) for layer in p["layers"]
                       for t in TM._flat_leaves(layer).values())
            want += nbytes(p["final_norm"])
            want += nbytes(p["embed"]["table"] if cfg.tie_embeddings else p["lm_head"])
            got = TM.decode_weight_bytes(cfg, par)
            assert got["rank_swept"] == want, (arch, tp)
            assert got["swept"] > got["rank_swept"] * (tp - 1)


# -- logits, state and collectives at tp 2 and 4 ------------------------------------


LOGIT_CASES = [(n, tp) for n, c in CASES.items() for tp in c[3]]


@pytest.mark.parametrize("name,tp", LOGIT_CASES)
def test_logits_match_jax_tp1(runs, name, tp):
    """Every rank's logits of the two prefills (prefix + tokens) and the
    decode step within TOL of the JAX package at tp=1, the same on every
    rank."""
    refs, _, got = runs
    ref = refs[name]
    p = ref.shape[1] - T
    phases = {"prefill16": np.s_[:, :p + 16], "prefill13": np.s_[:, :p + 13],
              "decode": np.s_[:, p + 16:p + 17]}
    for rank, res in enumerate(r[name] for r in got[tp]):
        for phase, sl in phases.items():
            assert res[phase].shape == ref[sl].shape, phase
            np.testing.assert_allclose(res[phase], ref[sl], atol=TOL, rtol=TOL,
                                       err_msg=f"{name} tp {tp} rank {rank} {phase}")
            np.testing.assert_array_equal(res[phase], got[tp][0][name][phase])


@pytest.mark.parametrize("name,tp", [(n, tp) for n, tp in LOGIT_CASES
                                     if CASES[n][0] == "mamba2-1.3b"])
def test_ssd_state_is_the_jax_state_sliced(runs, name, tp):
    """After the prefill and a decode step, each rank's ``h`` (2, B, 16 /
    tp, P, N) is its heads of the JAX state, and its conv tail (2, B, 3,
    512 / tp + 64) its x channels and the B/C columns.  Layer 0 reads the
    same embedding on every rank and holds tests/test_torch_ssm.py's
    one-layer tolerances (h 1e-2 + 1e-3 relative; the conv tail, the bf16
    projections, one bf16 ulp, or 1e-5 where a column shard's fp32 sum
    over d, blocked in another order, meets cancellation).  Layer 1 reads a
    residual summed from the ranks' bf16 partials (roundings tp=1 does not
    make), which its recurrence carries through every step: it holds 1 %
    of the largest value of its state (values up to ~20 in h; the measured
    distance is ~0.5 %), where a wrong head or channel is off by the
    state's whole size."""
    _, states, got = runs
    want = states[name]
    cfg = _cfg(get_config, *CASES[name][:2])
    d_in, nh, local_h = tssm._dims(cfg, tp)
    for rank, res in enumerate(r[name] for r in got[tp]):
        start, width, bc = tssm.conv_slice(cfg, tp, rank)
        heads = lambda h: h[:, :, rank * local_h:(rank + 1) * local_h]
        chans = lambda c: np.concatenate([c[..., start:start + width], c[..., d_in:]], axis=-1)
        assert bc == 2 * cfg.ssm.state_dim
        for key, cut, atol, rtol in (("h", heads, 1e-2, 1e-3), ("conv", chans, 1e-5, 2 ** -7)):
            got_k, want_k = res["state"][key], cut(want[key])
            assert got_k.shape == want_k.shape, key
            np.testing.assert_allclose(got_k[0], want_k[0], atol=atol, rtol=rtol,
                                       err_msg=f"{key} layer 0 rank {rank}")
            np.testing.assert_allclose(got_k[1], want_k[1], rtol=0,
                                       atol=1e-2 * np.abs(want[key][1]).max(),
                                       err_msg=f"{key} layer 1 rank {rank}")
        assert np.abs(res["state"]["h"]).max() > 0.1           # the state moved


@pytest.mark.parametrize("name,tp", LOGIT_CASES)
def test_collective_records_equal_jax(runs, jax_comm, name, tp):
    """Every collective of the 16-token prefill (sequence-sharded behind the
    prefix) and of a decode step with its top-k, (kind, tag, bytes), in
    order: a decode step all-reduces once an SSD layer and twice an
    attention layer, gathers the two top-k candidates (over b x 4 rows for
    musicgen) and, where the table is vocab-sharded (tied, or internvl's
    past REPLICATE_BYTES_LIMIT), merges the embedding."""
    _, _, got = runs
    arch, over, _, _, sharded = CASES[name]
    jcfg = _cfg(jget_config, arch, over)
    for phase in ("prefill16", "decode"):
        want = [tuple(r) for r in _expand_groups(jax_comm[f"{name} tp{tp} {phase}"], jcfg)]
        for res in (r[name] for r in got[tp]):
            assert [tuple(r) for r in res[f"{phase}_records"]] == want, phase
    kinds = [r[:2] for r in want]
    per_layer = 1 if jcfg.ssm is not None else 2
    n_ar = per_layer * jcfg.n_layers + (sharded or jcfg.tie_embeddings)
    assert sum(k == "all_reduce" for k, _ in kinds) == n_ar
    assert [t for k, t in kinds if k == "all_gather"] == ["topk_vals", "topk_idx"]
