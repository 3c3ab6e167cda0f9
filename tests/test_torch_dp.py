"""The data axis: the port's dp x tp world against the JAX package.

* ``split_data_shards`` and the sharded ``BlockAllocator`` (one block
  namespace a data shard, migration pins) call for call against the JAX
  package's, over one seeded sequence of calls.
* The wave, continuous (whole prompts, and chunks with spec decode) and
  paged schedulers at dp 2 (reduced yi-9b with 8
  q heads over 2 KV heads of head_dim 128, the JAX weights bridged bit for
  bit), each replica serving its half of the rows or slots and its half of
  the pool, against the JAX schedulers at dp=1: per request the greedy
  tokens, or a first parting at a near-tie certified as
  tests/test_torch_continuous.py certifies one.
* ``kv_seq_shard`` at dp 2 and at dp 2 x tp 2: a 28-token prompt in a
  64-entry cache (32 entries a data rank) and 10 teacher-forced decode
  steps across the two slices, the logits within 2e-2 of the JAX
  package's unsharded path (the tolerance of its own check,
  tests/dist_checks.py ``check_kv_seq_shard``), a greedy wave's streams
  equal to the JAX engine's but at certified near-ties, and one
  ``lse_merge`` all-reduce (and one all-reduce max) per attention layer
  per decode step, of the JAX package's bytes.
* The control plane at dp > 1 (the overlapped loop, the ladder, deadlines,
  a fault plan's ``delay`` clause) admitted, and the refusals that stay
  named beside it; ``kv_seq_shard`` with slots or chunks refused with the
  JAX package's messages.

Every rank case runs in one spawn of four gloo ranks on the CPU
(tests/torch_dp_ranks.py): the dp=2 runs on model rank 0's data group
while model rank 1's runs the dp=2 sequence-sharded case, then the whole
2 x 2 world runs it again.
"""
import dataclasses
from collections import deque
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401
import torch_dp_ranks
from repro import compat
from repro.configs import get_config as jget_config
from repro.launch.mesh import split_data_shards as jsplit
from repro.models import model as JM
from repro.runtime import kvcache as jkvcache
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro.runtime.scheduler import PagedContinuousScheduler as JPagedScheduler
from repro.runtime.scheduler import WaveScheduler as JWaveScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.launch import mesh
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models.common import Dist
from repro_torch.runtime import kvcache
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import ContinuousScheduler
from test_paged import straggler_requests
from test_torch_continuous import assert_streams_match, shared_prompt_requests
from test_torch_model import GQA, jax_engine
from test_torch_spec import spec_requests
from test_torch_tp import _torch_tree
from test_torch_tp_serve import _as_run, _requests, wave_requests

MAX_LEN, DP = 64, 2
SEQ_TOL = 2e-2           # tests/dist_checks.py check_kv_seq_shard
SEQ = dict(b=2, plen=28, steps=10, max_new=12)


def _runs(cfg):
    """name -> (scheduler, its kw, engine ParallelConfig kw, requests), the
    same on both sides (the JAX side at dp=1)."""
    return {
        "wave": ("wave", {"batch_size": 3}, {}, wave_requests(cfg.vocab_size)),
        "continuous": ("continuous", dict(n_slots=4, block_steps=4, prefill_chunk=0), {},
                       straggler_requests(cfg)),
        "paged": ("paged", dict(n_slots=4, block_steps=4, block_size=8, prefill_chunk=8), {},
                  shared_prompt_requests(cfg.vocab_size)),
        "chunked-spec": ("continuous", dict(n_slots=4, block_steps=4, prefill_chunk=8, spec_k=3),
                         {}, spec_requests(cfg.vocab_size)),
    }


def _jax_serve(jeng, kind, kw, reqs):
    cls = {"wave": JWaveScheduler, "continuous": JContinuousScheduler,
           "paged": JPagedScheduler}[kind]
    sched = cls(jeng, **kw)
    for prompt, max_new, eos, arrival in reqs:
        sched.submit(prompt, max_new, eos_id=eos, arrival_step=arrival)
    return {r.rid: r for r in sched.run()}


def _jax_forced_logits(jeng, prompts, forced):
    """The JAX package's unsharded logits: the prompt's last position, then
    each decode step fed ``forced``."""
    ctx = jeng.ctx
    pspecs, cspec = JM.param_specs(ctx), jkvcache.cache_pspecs(ctx, kv_seq_shard=False)
    sm = partial(compat.shard_map, mesh=jeng.mesh, check_vma=False)

    def pre(p, t, c):
        logits, c, _ = JM.forward(p, t, ctx, caches=c, seq_sharded=True, last_only=True)
        return logits[:, -1], c

    def dec(p, t, c, cur):
        logits, c, _ = JM.forward(p, t[:, None], ctx, caches=c, cur_pos=cur)
        return logits[:, -1], c

    jpre = jax.jit(sm(pre, in_specs=(pspecs, P("data", None), cspec),
                      out_specs=(P("data", None), cspec)))
    jdec = jax.jit(sm(dec, in_specs=(pspecs, P("data"), cspec, P()),
                      out_specs=(P("data", None), cspec)))
    lg, c = jpre(jeng.params, jnp.asarray(prompts), jeng.init_caches(len(prompts)))
    out = [np.asarray(lg, np.float32)]
    for i in range(forced.shape[1]):
        lg, c = jdec(jeng.params, jnp.asarray(forced[:, i]), c, jnp.int32(prompts.shape[1] + i))
        out.append(np.asarray(lg, np.float32))
    return out


def _fp32(tree):
    """The tree with its floating leaves in fp32, as tests/dist_checks.py
    holds the sequence-sharded cache to the unsharded one."""
    return jax.tree.map(lambda a: a.astype(np.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


@pytest.fixture(scope="module")
def served():
    jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **GQA)
    tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **GQA)
    jeng, tree = jax_engine(jcfg, MAX_LEN)
    runs = _runs(tcfg)
    # the sequence-sharded case in fp32 weights (bf16 K/V caches), as the
    # JAX package's own check: in bf16 the port's unsharded logits already
    # lie ~0.025 from the reference's, in fp32 ~0.005
    jeng32, _ = jax_engine(jcfg, MAX_LEN)
    tree32 = _fp32(tree)
    jeng32.params = jax.tree.map(jnp.asarray, tree32)
    prompts = np.random.default_rng(7).integers(0, tcfg.vocab_size,
                                                (SEQ["b"], SEQ["plen"])).astype(np.int32)
    jwave = np.asarray(jeng32.generate(prompts, SEQ["max_new"]))
    forced = jwave[:, :SEQ["steps"]].astype(np.int64)
    seq_case = {"prompts": prompts, "forced": forced, "max_len": MAX_LEN,
                "max_new": SEQ["max_new"], "tree": _torch_tree(tree32)}
    got = mesh.spawn(torch_dp_ranks.run_dp_cases, 2, tcfg, _torch_tree(tree), runs, seq_case,
                     device="cpu", dp=DP)
    ref = {name: _jax_serve(jeng, kind, kw, reqs) for name, (kind, kw, _, reqs) in runs.items()}
    teng = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                  params=bridge.params_from_jax(tree, tcfg, device="cpu"), device="cpu")
    teng32 = Engine(tcfg, sampling=SamplingConfig(top_k=1), max_len=MAX_LEN,
                    params=bridge.params_from_jax(tree32, tcfg, device="cpu"), device="cpu")
    seq_ref = {"logits": _jax_forced_logits(jeng32, prompts, forced), "wave": jwave,
               "engine": teng32}
    return runs, got, ref, teng, seq_case, seq_ref


# -- the pool split and the sharded allocator ---------------------------------


@pytest.mark.parametrize("n, pf", [(2, 1), (4, 1), (4, 2), (4, 3), (8, 5),
                                   (4, 0), (4, 4), (4, 5), (1, 1)])
def test_split_data_shards_matches_jax(n, pf):
    try:
        want = jsplit(n, pf)
    except ValueError as e:
        with pytest.raises(ValueError, match="prefill_shards") as got:
            mesh.split_data_shards(n, pf)
        assert str(got.value) == str(e)
        return
    assert mesh.split_data_shards(n, pf) == want


def _alloc_script(n_shards, seed, steps=400):
    """One seeded sequence of allocator uses, as the schedulers make them:
    (op, shard, n, prompt index, u)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 50, 24)
    # prompts that share leading blocks (a system prompt) and ones that do not
    prompts = [np.concatenate([base[:int(rng.integers(0, 25))],
                               rng.integers(0, 50, int(rng.integers(2, 16)))])
               for _ in range(8)]
    out = []
    for _ in range(steps):
        op = rng.choice(["admit", "grow", "finish", "match", "begin", "end"],
                        p=[0.3, 0.15, 0.25, 0.1, 0.12, 0.08])
        out.append((str(op), int(rng.integers(0, n_shards)), int(rng.integers(1, 4)),
                    int(rng.integers(0, len(prompts))), float(rng.random())))
    return prompts, out


@pytest.mark.parametrize("n_shards, n_blocks", [(1, 12), (2, 24), (4, 40)])
def test_sharded_allocator_matches_jax(n_shards, n_blocks):
    """Requests admitted behind their matched prefix blocks (increfed) and
    fresh ones, their full blocks registered, grown, pinned for migration
    and unpinned, and finished: every call's result, every shard's free
    and used counts, each live block's refcount, the migration pins and
    ``audit`` after each step, the JAX package's."""
    bs = 4
    j = jkvcache.BlockAllocator(n_blocks, bs, n_shards=n_shards)
    t = kvcache.BlockAllocator(n_blocks, bs, n_shards)
    assert (t.n_shards, t.blocks_per_shard) == (j.n_shards, j.blocks_per_shard)
    prompts, script = _alloc_script(n_shards, seed=n_shards)
    live = []                                   # (shard, blocks) of each request
    pins = deque()                              # (shard, block)
    hits = pinned = 0
    for op, sh, n, pi, u in script:
        if op == "admit":
            prompt = prompts[pi]
            shared, cached = j.match_prefix(sh, prompt)
            assert t.match_prefix(prompt, sh) == (shared, cached)
            need = -(-len(prompt) // bs) - len(shared)
            fresh = j.alloc(sh, need)
            assert t.alloc(need, sh) == fresh
            if fresh is None:
                continue
            j.incref(sh, shared)
            t.incref(shared, sh)
            hits += len(shared)
            blocks = shared + fresh
            j.register_prefix(sh, prompt, blocks[:len(prompt) // bs])
            t.register_prefix(prompt, blocks[:len(prompt) // bs], sh)
            live.append((sh, blocks))
        elif op == "grow" and live:
            rs, blocks = live[int(u * len(live))]
            got = j.alloc(rs, n)
            assert t.alloc(n, rs) == got
            blocks += got or []
        elif op == "finish" and live:
            rs, blocks = live.pop(int(u * len(live)))
            j.free(rs, blocks)
            t.free(blocks, rs)
        elif op == "match":
            assert j.match_prefix(sh, prompts[pi]) == t.match_prefix(prompts[pi], sh)
        elif op == "begin" and live:
            rs, blocks = live[int(u * len(live))]
            b = blocks[int(u * len(blocks))]
            j.begin_migration(rs, [b])
            t.begin_migration([b], rs)
            pins.append((rs, b))
            pinned += 1
        elif op == "end" and pins:
            rs, b = pins.popleft()
            j.end_migration(rs, [b])
            t.end_migration([b], rs)
        for s in range(n_shards):
            assert (j.free_count(s), j.used_count(s)) == (t.free_count(s), t.used_count(s))
        for rs, blocks in live:
            for b in blocks:
                assert j.refcount(rs, b) == t.refcount(b, rs)
        assert (j.total_used(), j.migrating_count()) == (t.total_used(), t.migrating_count())
        j.audit()
        t.audit()
    assert hits > 0 and pinned > 0
    for rs, blocks in live:
        j.free(rs, blocks)
        t.free(blocks, rs)
    if pins:
        with pytest.raises(AssertionError, match="never drained"):
            t.audit(expect_no_migration=True)
    while pins:
        rs, b = pins.popleft()
        j.end_migration(rs, [b])
        t.end_migration([b], rs)
    j.audit(expect_no_migration=True)
    t.audit(expect_no_migration=True)
    assert t.total_used() == 0


def test_pool_block_bytes_matches_jax():
    """The migration unit: one block's bytes over every pool leaf, an int8
    cache's scales included (the JAX package's ``pool_block_bytes`` at
    tp=1)."""
    from repro.models import transformer as jtfm

    for kv_quant in (False, True):
        jcfg = dataclasses.replace(jget_config("yi-9b").reduced(), **GQA)
        tcfg = dataclasses.replace(get_config("yi-9b").reduced(), **GQA)
        jeng, _ = jax_engine(jcfg, MAX_LEN, kv_quant=kv_quant)
        jc = jeng.init_paged_caches(2, 10, 8)
        tc = TM.init_caches(tcfg, 2, MAX_LEN, device="cpu", paged=(10, 8), kv_quant=kv_quant)
        assert kvcache.pool_block_bytes(tc) == jkvcache.pool_block_bytes(
            jc, jtfm.build_groups(jcfg))


# -- the schedulers at dp 2 ------------------------------------------------------


@pytest.mark.parametrize("name", ["wave", "continuous", "paged", "chunked-spec"])
def test_dp2_streams_match_jax(served, name):
    runs, got, ref, teng, *_ = served
    kind, kw, _, reqs = runs[name]
    ranks = [r["runs"][name] for r in got if "runs" in r]
    assert len(ranks) == DP
    port = _requests(ranks[0][0])
    # spec decode on random weights meets several near-ties (a replica
    # verifies 2 slots where the reference verifies 4): each is certified
    assert_streams_match(teng, _as_run(reqs, kind, kw), port, ref[name],
                         max_flips=2 if kw.get("spec_k") else 1)
    assert sum(np.array_equal(port[rid].output, ref[name][rid].output) for rid in ref[name]) >= 1
    for r in ranks[1:]:              # every replica lands the world's tokens
        assert {k: v[0].tolist() for k, v in r[0].items()} == \
            {k: v[0].tolist() for k, v in ranks[0][0].items()}


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_dp2_gathers_tokens_once_a_call(served, name):
    """Each slot engine call gathers its outputs over the data group once
    (tag ``dp_tokens``): admissions, mixed steps and decode blocks, never
    one gather a token; the run ends with one stream check."""
    runs, got, *_ = served
    _, stats, comm = next(r for r in got if "runs" in r)["runs"][name]
    n = comm["dp_tokens (all_gather)"]["count"]
    assert 0 < n <= stats["prefill_calls"] + stats["decode_steps"]
    if name == "continuous":       # decode blocks of up to 4 steps: fewer gathers than steps
        assert n < stats["prefill_calls"] + stats["decode_steps"]
    assert comm["stream_check (all_gather)"]["count"] == 1


# -- kv_seq_shard ----------------------------------------------------------------


SEQ_WORLDS = ["seq dp2", "seq dp2 tp2"]


def _seq_ranks(got, world):
    return [r[world] for r in got if world in r]


@pytest.mark.parametrize("world", SEQ_WORLDS)
def test_kv_seq_shard_logits_match_jax_unsharded(served, world):
    *_, seq_case, seq_ref = served
    ranks = _seq_ranks(served[1], world)
    assert len(ranks) == (DP if world == "seq dp2" else 2 * DP)
    for r in ranks:
        assert r["cache_len"] == -(-MAX_LEN // DP)
        assert len(r["logits"]) == len(seq_ref["logits"])
        for step, (a, b) in enumerate(zip(r["logits"], seq_ref["logits"])):
            np.testing.assert_allclose(a, b, atol=SEQ_TOL, rtol=SEQ_TOL,
                                       err_msg=f"{world} step {step}")
    # each data rank holds its own slice: positions [d * 32, d * 32 + 32)
    S = ranks[0]["cache_len"]
    end = SEQ["plen"] + SEQ["steps"]
    for d in range(DP):
        pos = next(r["pos"] for i, r in enumerate(ranks) if i // (len(ranks) // DP) == d)
        want = np.arange(d * S, d * S + S)
        np.testing.assert_array_equal(pos, np.where(want < end, want, -1))


@pytest.mark.parametrize("world", SEQ_WORLDS)
def test_kv_seq_shard_streams_match_jax(served, world):
    *_, seq_case, seq_ref = served
    reqs = [(p, SEQ["max_new"], None, 0) for p in seq_case["prompts"]]
    ranks = _seq_ranks(served[1], world)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["wave"], ranks[0]["wave"])
    port = {i: type("R", (), {"output": ranks[0]["wave"][i], "finish_reason": "length"})
            for i in range(len(reqs))}
    ref = {i: type("R", (), {"output": seq_ref["wave"][i], "finish_reason": "length"})
           for i in range(len(reqs))}
    assert_streams_match(seq_ref["engine"], reqs, port, ref)


@pytest.mark.parametrize("world", SEQ_WORLDS)
def test_kv_seq_shard_merges_once_a_layer_a_step(served, world):
    """One all-reduce max and one all-reduce sum tagged ``lse_merge`` over
    the data axis per attention layer per decode step; the sum carries l
    and acc (b, local q heads, hd + 1) fp32, the bytes of the JAX
    package's two psum records; nothing else crosses the data axis."""
    tcfg = served[3].cfg
    ranks = _seq_ranks(served[1], world)
    tp = 1 if world == "seq dp2" else 2
    hd = tcfg.resolved_head_dim
    local_q = tcfg.n_heads // tp
    for r in ranks:
        for step in r["records"]:
            data = [x for x in step if x[1] == "data"]
            assert sorted(x[0] for x in data) == (["all_reduce"] * tcfg.n_layers
                                                   + ["all_reduce_max"] * tcfg.n_layers)
            assert all(x[2] == "lse_merge" for x in data)
            sums = [x[3] for x in data if x[0] == "all_reduce"]
            assert sums == [2 * SEQ["b"] * local_q * (hd + 1) * 4] * tcfg.n_layers
            model = [x for x in step if x[1] == "model"]
            assert len(model) == (0 if tp == 1 else 2 * tcfg.n_layers)


def test_kv_seq_shard_cache_len_matches_jax():
    from repro.models.attention import cache_len_for as jcache_len

    for name in ("yi-9b", "recurrentgemma-9b"):
        jcfg, tcfg = jget_config(name), get_config(name)
        for kind in ("attn", "local_attn"):
            for seq, dp, slack in ((64, 2, 0), (16384, 2, 0), (100, 3, 4), (4096, 4, 2)):
                assert (tattn.cache_len_for(tcfg, kind, seq, slack, dp)
                        == jcache_len(jcfg, kind, seq, dp, slack))


# -- refusals --------------------------------------------------------------------


@pytest.mark.parametrize("field, value, name", [
    ("overlap_decode", True, "overlap_decode at dp>1"),
    ("overload_degrade", True, "overload_degrade at dp>1"),
    ("fault_plan", "step:at=2;delay:at=4,s=0.01", "delay clause at dp>1"),
])
def test_dp_refuses_what_reads_the_wall_clock(field, value, name):
    """What reads the wall clock is no longer refused at dp>1: world rank 0
    reads it for every rank (its round records; a delay clause sleeps on
    rank 0 only).  The refusals that stay are named beside it."""
    cfg = get_config("yi-9b").reduced()
    for dp, tp in ((2, 1), (2, 2), (4, 2)):
        par = dataclasses.replace(ParallelConfig(dp=dp, tp=tp), **{field: value})
        TM.check_supported(cfg, par)
    Engine(cfg, parallel=dataclasses.replace(ParallelConfig(dp=2), **{field: value}),
           device="cpu", dist=Dist(dp=2))
    for par, kw, stays in (
            (ParallelConfig(dp=2, tp=2, weight_quant="int8", **{field: value}),
             {"wq_cache": "x.npz"}, "wq_cache at tp>1"),
            (ParallelConfig(dp=2, **{field: value}, kv_seq_shard=True), {},
             "kv_seq_shard with mla")):
        with pytest.raises(NotImplementedError, match=stays) as err:
            TM.check_supported(get_config("minicpm3-4b"), par, **kw)
        assert name not in str(err.value)


def test_dp_refuses_deadlines_by_name():
    """``deadline_s`` is taken at dp>1 (rank 0's clock decides, through the
    round record); the slot split's own refusal stays."""
    eng = Engine(get_config("yi-9b").reduced(), parallel=ParallelConfig(dp=2), device="cpu",
                 dist=Dist(dp=2), sampling=SamplingConfig(top_k=1), max_len=32)
    sched = ContinuousScheduler(eng, n_slots=2)
    rid = sched.submit(np.arange(4, dtype=np.int32), 4, deadline_s=1.0)
    assert sched.queue[-1].rid == rid and sched.queue[-1].deadline_s == 1.0
    assert sched._has_deadlines
    with pytest.raises(ValueError, match="n_slots 3 must divide dp 2"):
        eng.init_slot_caches(3)


def test_kv_seq_shard_refusals_match_jax():
    """The slot engine, per-slot decode positions and chunks refuse
    ``kv_seq_shard`` with the JAX package's messages; so do the layers the
    sequence-sharded cache does not cover."""
    from repro.configs import ParallelConfig as JParallelConfig
    from repro.configs import SamplingConfig as JSamplingConfig
    from repro.launch.mesh import make_local_mesh
    from repro.runtime.engine import Engine as JEngine

    cfg = get_config("yi-9b").reduced()
    jeng = JEngine(cfg=jget_config("yi-9b").reduced(),
                   parallel=JParallelConfig(tp=1, dp=1, remat=False, kv_seq_shard=True),
                   sampling=JSamplingConfig(greedy=True, top_k=1),
                   mesh=make_local_mesh(1, 1), max_len=32)
    with pytest.raises(ValueError) as jerr:
        jeng._cb()
    eng = Engine(cfg, parallel=ParallelConfig(kv_seq_shard=True), device="cpu", max_len=32)
    with pytest.raises(ValueError) as terr:
        eng.init_slot_caches(2)
    assert str(terr.value) == str(jerr.value) == "slot engine is incompatible with kv_seq_shard"
    with pytest.raises(ValueError, match="slot engine"):
        eng.init_paged_caches(2, 9, 8)
    caches = eng.init_caches(2)
    tok = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(ValueError, match=r"^chunked prefill is incompatible with kv_seq_shard "
                                         r"\(batch=1 long-context path\)$"):
        eng.forward(tok, caches=caches, start_pos=torch.zeros(2, dtype=torch.long))
    with pytest.raises(ValueError, match=r"^per-slot decode positions are incompatible with "
                                         r"kv_seq_shard \(batch=1 long-context path\)$"):
        eng.forward(tok[:, :1], caches=caches, cur_pos=torch.zeros(2, dtype=torch.long))
    for arch in ("minicpm3-4b", "recurrentgemma-9b", "mamba2-1.3b"):
        with pytest.raises(NotImplementedError, match="kv_seq_shard with mla"):
            TM.check_supported(get_config(arch), ParallelConfig(kv_seq_shard=True))
