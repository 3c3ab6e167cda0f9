"""Disaggregated prefill/decode serving: the port's ``DisaggScheduler``
against the JAX package (tests/test_disagg.py and the disagg cases of
tests/test_faults.py, on the port).

Reduced yi-9b with the JAX package's weights bridged bit for bit (its
gammas seeded nonzero, tests/test_torch_model.py ``jax_engine``), served
at 1p1d (dp 2, one prefill shard) and 2p2d (dp 4, two), chunks of 8 tokens
into 8-token blocks, over gloo ranks on the CPU (tests/torch_dp_ranks.py,
one spawn of four ranks: the dp=2 cases run on its two halves at once,
then the dp=4 ones on the whole world):

* streams: in bf16, over the int8 KV cache, in int8 weights and in the
  certification mix (int8 KV and weights behind a shared system prompt),
  each stream bit for bit the port's own unified ``PagedContinuousScheduler``
  at the same chunk width (dp=1), and the JAX package's unified paged
  scheduler's but at a certified near-tie (tests/test_torch_continuous.py);
* the migration counters (``migrated_blocks``, ``migration_skipped_blocks``,
  ``handoffs``, ``migration_deferrals``, ``prefill_steps``) equal to the JAX
  ``DisaggScheduler``'s at dp 2 and 4, run once in a subprocess with four
  virtual devices (as tests/test_torch_tp.py runs the JAX package);
  ``migration_bytes`` is ``migrated_blocks`` x ``pool_block_bytes``, and so
  are the bytes the ranks sent (tag ``migrate``);
* refcounts and migration pins conserved (the allocator audited after every
  quarantine and preemption and at the end), a preemption during migration
  rolled back, the migrate fault's rollback at 1p1d and 2p2d quarantining
  the JAX package's request, and the livelock breaker's abort freeing a
  landing request's blocks;
* the gating errors, and ``serve.py --scheduler disagg --dp 2`` on the CPU.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_dp_ranks
from repro.configs import get_config as jget_config
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.launch import mesh, serve
from repro_torch.models.common import Dist
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (DisaggScheduler, PagedContinuousScheduler,
                                           Request)
from test_disagg import disagg_requests
from test_faults import _disagg_requests
from test_torch_continuous import assert_streams_match
from test_torch_model import jax_engine
from test_torch_tp import _torch_tree
from test_torch_tp_serve import _requests

MAX_LEN = 64
STATS = ("migrated_blocks", "migration_skipped_blocks", "handoffs", "migration_deferrals",
         "prefill_steps")
SLOT = dict(block_steps=2, block_size=8, prefill_chunk=8)
INT8_KV, INT8_W = {"kv_quant": True}, {"weight_quant": "int8"}


def _cases(cfg):
    """name -> the run: engine ParallelConfig kw, weights, dp, which half of
    the four ranks runs a dp=2 case, scheduler kw and requests (the JAX
    tests' workloads)."""
    def case(parallel, tree, dp, half, reqs, **kw):
        sched = dict(SLOT, n_slots=2 * dp, prefill_shards=dp // 2, **kw)
        return {"parallel": parallel, "tree": tree, "dp": dp, "half": half, "sched": sched,
                "reqs": reqs}

    faulty = _disagg_requests(cfg)
    return {
        "bf16 1p1d": case({}, "bf16", 2, 0, disagg_requests(cfg)),
        "int8-kv 1p1d": case(INT8_KV, "bf16", 2, 1, disagg_requests(cfg, seed=2)),
        "int8-w 1p1d": case(INT8_W, "int8", 2, 0, disagg_requests(cfg, seed=3)),
        "cert-mix 1p1d": case({**INT8_KV, **INT8_W}, "int8", 2, 1,
                              disagg_requests(cfg, n=6, seed=4, shared_prefix=24)),
        "refcounts 1p1d": case({}, "bf16", 2, 0, disagg_requests(cfg, n=8, seed=6),
                               n_blocks=20),
        "fault-clean 1p1d": case({}, "bf16", 2, 1, faulty, prefix_cache=False),
        "fault 1p1d": case({}, "bf16", 2, 0, faulty, prefix_cache=False,
                           fault_plan="migrate:handoff=0"),
        "bf16 2p2d": case({}, "bf16", 4, None, disagg_requests(cfg, n=8, seed=5)),
        "fault-clean 2p2d": case({}, "bf16", 4, None, faulty, prefix_cache=False),
        "fault 2p2d": case({}, "bf16", 4, None, faulty, prefix_cache=False,
                           fault_plan="migrate:handoff=0"),
    }


JAX_DISAGG = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ParallelConfig, SamplingConfig, get_config
from repro.launch.mesh import make_local_mesh
from repro.runtime.engine import Engine
from repro.runtime.scheduler import DisaggScheduler, PagedContinuousScheduler
from test_torch_model import jax_engine

STATS = %r
out = {}
cfg = get_config("yi-9b").reduced()
for name, c in json.loads(sys.argv[1]).items():
    e1, _ = jax_engine(cfg, %d, **c["parallel"])
    reqs = [(np.asarray(p, np.int32), mn, eos, arr) for p, mn, eos, arr in c["reqs"]]
    kw = dict(c["sched"])
    pf, plan = kw.pop("prefill_shards"), kw.pop("fault_plan", None)

    def run(sched):
        for p, mn, eos, arr in reqs:
            sched.submit(p, mn, eos_id=eos, arrival_step=arr)
        return {r.rid: r for r in sched.run()}

    uni = run(PagedContinuousScheduler(e1, **kw))
    en = Engine(cfg=cfg, parallel=ParallelConfig(tp=1, dp=c["dp"], remat=False, **c["parallel"]),
                sampling=SamplingConfig(greedy=True, top_k=1), mesh=make_local_mesh(c["dp"], 1),
                max_len=%d)
    en.params = e1.params
    dis = DisaggScheduler(en, prefill_shards=pf, fault_plan=plan, **kw)
    done = run(dis)
    out[name] = {"unified": {rid: r.output.tolist() for rid, r in uni.items()},
                 "unified_reasons": {rid: r.finish_reason for rid, r in uni.items()},
                 "disagg": {rid: r.output.tolist() for rid, r in done.items()},
                 "stats": {k: dis.stats[k] for k in STATS + ("migration_faults", "quarantined")},
                 "errors": sorted(rid for rid, r in done.items() if r.finish_reason == "error")}
print(json.dumps(out))
""" % (STATS, MAX_LEN, MAX_LEN)


@pytest.fixture(scope="module")
def cases():
    return _cases(get_config("yi-9b").reduced())


@pytest.fixture(scope="module")
def jax_proc(cases):
    """The JAX package's unified paged runs (dp=1) and its DisaggScheduler
    at dp 2 and 4, in one subprocess with four virtual devices, started at
    once and read when needed."""
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=f"{tests.parent / 'src'}{os.pathsep}{tests}", JAX_PLATFORMS="cpu")
    spec = {name: dict(c, reqs=[(p.tolist(), mn, eos, arr) for p, mn, eos, arr in c["reqs"]])
            for name, c in cases.items()}
    proc = subprocess.Popen([sys.executable, "-c", JAX_DISAGG, json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def served(cases, jax_proc):
    cfg = get_config("yi-9b").reduced()
    jcfg = jget_config("yi-9b").reduced()
    jengs = {"bf16": jax_engine(jcfg, MAX_LEN), "int8": jax_engine(jcfg, MAX_LEN,
                                                                    weight_quant="int8")}
    trees = {k: tree for k, (_, tree) in jengs.items()}
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 24).astype(np.int32)
    got = mesh.spawn(torch_dp_ranks.run_disagg_cases, 1, cfg,
                     {k: _torch_tree(t) for k, t in trees.items()}, cases, prompt,
                     device="cpu", dp=4)
    out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = json.loads(out)
    engines = {}

    def port_engine(c):
        """A dp=1 port engine of the case's weights and cache."""
        key = (c["tree"], tuple(sorted(c["parallel"].items())))
        if key not in engines:
            par = ParallelConfig(**c["parallel"])
            engines[key] = Engine(cfg, parallel=par, sampling=SamplingConfig(top_k=1),
                                  max_len=MAX_LEN, device="cpu",
                                  params=bridge.params_from_jax(trees[c["tree"]], cfg, "cpu"))
        return engines[key]

    return got, ref, port_engine, {k: e for k, (e, _) in jengs.items()}


def _rank_runs(got, name):
    return [r[name] for r in got if name in r]


def _as_requests(streams, reasons):
    return {int(rid): type("R", (), {"output": np.asarray(t, np.int32),
                                     "finish_reason": reasons[rid]})
            for rid, t in streams.items()}


STREAM_CASES = ["bf16 1p1d", "int8-kv 1p1d", "int8-w 1p1d", "cert-mix 1p1d", "bf16 2p2d"]


@pytest.mark.parametrize("name", STREAM_CASES)
def test_disagg_streams_equal_unified_paged(served, cases, name):
    """Every rank lands the same streams: the port's own unified paged
    engine's bit for bit, and the JAX package's unified engine's but at
    certified near-ties."""
    got, ref, port_engine, jengs = served
    c = cases[name]
    runs = _rank_runs(got, name)
    assert len(runs) == c["dp"]
    streams = runs[0][0]
    for r in runs[1:]:
        assert {k: v[0].tolist() for k, v in r[0].items()} == \
            {k: v[0].tolist() for k, v in streams.items()}
    eng = port_engine(c)
    kw = {k: v for k, v in c["sched"].items() if k != "prefill_shards"}
    uni = PagedContinuousScheduler(eng, **kw)
    for p, mn, eos, arr in c["reqs"]:
        uni.submit(p, mn, eos_id=eos, arrival_step=arr)
    unified = {r.rid: r for r in uni.run()}
    port = _requests(streams)
    for rid, r in unified.items():
        np.testing.assert_array_equal(port[rid].output, r.output, err_msg=f"{name} {rid}")
        assert port[rid].finish_reason == r.finish_reason
    jeng = jengs[c["tree"]]
    certify = (lambda prompt, toks, tok: _within_tol(eng, jeng, prompt, toks, tok)) \
        if c["parallel"].get("weight_quant") else None
    assert_streams_match(eng, c["reqs"], port, _as_requests(ref[name]["unified"],
                                                               ref[name]["unified_reasons"]),
                         max_flips=2, jeng=jeng, certify=certify)


def _within_tol(teng, jeng, prompt, toks, tok) -> bool:
    """The int8-weight certificate (chip_smoke.py's for the int8 paths):
    after the reference's ``toks`` the port's logits lie within TOL of the
    reference's, and both the reference's next token and the port's
    ``tok`` lie within TOL of the reference's top; int8 weights put the two
    implementations ~0.03 apart, past a 1e-2 top-2 gap."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.models import model as JM
    from repro_torch.models import model as TM
    from test_torch_model import TOL

    seq = np.concatenate([prompt, np.asarray(toks, np.int64)])
    with torch.inference_mode():
        tl = TM.forward(teng.params, torch.from_numpy(seq).long()[None], teng.cfg,
                        last_only=True)[0, -1].numpy()
    jl = np.asarray(jax.jit(lambda p, t: JM.forward(p, t, jeng.ctx)[0])(
        jeng.params, jnp.asarray(seq.astype(np.int32))[None]))[0, -1]
    picks = [int(np.argmax(jl))] + ([] if tok is None else [int(tok)])
    return bool(np.abs(tl - jl).max() <= TOL and all(jl.max() - jl[t] < TOL for t in picks))


# int8 weights: request 0's stream parts from the reference's at a
# certified near-tie (the port's top-2 gap 0.0105) that moves its EOS, so
# the two schedules differ from there and the counters are not comparable
@pytest.mark.parametrize("name", ["bf16 1p1d", "int8-kv 1p1d", "cert-mix 1p1d", "bf16 2p2d",
                                  "refcounts 1p1d"])
def test_disagg_migration_counters_equal_jax(served, cases, name):
    got, ref, *_ = served
    streams, stats, comm, state = _rank_runs(got, name)[0]
    # the streams may part from the reference's at certified near-ties
    # (test_disagg_streams_equal_unified_paged), which move no scheduling
    # decision: every request keeps its length, so the schedules are the same
    assert {int(k): len(v) for k, v in ref[name]["disagg"].items()} == \
        {k: len(v[0]) for k, v in streams.items()}
    assert {k: stats[k] for k in STATS} == {k: ref[name]["stats"][k] for k in STATS}
    assert stats["handoffs"] > 0 and stats["migrated_blocks"] > 0
    assert stats["migration_bytes"] == stats["migrated_blocks"] * state["block_bytes"] > 0
    # what crossed between the ranks: one send a (source, destination)
    # pair and migrate call, the migrated blocks' bytes in all
    sent = sum(r[2].get("migrate (send)", {"bytes": 0})["bytes"] for r in _rank_runs(got, name))
    assert sent == stats["migration_bytes"]
    pools = state["summary_pools"]
    assert pools["prefill_shards"] == cases[name]["sched"]["prefill_shards"]
    assert pools["decode_shards"] == cases[name]["dp"] - pools["prefill_shards"]
    assert pools["migration_wait_s"]["p95"] >= pools["migration_wait_s"]["p50"]
    assert 0 < pools["prefill_occupancy"] <= 1 and "decode_itl_s" in pools


def test_disagg_cert_mix_skips_resident_prefix_blocks(served):
    """Behind a shared system prompt, later requests' shared blocks already
    live in the decode pool: migration references them instead of copying."""
    stats = _rank_runs(served[0], "cert-mix 1p1d")[0][1]
    assert stats["migration_skipped_blocks"] > 0 and stats["migrated_blocks"] > 0


@pytest.mark.parametrize("name", ["refcounts 1p1d", "bf16 2p2d", "cert-mix 1p1d",
                                  "fault 1p1d", "fault 2p2d"])
def test_disagg_refcounts_and_pins_conserved(served, cases, name):
    """Every block allocated across admission, eager migration, handoff,
    decode growth and landing comes back, on every shard, with no pin
    left; the allocator held its invariants after every quarantine and
    preemption on every rank."""
    for streams, stats, comm, state in _rank_runs(served[0], name):
        assert state["audits"] == []
        assert state["total_used"] == 0 and state["migrating"] == 0
        assert state["free"] == [state["per_shard"] - 1] * cases[name]["dp"]
        assert len(streams) == len(cases[name]["reqs"])


def test_disagg_preempt_during_migration_requeues_cleanly(served):
    out = _rank_runs(served[0], "preempt")
    assert len(out) == 2 and out[0] == out[1]
    out = out[0]
    assert out["queued"] > 0 and out["pinned"] > 0 and out["preempted"]
    assert (out["after_queue"], out["after_mig"], out["after_pinned"], out["after_used"]) == \
        (0, 0, 0, 0)
    assert out["requeued"]
    assert out["done"] == [(0, 6)] and out["preemptions"] == 1
    assert out["end_used"] == out["end_pinned"] == 0


@pytest.mark.parametrize("shape", ["1p1d", "2p2d"])
def test_disagg_migration_fault_rolls_back(served, shape):
    """``migrate:handoff=0``: the first handoff fails mid-staging and rolls
    back whole; exactly its request is quarantined (the JAX package's),
    the survivors' streams equal the clean run's, and every shard's pool
    comes back."""
    got, ref, *_ = served
    clean = _rank_runs(got, f"fault-clean {shape}")[0][0]
    for streams, stats, comm, state in _rank_runs(got, f"fault {shape}"):
        bad = [rid for rid, (_, why) in streams.items() if why == "error"]
        assert bad == ref[f"fault {shape}"]["errors"] and len(bad) == 1
        assert "migration" in state["errors"][bad[0]]
        assert stats["migration_faults"] == stats["quarantined"] == 1
        for rid, (toks, why) in streams.items():
            if rid not in bad:
                assert why in ("stop", "length")
                np.testing.assert_array_equal(toks, clean[rid][0])
        assert state["total_used"] == 0 and state["audits"] == []


def _dp2_engine(**par):
    return Engine(get_config("yi-9b").reduced(), parallel=ParallelConfig(dp=2, **par),
                  device="cpu", dist=Dist(dp=2), sampling=SamplingConfig(top_k=1),
                  max_len=MAX_LEN)


def test_disagg_livelock_abort_frees_landing_blocks():
    sched = DisaggScheduler(_dp2_engine(), n_slots=4, prefill_shards=1, prefix_cache=False,
                            **SLOT)
    assert not sched._abort_stuck_entity()        # nothing stuck: no victim
    shard = 1
    blocks = sched.alloc.alloc(2, shard)
    req = Request(rid=0, prompt=np.arange(2, 12, dtype=np.int32), max_new=8)
    sched._landing.append({"req": req, "shard": shard, "blocks": blocks, "toks": [7],
                           "ready_t": time.monotonic()})
    assert sched._abort_stuck_entity()
    assert req.finish_reason == "error" and "livelock" in req.stats["error"]
    assert sched.stats["livelock_aborts"] == 1
    assert not sched._landing and sched.alloc.used_count(shard) == 0
    sched.alloc.audit(expect_no_migration=True)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_disagg_rejects_fallback_archs(arch):
    eng = Engine(get_config(arch).reduced(), device="cpu", max_len=MAX_LEN)
    with pytest.raises(ValueError, match="does not support disaggregated"):
        DisaggScheduler(eng, n_slots=2, block_size=8, prefill_shards=1)


def test_disagg_needs_two_shards_and_chunks():
    """The JAX package's messages: one data shard cannot split into two
    pools, and the prefill pool streams chunks."""
    from repro.configs import ParallelConfig as JParallelConfig
    from repro.configs import SamplingConfig as JSamplingConfig
    from repro.launch.mesh import make_local_mesh
    from repro.runtime.engine import Engine as JEngine
    from repro.runtime.scheduler import DisaggScheduler as JDisaggScheduler

    jeng = JEngine(cfg=jget_config("yi-9b").reduced(),
                   parallel=JParallelConfig(tp=1, dp=1, remat=False),
                   sampling=JSamplingConfig(greedy=True, top_k=1),
                   mesh=make_local_mesh(1, 1), max_len=MAX_LEN)
    teng = Engine(get_config("yi-9b").reduced(), device="cpu", max_len=MAX_LEN)
    for kw, match in (({"prefill_chunk": 8}, "dp >= 2"), ({"prefill_chunk": 0}, "prefill_chunk")):
        with pytest.raises(ValueError, match=match) as jerr:
            JDisaggScheduler(jeng, n_slots=2, block_size=8, prefill_shards=1, **kw)
        with pytest.raises(ValueError, match=match) as terr:
            DisaggScheduler(teng, n_slots=2, block_size=8, prefill_shards=1, **kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="prefill_shards=2"):
        DisaggScheduler(_dp2_engine(), n_slots=4, prefill_shards=2, **SLOT)
    with pytest.raises(ValueError, match="n_slots 3 must divide data shards 2"):
        DisaggScheduler(_dp2_engine(), n_slots=3, prefill_shards=1, **SLOT)


def test_serve_cli_disagg_dp2(capfd):
    """``serve.py --scheduler disagg --dp 2 --prefill-shards 1`` on the CPU:
    two gloo ranks, the first the prefill pool; rank 0 prints the pools,
    the migration and its wait."""
    done = serve.main(["--device", "cpu", "--top-k", "1", "--scheduler", "disagg", "--dp", "2",
                       "--prefill-shards", "1", "--requests", "5", "--arrival-every", "2",
                       "--max-len", "64", "--prefill-chunk", "16", "--shared-prefix", "16",
                       "--max-new", "6"])
    out = capfd.readouterr().out
    assert len(done) == 5 and all(r.finish_reason in ("stop", "length") for r in done)
    assert "(disagg; arch=yi-9b-smoke, tp=1, dp=2, device=cpu, gloo)" in out
    for line in ("pools: 1 prefill + 1 decode shards", "migration: ", "migration wait p50/p95"):
        assert line in out, out
