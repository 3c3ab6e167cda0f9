"""The degradation ladder, disaggregated serving under it, and the HTTP
frontend across ranks, against the JAX package's and the same world's
plain runs.

Reduced yi-9b on the JAX package's weights bridged bit for bit
(tests/torch_control_plane.py), greedy, over gloo ranks on the CPU: one
spawn of four ranks (tests/torch_control_ranks.py) runs the tp 2 cases on
its two replicas at once, then the dp 2 cases on its two data groups at
once; the JAX package's disagg run is a subprocess with two virtual
devices (as tests/test_torch_disagg.py runs it), its tp=1 ladder a thread.

* the ladder under a burst at tp 2 (tests/test_slo.py's
  ``test_ladder_sheds_batch_and_recovers``): the level after every round
  and the transitions the JAX scheduler's, interactive never shed, every
  interactive stream the plain run's at tp 2 and the JAX package's;
* tests/test_slo.py's disagg scenario at dp 2 (1p1d with the interactive
  block reserve and the ladder on), blocking and overlapped: the JAX
  DisaggScheduler's transitions and sheds, interactive never shed, the
  survivors the plain disagg run's at dp 2, only batch shed;
* the HTTP frontend at tp 2 on 127.0.0.1 (world rank 0 serves, rank 1
  follows the round records): 4 concurrent SSE clients get the blocking
  run's tokens at tp 2, 6 concurrent requests against max_pending 2 get a
  429 with Retry-After (the door sheds counted on every rank), a stream in
  flight at the drain is served whole, and the stop record ends rank 1;
  the same under a burst of batch requests with the ladder on (the plan's
  burst fires on every rank from the step count: rank 0 announces only
  what its clients posted), every rank the same streams and counters;
* ``launch/frontend.py`` at ``--dp 2 --scheduler disagg`` on the CPU: a
  completion over HTTP, then SIGINT to the process group drains rank 0
  and ends every rank.
"""
import json
import os
import signal
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

import torch_threads  # noqa: F401
import torch_control_ranks
from repro.configs import get_config as jget_config
from repro.runtime.scheduler import ContinuousScheduler as JContinuousScheduler
from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
from repro_torch.launch import mesh
from repro_torch.runtime.engine import Engine
from test_slo import mixed_requests
from test_torch_continuous import TIE_GAP, top2_gap
from test_torch_model import jax_engine
from test_torch_tp import _torch_tree
from torch_control_plane import MAX_LEN, assert_same_streams

TESTS = Path(__file__).resolve().parent
BURST = "burst:at=2,count=8,cls=batch,new=4"
FRONTEND_BURST = "burst:at=2,count=4,cls=batch"
LADDER = {"enabled": True, "queue_hi": 4, "queue_lo": 1, "patience": 1, "cooldown": 2}
DISAGG = dict(n_slots=4, block_steps=2, block_size=8, prefill_chunk=8, prefill_shards=1,
              prefix_cache=False)
DISAGG_LADDER = {"enabled": True, "queue_hi": 4, "queue_lo": 1, "patience": 1, "cooldown": 2}


def _req(p, mn, arr=0, cls="standard"):
    return (np.asarray(p, np.int32), mn, None, arr, cls, None)


def burst_requests(vocab):
    """tests/test_slo.py's: six interactive requests, one every 4 steps."""
    rng = np.random.default_rng(5)
    return [_req(rng.integers(0, vocab, 6), 10, arr=4 * i, cls="interactive") for i in range(6)]


def _stages(cfg):
    vocab = cfg.vocab_size
    burst = burst_requests(vocab)
    mixed = mixed_requests(cfg, n=10, seed=8, max_new=6)
    plain = [_req(p, mn, arr=4 * i, cls=c) for i, (p, mn, c) in enumerate(mixed)]
    loaded = [_req(p, mn, cls=c) for p, mn, c in mixed]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, vocab, 8).tolist() for _ in range(10)]
    slots = dict(n_slots=2, block_steps=2)
    tp2 = {
        "ladder plain": dict(kind="dense", sched=slots, reqs=burst, axis="model", on=0),
        "ladder": dict(kind="dense", sched=dict(slots, fault_plan=BURST, overload_opts=LADDER),
                       reqs=burst, axis="model", on=0, levels=True),
        "frontend": dict(kind="frontend", prompts=prompts[:4], overload_prompts=prompts[4:],
                         max_new=8, axis="model", on=1),
        "frontend burst": dict(kind="frontend", prompts=prompts[:4],
                               overload_prompts=prompts[4:], max_new=8, axis="model", on=0,
                               sched=dict(fault_plan=FRONTEND_BURST, overload_opts=LADDER)),
    }
    ladder = dict(DISAGG, reserve_blocks=1, overload_opts=DISAGG_LADDER)
    dp2 = {
        "disagg plain": dict(kind="disagg", sched=DISAGG, reqs=plain, axis="data", on=0),
        "disagg ladder": dict(kind="disagg", sched=ladder, reqs=loaded, axis="data", on=0),
        "disagg ladder overlapped": dict(kind="disagg", sched=dict(ladder, overlap=True),
                                         reqs=loaded, axis="data", on=1),
    }
    return [tp2, dp2], burst


JAX_DISAGG_LADDER = r"""
import json
from repro.configs import ParallelConfig, SamplingConfig, get_config
from repro.launch.mesh import make_local_mesh
from repro.runtime.engine import Engine
from repro.runtime.scheduler import DisaggScheduler
from test_slo import mixed_requests, run_mixed
from test_torch_model import jax_engine

cfg = get_config("yi-9b").reduced()
e1, _ = jax_engine(cfg, %d)
eng = Engine(cfg=cfg, parallel=ParallelConfig(tp=1, dp=2, remat=False),
             sampling=SamplingConfig(greedy=True, top_k=1), mesh=make_local_mesh(2, 1),
             max_len=%d)
eng.params = e1.params
reqs = mixed_requests(cfg, n=10, seed=8, max_new=6)
kw = %r
ref, _ = run_mixed(DisaggScheduler(eng, **kw), reqs, arrival_every=4)
sched = DisaggScheduler(eng, reserve_blocks=1, overload_opts=%r, **kw)
done, rids = run_mixed(sched, reqs)
print(json.dumps({"plain": {r: d.output.tolist() for r, d in ref.items()},
                  "done": {r: [d.output.tolist(), d.finish_reason] for r, d in done.items()},
                  "transitions": sched.overload_ctl.transitions,
                  "shed": sched.stats["classes"]["batch"]["shed"],
                  "classes": sched.stats["classes"]}))
""" % (MAX_LEN, MAX_LEN, DISAGG, DISAGG_LADDER)


def _jax_ladder(jeng, burst):
    """tests/test_slo.py's ladder under a burst, on the JAX scheduler at
    tp=1: its level after every round, transitions and streams."""
    sched = JContinuousScheduler(jeng, n_slots=2, block_steps=2, fault_plan=BURST,
                                 overload_opts=LADDER)
    for p, mn, eos, arr, cls, _ in burst:
        sched.submit(p, mn, eos_id=eos, arrival_step=arr, priority=cls)
    levels = []
    while sched.serve_step():
        levels.append(sched.overload_level())
    done = {r.rid: r for r in sched.run()}
    jeng.dispatch_hook = None
    return levels, list(sched.overload_ctl.transitions), done


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = jget_config("yi-9b").reduced(), get_config("yi-9b").reduced()
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=f"{TESTS.parent / 'src'}{os.pathsep}{TESTS}", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_DISAGG_LADDER], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        jeng, tree = jax_engine(jcfg, MAX_LEN)
        teng = Engine(cfg, parallel=ParallelConfig(), sampling=SamplingConfig(top_k=1),
                      max_len=MAX_LEN, params=bridge.params_from_jax(tree, cfg, device="cpu"),
                      device="cpu")
        stages, burst = _stages(cfg)
        with ThreadPoolExecutor(1) as pool:
            ladder = pool.submit(_jax_ladder, jeng, burst)
            got = mesh.spawn(torch_control_ranks.run_cases, 2, cfg, _torch_tree(tree), stages,
                             device="cpu", dp=2)
            ladder = ladder.result(timeout=600)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return got, {"ladder": ladder, "disagg": json.loads(out)}, teng, jeng, stages


def _runs(got, name, n=2):
    runs = [r[name] for r in got if name in r]
    assert len(runs) == n
    for r in runs[1:]:
        for key in ("streams", "order", "counters", "levels", "transitions"):
            assert r.get(key) == runs[0].get(key), key
    return runs


def _requests(streams):
    return {rid: types.SimpleNamespace(output=np.asarray(t, np.int32), finish_reason=why)
            for rid, (t, why) in streams.items()}


def test_ladder_under_burst_at_tp2(served):
    got, ref, teng, jeng, _ = served
    r = _runs(got, "ladder")[0]
    plain = _runs(got, "ladder plain")[0]
    jlevels, jtransitions, jdone = ref["ladder"]
    assert r["levels"] == jlevels and [tuple(t) for t in r["transitions"]] == jtransitions
    assert max(r["levels"]) >= 1 and r["levels"][-1] == 0
    assert r["stats"]["burst_injected"] == 8 and r["counters"]["overload_transitions"] >= 2
    assert r["classes"]["interactive"]["shed"] == 0 and r["classes"]["batch"]["shed"] >= 1
    for rid, (toks, why) in plain["streams"].items():     # the interactive requests
        assert r["streams"][rid] == (toks, why) and why in ("stop", "length")
    assert all(why == "shed" or rid < 6 or why in ("stop", "length")
               for rid, (_, why) in r["streams"].items())
    assert_same_streams(teng, _requests(r["streams"]), jdone, jeng=jeng)
    # the ladder's record every round: its length and payload
    assert r["control"]["count"] == 2 * r["rounds"]


@pytest.mark.parametrize("name", ["disagg ladder", "disagg ladder overlapped"])
def test_disagg_ladder_at_dp2(served, name):
    """tests/test_slo.py's ``test_disagg_priority_classes_and_reserves``:
    interactive never shed, the ladder engaged, the survivors the plain
    run's, only batch shed; the transitions and sheds the JAX
    DisaggScheduler's."""
    got, ref, teng, jeng, stages = served
    r = _runs(got, name)[0]
    plain = _runs(got, "disagg plain")[0]
    jd = ref["disagg"]
    classes = {rid: req[4] for rid, req in enumerate(stages[1][name]["reqs"])}
    assert r["classes"]["interactive"]["shed"] == 0
    assert max(t[2] for t in r["transitions"]) >= 1
    assert [list(t) for t in r["transitions"]] == jd["transitions"]
    assert r["classes"]["batch"]["shed"] == jd["shed"] >= 1
    for rid, (toks, why) in r["streams"].items():
        if why in ("stop", "length"):
            assert toks == plain["streams"][rid][0]
        else:
            assert why == "shed" and classes[rid] == "batch"
    assert sorted(rid for rid, (_, w) in r["streams"].items() if w == "shed") == \
        sorted(int(rid) for rid, (_, w) in jd["done"].items() if w == "shed")
    if name.endswith("overlapped"):
        assert r["stats"]["landings"] > 0
        blocking = _runs(got, "disagg ladder")[0]
        assert r["streams"] == blocking["streams"]


def test_disagg_plain_streams_equal_jax(served):
    """The plain disagg run at dp 2 against the JAX DisaggScheduler's: the
    same streams but at a near-tie certified on the port's tp=1 logits."""
    got, ref, teng, _, stages = served
    plain = _runs(got, "disagg plain")[0]
    reqs = stages[1]["disagg plain"]["reqs"]
    for rid, toks in ref["disagg"]["plain"].items():
        mine = plain["streams"][int(rid)][0]
        if mine == toks:
            continue
        t = next(i for i, (a, b) in enumerate(zip(mine + [-1], toks + [-2])) if a != b)
        assert top2_gap(teng, reqs[int(rid)][0], toks[:t]) < TIE_GAP, rid


def test_frontend_at_tp2_over_http(served):
    got, _, teng, _, stages = served
    runs = [r["frontend"] for r in got if "frontend" in r]
    assert len(runs) == 2
    r0 = next(r for r in runs if r["world_rank"] == 0)
    follower = next(r for r in runs if r["world_rank"] == 1)
    case = stages[0]["frontend"]
    # 4 concurrent SSE clients: the blocking run's tokens at tp 2, but at a
    # near-tie certified on the port's tp=1 logits (the frontend admits in
    # other batches)
    flips = 0
    for rid, (status, toks) in enumerate(r0["streamed"]):
        want = r0["ref"][rid]
        assert status == 200 and len(toks) == case["max_new"]
        if toks != want:
            t = next(i for i, (a, b) in enumerate(zip(toks, want)) if a != b)
            assert top2_gap(teng, np.asarray(case["prompts"][rid]), want[:t]) < TIE_GAP
            flips += 1
    assert flips <= 1
    statuses = [st for st, _, _ in r0["overload"]]
    assert statuses.count(429) >= 1 and set(statuses) <= {200, 429}
    assert all(ra == "1" for st, ra, _ in r0["overload"] if st == 429)
    assert all(len(t) == 8 for st, _, t in r0["overload"] if st == 200)
    assert r0["shed_requests"] == statuses.count(429)
    # the drain served the stream in flight whole, then nothing listens, and
    # the stop record ended the follower with rank 0's requests and counters
    assert r0["drained"][0] == 200 and len(r0["drained"][1]) == case["max_new"]
    assert not r0["listening"]
    assert follower["done"] == r0["done"] and follower["counters"] == r0["counters"]
    assert follower["streams"] == r0["streams"]
    assert follower["counters"]["shed"].get("standard") == statuses.count(429)


def test_frontend_with_burst_and_ladder_at_tp2(served):
    """The frontend at tp 2 under a fault plan's burst with the ladder on:
    the burst fires on every rank from the step count and is not carried
    again in a record (a follower would take it twice and part), so every
    rank serves the same streams with the same counters; the clients'
    streams are served whole."""
    got, _, _, _, stages = served
    runs = [r["frontend burst"] for r in got if "frontend burst" in r]
    assert len(runs) == 2
    r0 = next(r for r in runs if r["world_rank"] == 0)
    follower = next(r for r in runs if r["world_rank"] == 1)
    assert follower["streams"] == r0["streams"] and follower["counters"] == r0["counters"]
    assert follower["done"] == r0["done"]
    assert r0["counters"]["burst_injected"] == 4
    assert r0["counters"]["shed"].get("interactive", 0) == 0
    case = stages[0]["frontend burst"]
    assert all(st == 200 and len(toks) == case["max_new"] for st, toks in r0["streamed"])
    statuses = [st for st, _, _ in r0["overload"]]
    assert set(statuses) <= {200, 429}
    assert r0["drained"][0] == 200 and not r0["listening"]


def test_frontend_cli_disagg_dp2_sigint_ends_every_rank():
    """``python -m repro_torch.launch.frontend --dp 2 --scheduler disagg``:
    a completion over HTTP, /health from rank 0, then SIGINT to the
    process group: rank 0 drains, the stop record ends rank 1, the parent
    exits 0."""
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.frontend", "--device", "cpu", "--top-k", "1",
         "--scheduler", "disagg", "--dp", "2", "--prefill-chunk", "16", "--overlap",
         "--overload-degrade", "--slots", "2", "--max-len", "64", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line:
            assert time.monotonic() < deadline and proc.poll() is None, line
            line = proc.stdout.readline()
        assert "(disagg, overlapped, tp=1, dp=2)" in line
        port = int(line.rsplit(":", 1)[1].split("/")[0])
        st, _, data = torch_control_ranks._post(port, {"prompt": [5, 6, 7, 8], "max_tokens": 4,
                                                       "max_time": 60})
        assert st == 200 and len(json.loads(data)["choices"][0]["token_ids"]) == 4
        import http.client
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        c.request("GET", "/health")
        health = json.loads(c.getresponse().read())
        assert health["status"] == "ok" and health["overload"]["level"] == 0
        os.killpg(proc.pid, signal.SIGINT)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0 and "draining" in out, out[-2000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
