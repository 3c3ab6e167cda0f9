"""What each rank of a data-parallel world runs for tests/test_torch_dp.py
and tests/test_torch_disagg.py: the port only (torch, numpy, repro_torch),
so the spawned rank processes import no jax.  Every function here takes
(dist, device, ...) as ``launch.mesh.spawn`` calls it and returns plain
data.

One spawn serves a whole file: a world of dp x tp ranks whose data groups
are themselves worlds of dp ranks at tp=1 (``tp1``), and whose ranks can
split into smaller data-parallel worlds (``sub_world``), so cases of
several (dp, tp) shapes run in one set of processes."""
import torch
import torch.distributed as tdist

from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig
from repro_torch.core import collectives as cc
from repro_torch.models.common import Dist
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, DisaggScheduler,
                                           PagedContinuousScheduler, WaveScheduler)

GREEDY = SamplingConfig(top_k=1)
SCHEDULERS = {"wave": WaveScheduler, "continuous": ContinuousScheduler,
              "paged": PagedContinuousScheduler, "disagg": DisaggScheduler}


def tp1(dist: Dist) -> Dist:
    """This rank's data group as a world of ``dist.dp`` ranks at tp=1."""
    return Dist(tp=1, rank=0, group=None, backend=dist.backend, dp=dist.dp,
                data_rank=dist.data_rank, data_group=dist.data_group, control=dist.data_group)


def sub_world(dist: Dist, dp: int) -> Dist:
    """A world of ``dp`` ranks at tp=1 out of a tp=1 world: consecutive
    data ranks in groups of ``dp`` (every rank creates every group, in
    order)."""
    mine = None
    for lo in range(0, dist.dp, dp):
        g = tdist.new_group(list(range(lo, lo + dp)))
        if lo <= dist.data_rank < lo + dp:
            mine = g
    return Dist(tp=1, rank=0, group=None, backend=dist.backend, dp=dp,
                data_rank=dist.data_rank % dp, data_group=mine, control=mine)


def engine(dist: Dist, device, cfg, tree, parallel_kw, max_len=64) -> Engine:
    """An engine on rank ``dist``'s shard of the bridged JAX tree."""
    par = ParallelConfig(tp=dist.tp, dp=dist.dp, **parallel_kw)
    return Engine(cfg, parallel=par, sampling=GREEDY, max_len=max_len, device=device,
                  params=bridge.params_from_jax(tree, cfg, device, dist), dist=dist)


def serve(sched, reqs):
    for prompt, max_new, eos, arrival in reqs:
        sched.submit(prompt, max_new, eos_id=eos, arrival_step=arrival)
    with cc.comm_stats() as st:
        done = sched.run()
    return ({r.rid: (r.output, r.finish_reason) for r in done},
            {k: v for k, v in getattr(sched, "stats", {}).items() if not isinstance(v, dict)},
            st.by_tag())


def run_sched(dist, device, cfg, tree, run, max_len=64):
    """One scheduler run -> (streams, stats, collectives by tag);
    ``run`` = (scheduler kind, its kw, engine ParallelConfig kw, requests)."""
    kind, kw, par_kw, reqs = run
    eng = engine(dist, device, cfg, tree, par_kw, max_len)
    return serve(SCHEDULERS[kind](eng, **kw), reqs)


def seq_shard_case(dist, device, cfg, case):
    """The sequence-sharded wave cache on rank ``dist`` (the weights
    ``case["tree"]``): the logits of a
    prefill of ``case["prompts"]`` and of decode steps fed
    ``case["forced"]`` (all vocab gathered), the collectives of each decode
    step, and a greedy wave of the prompts."""
    eng = engine(dist, device, cfg, case["tree"], {"kv_seq_shard": True}, case["max_len"])
    prompts = torch.from_numpy(case["prompts"]).long()
    b, plen = prompts.shape
    full = lambda lg: cc.all_gather(lg, dist, lg.dim() - 1)[..., :cfg.vocab_size].float().numpy()
    out = {"records": []}
    with torch.inference_mode():
        caches = eng.init_caches(b)
        out["cache_len"] = caches["pos"].shape[0]
        logits = [full(eng.forward(prompts, caches=caches, seq_sharded=True)[:, -1])]
        for i in range(case["forced"].shape[1]):
            tok = torch.from_numpy(case["forced"][:, i]).long()[:, None]
            with cc.comm_stats() as st:
                lg = eng.forward(tok, caches=caches, cur_pos=plen + i)
            logits.append(full(lg[:, -1]))
            out["records"].append([(r.kind, r.axis, r.tag, r.bytes) for r in st.records])
        out["pos"] = caches["pos"].numpy()
    out["logits"] = logits
    out["wave"] = eng.generate(case["prompts"], case["max_new"])
    return out


def run_dp_cases(dist, device, cfg, tree, runs, seq_case):
    """tests/test_torch_dp.py on a world of 2 x 2 ranks: the scheduler runs
    on model rank 0's data group (dp 2 at tp 1), the sequence-sharded case
    on model rank 1's at the same time, then on the whole world."""
    torch.set_num_threads(1)
    out = {}
    if dist.rank == 0:
        out["runs"] = {name: run_sched(tp1(dist), device, cfg, tree, run)
                       for name, run in runs.items()}
    else:
        out["seq dp2"] = seq_shard_case(tp1(dist), device, cfg, seq_case)
    out["seq dp2 tp2"] = seq_shard_case(dist, device, cfg, seq_case)
    return out


def disagg_run(dist, device, cfg, tree, case):
    """One DisaggScheduler run of a tests/test_torch_disagg.py case ->
    (streams, stats, collectives by tag, the allocator's state after)."""
    eng = engine(dist, device, cfg, tree, case["parallel"])
    sched = DisaggScheduler(eng, **case["sched"])
    audits = []

    def audit(expect_no_migration=False):
        try:
            sched.alloc.audit(expect_no_migration)
        except AssertionError as e:
            audits.append(str(e))

    quarantine = sched._quarantine_slot

    def audited_quarantine(i, finish_reason="error", error=None):
        quarantine(i, finish_reason, error)
        audit()

    sched._quarantine_slot = audited_quarantine        # audit after every quarantine
    sched.on_preempt = lambda rid: audit()             # ... and every preemption
    streams, stats, comm = serve(sched, case["reqs"])
    audit(expect_no_migration=True)
    alloc = sched.alloc
    state = {"audits": audits, "total_used": alloc.total_used(),
             "migrating": alloc.migrating_count(),
             "free": [alloc.free_count(s) for s in range(alloc.n_shards)],
             "per_shard": alloc.blocks_per_shard, "block_bytes": sched._block_bytes,
             "summary_pools": sched.request_summary()["pools"],
             "errors": {r.rid: r.stats.get("error") for r in sched.done
                        if r.finish_reason == "error"}}
    return streams, stats, comm, state


def preempt_during_migration(dist, device, cfg, tree, prompt):
    """tests/test_disagg.py's preemption of a slot whose first block is
    queued for migration: the handoff rolls back whole, the request
    requeues at the head, and its rerun completes."""
    eng = engine(dist, device, cfg, tree, {})
    dis = DisaggScheduler(eng, n_slots=4, block_steps=2, block_size=8, prefill_chunk=8,
                          prefill_shards=1)
    rid = dis.submit(prompt, 6)
    dis._init_caches()
    dis._retire()
    dis._admit()
    dis._chunk_step()           # publishes block 0 and queues its copy at once
    out = {"queued": len(dis._mig_queue), "pinned": dis.alloc.migrating_count()}
    out["preempted"] = dis._preempt_youngest(0)
    out.update(after_queue=len(dis._mig_queue), after_mig=len(dis._mig),
               after_pinned=dis.alloc.migrating_count(), after_used=dis.alloc.total_used(),
               requeued=bool(dis.queue) and dis.queue[0].rid == rid)
    done = dis.run()
    out.update(done=[(r.rid, len(r.output)) for r in done], preemptions=dis.stats["preemptions"],
               end_used=dis.alloc.total_used(), end_pinned=dis.alloc.migrating_count())
    return out


def run_disagg_cases(dist, device, cfg, trees, cases, prompt):
    """tests/test_torch_disagg.py on a world of 4 data ranks: the dp=2
    cases split over its two halves (worlds of 2 ranks, at once), then the
    dp=4 cases on the whole world; -> {case: its run on this rank}."""
    torch.set_num_threads(1)
    half = sub_world(dist, 2)
    side = dist.data_rank // 2
    out = {}
    for name, case in cases.items():
        if case["dp"] == 2 and case["half"] == side:
            out[name] = disagg_run(half, device, cfg, trees[case["tree"]], case)
    if side == 1:
        out["preempt"] = preempt_during_migration(half, device, cfg, trees["bf16"], prompt)
    for name, case in cases.items():
        if case["dp"] == 4:
            out[name] = disagg_run(dist, device, cfg, trees[case["tree"]], case)
    return out
