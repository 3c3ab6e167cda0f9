"""What each tensor-parallel rank runs for tests/test_torch_tp.py,
tests/test_torch_tp_serve.py and their counterparts for the RG-LRU, MoE and
MLA families (tests/test_torch_tp_families*.py) and for the SSD, tied-head,
modality-prefix and multi-codebook archs (tests/test_torch_tp_ssd_modal*.py):
the port only (torch, numpy, repro_torch),
so the spawned rank processes import no jax.  Every function here takes
(dist, device, ...) as ``launch.mesh.spawn`` calls it and returns plain
data (numpy arrays, dicts, the schedulers' finished requests)."""
import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import ParallelConfig, SamplingConfig
from repro_torch.core import collectives as cc
from repro_torch.core import embedding
from repro_torch.models import model as TM
from repro_torch.models import moe
from repro_torch.models.common import ShardPlan
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, PagedContinuousScheduler,
                                           WaveScheduler)

GREEDY = SamplingConfig(top_k=1)


def _records(stats):
    return [(r.kind, r.tag, r.bytes) for r in stats.records]


def _full_vocab(logits, dist, vocab):
    """This rank's vocab shard of logits -> all of them (the padding cut)."""
    return cc.all_gather(logits, dist, logits.dim() - 1)[..., :vocab].float().numpy()


def _engine(dist, device, cfg, tree, parallel_kw, sharded_table=False, max_len=32,
            sampling=GREEDY, **kw):
    """An engine on rank ``dist``'s shard of the bridged tp=1 JAX tree;
    ``sharded_table``: the embed table vocab-sharded, as a table past
    ``REPLICATE_BYTES_LIMIT`` is."""
    embedding.REPLICATE_BYTES_LIMIT = 0 if sharded_table else 512 * 2**20
    par = ParallelConfig(tp=dist.tp, **parallel_kw)
    params = bridge.params_from_jax(tree, cfg, device, dist)
    return Engine(cfg, parallel=par, sampling=sampling, max_len=max_len, params=params,
                  device=device, dist=dist, **kw)


def collectives(dist, s_odd=13, d=6):
    """Each collective on seeded values known to every rank, its result and
    the records of the calls."""
    rng = np.random.default_rng(0)
    parts = rng.standard_normal((dist.tp, 2, s_odd, d)).astype(np.float32)
    mine = torch.from_numpy(parts[dist.rank])
    lo, hi = cc.seq_chunk(s_odd, dist.tp, dist.rank)
    with cc.comm_stats() as st:
        out = {
            "all_reduce": cc.all_reduce(mine.clone(), dist, tag="t_ar").numpy(),
            "all_gather": cc.all_gather(mine[:, :3].contiguous(), dist, 1, tag="t_ag").numpy(),
            "gather_odd": cc.all_gather(torch.from_numpy(parts[0][:, lo:hi]), dist, 1,
                                        tag="t_ago", total=s_odd).numpy(),
            "reduce_scatter": cc.reduce_scatter(mine.clone(), dist, 1, tag="t_rs").numpy(),
            "broadcast": cc.broadcast_from0(mine.clone(), dist, tag="t_bc").numpy(),
        }
    out["records"] = _records(st)
    out["chunk"] = (lo, hi)
    return out


def _routes(log):
    """MoE LOG records -> each layer call's top experts and dropped
    (token, expert) pairs, on the host."""
    return [(r["top_e"].cpu().numpy(), moe.dropped(r).numpy()) for r in log]


def model_case(dist, device, case):
    """One model case: logits of a 16- and a 13-token prefill, a decode step
    after the 16, and a width-5 verify chunk after 12 admitted tokens (all
    against positions of one 17-token reference; no chunk where
    ``case["verify"]`` is false: a recurrent model's), with the collective
    records of the 16-token prefill and the decode step.  An MoE model's
    forwards route as the reference routed (``case["jax_routes"]``, the
    tokens ranked apart in ``router_ties``), and the case adds the routes
    (``_routes``) of a cacheless prefill of ``case["long"]`` (past 256
    tokens: drops), routed by the rank's router, and again routed as
    ``case["long_routes"]`` say (``long_replayed``)."""
    cfg, tree, tokens = case["cfg"], case["tree"], torch.from_numpy(case["tokens"])
    eng = _engine(dist, device, cfg, tree, case["parallel"], case.get("sharded_table", False))
    b, V = tokens.shape[0], cfg.vocab_size
    out = {}
    moe.LOG = [] if cfg.moe is not None else None
    jax_routes = case.get("jax_routes")

    def replay(cols):
        """The reference's routes of the positions ``cols`` (its forward of
        all the tokens) for the next forward's MoE layers."""
        if jax_routes is not None:
            moe.ROUTE_REPLAY = [torch.from_numpy(np.ascontiguousarray(r[:, cols]).reshape(
                -1, r.shape[-1])) for r in jax_routes]

    with torch.inference_mode():
        caches = eng.init_caches(b)
        replay(slice(0, 16))
        with cc.comm_stats() as st:
            lg = eng.forward(tokens[:, :16], caches=caches, seq_sharded=True)
        out["prefill16"], out["prefill16_records"] = _full_vocab(lg, dist, V), _records(st)
        replay(slice(16, 17))
        with cc.comm_stats() as st:
            lg = eng.forward(tokens[:, 16:17], caches=caches, cur_pos=16)
            eng.sample(lg[:, -1])
        out["decode"], out["decode_records"] = _full_vocab(lg, dist, V), _records(st)
        replay(slice(0, 13))
        lg = eng.forward(tokens[:, :13], caches=eng.init_caches(b), seq_sharded=True)
        out["prefill13"] = _full_vocab(lg, dist, V)
        if case.get("verify", True):
            slots = eng.init_slot_caches(b)
            replay(slice(0, 12))
            eng.prefill_into_slots(slots, tokens[:, :12].numpy(), np.ones(b, bool),
                                   np.full(b, 12))
            kw = eng._chunk_kw(slots, np.arange(b), np.full(b, 12), 5, None)
            replay(slice(12, 17))
            lg = eng.forward(tokens[:, 12:17], caches=slots, seq_sharded=True, **kw)
            out["verify5"] = _full_vocab(lg, dist, V)
        if moe.LOG is not None:
            assert not moe.ROUTE_REPLAY
            moe.ROUTE_REPLAY = None
            out["router_ties"] = [m for r in moe.LOG for m in _ranked_apart(r)]
            if "long" in case:
                moe.LOG = []
                eng.forward(torch.from_numpy(case["long"]), seq_sharded=True)
                out["routes"] = _routes(moe.LOG)
                # again, routing as the port routed at tp=1
                moe.LOG = []
                moe.ROUTE_REPLAY = [torch.from_numpy(r) for r in case["long_routes"]]
                eng.forward(torch.from_numpy(case["long"]), seq_sharded=True)
                moe.ROUTE_REPLAY = None
                out["long_replayed"] = _routes(moe.LOG)
                out["router_ties"] += [m for r in moe.LOG for m in _ranked_apart(r)]
    moe.LOG = None
    return out


def _ranked_apart(rec):
    """The margins of the tokens whose experts a LOG record's router ranks
    apart from the experts it used (a replayed route): its own k-th
    probability less that of the replayed choice it left out."""
    probs, chosen = rec["probs"], rec["top_e"]
    own = torch.topk(probs, chosen.shape[1]).indices
    out = []
    for t in torch.nonzero((own.sort(1).values != chosen.sort(1).values).any(1))[:, 0]:
        other = [e for e in chosen[t].tolist() if e not in own[t].tolist()]
        out.append(float(probs[t, own[t]].min() - probs[t, other].min()))
    return out


def ablations(dist, device, cfg, table):
    """The paper's ablations on rank ``dist``: top-k before the gather
    against the full-row gather (same draws, bytes); token ids against
    rank 0's activations, over a replicated and a vocab-sharded table."""
    from repro_torch.runtime.sampling import sample_tokens

    out = {}
    V = 4096
    plan = ShardPlan.make(dict_cfg(cfg, V), dist.tp)
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, V)).astype(np.float32))
    local = logits[:, dist.rank * plan.local_vocab:(dist.rank + 1) * plan.local_vocab]
    for sync in (True, False):
        gen = torch.Generator().manual_seed(7)
        with cc.comm_stats() as st:
            tok = sample_tokens(local.contiguous(), SamplingConfig(top_k=16), gen, plan, dist,
                                sync)
        out[f"topk_sync={sync}"] = (tok.numpy(), st.total_bytes())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, table.shape[1], (2, 8)))
    tplan = ShardPlan.make(dict_cfg(cfg, table.shape[1]), dist.tp)
    lv = tplan.local_vocab
    padded = torch.zeros((1, tplan.vocab_p, table.shape[2]), dtype=table.dtype)
    padded[:, :table.shape[1]] = table
    shards = {"replicated": table, "sharded": padded[:, dist.rank * lv:(dist.rank + 1) * lv]}
    for layout, t in shards.items():
        for idb in (True, False):
            with cc.comm_stats() as st:
                x = embedding.embed_lookup({"table": t.contiguous()}, tokens, tplan, dist,
                                           id_broadcast=idb)
            out[f"embed {layout} id_broadcast={idb}"] = (x.float().numpy(), _records(st))
    return out


def dict_cfg(cfg, vocab):
    import dataclasses
    return dataclasses.replace(cfg, vocab_size=vocab)


def run_model_cases(dist, device, cases, ablation_args):
    """Everything test_torch_tp.py asks of one rank group, in one spawn."""
    torch.set_num_threads(1)
    out = {"collectives": collectives(dist),
           "cases": {name: model_case(dist, device, case) for name, case in cases.items()
                     if dist.tp in case["tps"]}}
    out["ablations"] = ablations(dist, device, *ablation_args)
    return out


def _serve(sched, reqs):
    for prompt, max_new, eos, arrival in reqs:
        sched.submit(prompt, max_new, eos_id=eos, arrival_step=arrival)
    return {r.rid: r for r in sched.run()}


def run_serve_cases(dist, device, cfg, tree, runs, max_len=64):
    """test_torch_tp_serve.py's scheduler runs on one rank group:
    ``runs`` name -> (scheduler kind, scheduler kw, engine ParallelConfig
    kw, requests, top_k)."""
    torch.set_num_threads(1)
    out = {}
    for name, (kind, sched_kw, par_kw, reqs, top_k) in runs.items():
        eng = _engine(dist, device, cfg, tree, par_kw, max_len=max_len,
                      sampling=SamplingConfig(top_k=top_k))
        if kind == "wave":
            sched = WaveScheduler(eng, **sched_kw)
        elif kind == "paged":
            sched = PagedContinuousScheduler(eng, **sched_kw)
        else:
            sched = ContinuousScheduler(eng, **sched_kw)
        done = _serve(sched, reqs)
        out[name] = ({rid: (r.output, r.finish_reason) for rid, r in done.items()},
                     dict(getattr(sched, "stats", {})))
    return out


def run_family_serve_cases(dist, device, archs):
    """tests/test_torch_tp_families_serve.py's runs on one rank group:
    ``archs`` name -> (cfg, tree, max_len, runs) as ``run_serve_cases``
    takes them; an MoE arch's runs add each rank's routes (``_routes``)."""
    out = {}
    for name, (cfg, tree, max_len, runs) in archs.items():
        moe.LOG = [] if cfg.moe is not None else None
        for run, res in run_serve_cases(dist, device, cfg, tree, runs, max_len).items():
            out[f"{name} {run}"] = res
        if moe.LOG is not None:
            out[f"{name} routes"] = _routes(moe.LOG)
        moe.LOG = None
    return out


def ssd_modal_case(dist, device, case):
    """One case of tests/test_torch_tp_ssd_modal.py: the logits of a 16- and
    a 13-token (frame) prefill behind ``case["features"]`` (a frontend
    arch's seeded prefix, else none) and of a decode step after the 16,
    all vocab gathered; the collective records of the 16-token prefill and
    of the decode step with its sampling; and an SSD model's recurrent
    state (``h``, ``conv``) after the decode step, this rank's share."""
    cfg, tree = case["cfg"], case["tree"]
    tokens = torch.from_numpy(case["tokens"])
    feats = case.get("features")
    feats = None if feats is None else torch.from_numpy(feats)
    eng = _engine(dist, device, cfg, tree, case["parallel"], case.get("sharded_table", False))
    b, V = tokens.shape[0], cfg.vocab_size
    prefix = eng.prefix
    out = {}
    with torch.inference_mode():
        caches = eng.init_caches(b)
        with cc.comm_stats() as st:
            lg = eng.forward(tokens[:, :16], caches=caches, seq_sharded=True, features=feats)
        out["prefill16"], out["prefill16_records"] = _full_vocab(lg, dist, V), _records(st)
        with cc.comm_stats() as st:
            lg = eng.forward(tokens[:, 16:17], caches=caches, cur_pos=prefix + 16)
            eng.sample(lg[:, -1])
        out["decode"], out["decode_records"] = _full_vocab(lg, dist, V), _records(st)
        if "h" in caches:
            out["state"] = {k: caches[k].float().numpy() for k in ("h", "conv")}
        lg = eng.forward(tokens[:, :13], caches=eng.init_caches(b), seq_sharded=True,
                         features=feats)
        out["prefill13"] = _full_vocab(lg, dist, V)
    return out


def run_ssd_modal_cases(dist, device, cases):
    """Every case of one rank group (the cases whose ``tps`` hold its tp)."""
    torch.set_num_threads(1)
    return {name: ssd_modal_case(dist, device, case) for name, case in cases.items()
            if dist.tp in case["tps"]}
