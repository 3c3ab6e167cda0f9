"""Serving entry point: ``python -m repro_torch.launch.serve --arch yi-9b``.

Serves synthetic requests through the wave scheduler or, with
``--scheduler continuous|paged``, through continuous batching over a dense
or a paged KV cache, or with ``--scheduler disagg`` through disaggregated
prefill and decode pools over the data axis, and reports per-token latency
(the paper's section 3 metric).  The workload is the JAX serve CLI's, drawn from the
same seed: ``--shared-prefix`` prepends one common system prompt (what the
paged backend's prefix reuse serves), ``--arrival-every`` staggers arrivals
on the virtual decode-step clock, ``--max-new-spread`` draws each budget.
The continuous schedulers admit in chunks of ``--prefill-chunk`` tokens
(default 256; 0: whole prompts) and, with ``--spec-k N``, verify N n-gram
drafts per active slot in each step.  Both ride on ``ParallelConfig``, as
in the JAX serve CLI, so an arch whose capability record blocks chunks or
spec decode (``core/capabilities.py``: recurrentgemma-9b's recurrent state)
falls back to whole-prompt admission and plain decode whatever their
values; its sliding-window ring blocks the paged cache, and ``--scheduler
paged`` raises the record's error.  So do internvl2-26b's and
musicgen-medium's (the modality prefix), which serve the wave and the
dense continuous paths: their prompts follow a prefix of zero stub
features, and musicgen-medium's are (prompt_len, 4) codebook frames.
``--list-archs`` prints the capability matrix and exits.
Weights are random, drawn on the device from ``--seed``; with
``--weight-quant int8|int4`` they are quantized as they are drawn and every
projection and the lm_head go through the dequant_matmul kernel, and
``--wq-cache PATH`` keeps the packed weights on disk (restored when the
file exists).  The int8 KV cache has no flag, as in the JAX serve CLI: it
is ``ParallelConfig.kv_quant``.  Runs on the card unless ``--device cpu``
is given, where the kernels' plain versions run.

``--tp N`` serves with tensor parallelism over N ranks, one process each
(``launch/mesh.py``): every rank builds its shard of the same seeded
model and runs the same scheduler over the same requests; rank 0 prints.
``--dp M`` adds the data axis: M replicas of the tp ranks, ``--dp`` x
``--tp`` processes in all (world rank d * tp + t is model rank t of
replica d), each replica serving its share of the wave's rows or of the
slots and the paged pool, the sampled tokens gathered over the data
group after every engine call.  ``--scheduler disagg`` (``--dp`` >= 2)
makes the first ``--prefill-shards`` replicas the prefill pool and the
rest the decode pool, finished KV blocks migrating between them; it
prints the pools, the migration and the migration wait.
Every config is served at --tp 2, 4 and 8: the dense, RG-LRU, MoE and MLA
families, the SSD heads, the tied head over the vocab-sharded table, the
modality prefix and the multi-codebook head.
``--dist-backend nccl`` puts one rank on each card and raises when there
are fewer cards than ranks; ``gloo`` (the default) shares the cards, or
runs on the CPU with ``--device cpu``, its collectives staged through host
memory, so its wall times are no tensor-parallel speed.
``--no-topk-sync`` gathers the whole logits row before the top-k (the
paper's baseline of section 2.1b).

The continuous schedulers' control plane takes the JAX serve CLI's flags:
``--overlap`` (dispatch decode block N+1 before block N lands),
``--responsive-blocks``, ``--fault-plan`` with ``--max-step-retries`` and
``--retry-backoff-s`` (``runtime/faults.py``), ``--class-mix`` (each
request's priority class drawn from a weighted mix), ``--slo-*``,
``--interactive-reserve-*`` and ``--overload-*`` (the degradation ladder of
``runtime/overload.py``), ``--no-spec-decode`` and ``--stats-json``, which
writes the scheduler's summary and counters, even when the run raised.
They serve at any ``--tp`` and ``--dp``: world rank 0 reads the wall
clock for every rank (the ladder's ITL signal, deadlines) and broadcasts
what it read in a round record (``runtime/control.py``), a fault plan's
``delay`` clause sleeps on rank 0 only, and the run ends by checking that
every rank served the same streams, finish reasons and control counters.
The parser is shared with the HTTP frontend (``launch/frontend.py``),
which serves at any ``--tp`` and ``--dp`` too.  Not ported:
``--no-flash-prefill``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS, ParallelConfig, SamplingConfig, get_config
from repro_torch.core.capabilities import render_text
from repro_torch.launch import mesh
from repro_torch.models import model as M
from repro_torch.models.common import Dist
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import (ContinuousScheduler, DisaggScheduler,
                                           PagedContinuousScheduler, WaveScheduler)


def build_engine(args, dist: Dist = Dist(), device=None) -> Engine:
    """The CLI's engine; at --tp > 1 rank ``dist``'s, on its ``device``."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    return Engine(cfg, parallel=engine_parallel(args),
                  sampling=SamplingConfig(top_k=args.top_k), max_len=args.max_len,
                  seed=args.seed, device=device or args.device, wq_cache=args.wq_cache,
                  dist=dist)


def engine_parallel(args) -> ParallelConfig:
    """The engine's ParallelConfig: admission, decode and control-plane
    options ride on it, where the schedulers read them as defaults that an
    arch may fall back from."""
    return dataclasses.replace(
        parallel_config(args), kv_block_size=args.kv_block_size,
        disagg_prefill_shards=args.prefill_shards if args.scheduler == "disagg" else 0,
        kv_pool_blocks=args.kv_pool_blocks, prefill_chunk=args.prefill_chunk,
        spec_k=0 if args.no_spec_decode else args.spec_k, spec_ngram=args.spec_ngram,
        overlap_decode=args.overlap, fault_plan=args.fault_plan,
        max_step_retries=args.max_step_retries, retry_backoff_s=args.retry_backoff_s,
        slo_interactive_s=args.slo_interactive, slo_standard_s=args.slo_standard,
        slo_batch_s=args.slo_batch, interactive_reserve_slots=args.interactive_reserve_slots,
        interactive_reserve_blocks=args.interactive_reserve_blocks,
        overload_degrade=args.overload_degrade, overload_queue_hi=args.overload_queue_hi,
        overload_queue_lo=args.overload_queue_lo, overload_patience=args.overload_patience,
        overload_cooldown=args.overload_cooldown)


def parallel_config(args) -> ParallelConfig:
    return ParallelConfig(weight_quant=args.weight_quant, wq_group_size=args.wq_group_size,
                          tp=args.tp, dp=args.dp, topk_sync=not args.no_topk_sync)


def make_scheduler(eng: Engine, args):
    slot_kw = dict(n_slots=args.slots, block_steps=args.block_steps,
                   responsive_blocks=args.responsive_blocks)
    if args.scheduler == "disagg":
        return DisaggScheduler(eng, prefix_cache=not args.no_prefix_cache, **slot_kw)
    if args.scheduler == "paged":
        # block and pool sizes ride on ParallelConfig; the scheduler reads them
        return PagedContinuousScheduler(eng, prefix_cache=not args.no_prefix_cache, **slot_kw)
    if args.scheduler == "continuous":
        return ContinuousScheduler(eng, **slot_kw)
    return WaveScheduler(eng, batch_size=args.batch)


def add_weight_quant_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--weight-quant", choices=("none", "int8", "int4"), default="none",
                    help="weight-only quantization at load: int8 = per-output-column "
                         "scales, int4 = group-wise scales")
    ap.add_argument("--wq-group-size", type=int, default=128,
                    help="int4 group length along the reduction dim")


def add_tp_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--dp", type=int, default=1,
                    help="the data axis: N replicas of the --tp ranks (--dp x --tp processes), "
                         "each serving its share of the rows, slots and paged pool")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor parallelism over N ranks, one process each (1, 2, 4 or 8)")
    ap.add_argument("--dist-backend", choices=mesh.BACKENDS, default="gloo",
                    help="--tp or --dp > 1: nccl (one card a rank) or gloo (ranks may share a "
                         "card or run on the CPU; collectives staged through host memory)")
    ap.add_argument("--no-topk-sync", action="store_true",
                    help="gather the whole logits row before the top-k (the baseline of "
                         "paper section 2.1b)")


def weight_quant_line(cfg, args) -> str:
    """The JAX serve CLI's line: weight bytes one decode token sweeps,
    quantized against bf16."""
    wb = M.decode_weight_bytes(cfg, parallel_config(args))["swept"]
    bb = M.decode_weight_bytes(cfg)["swept"]
    tag = f"-g{args.wq_group_size}" if args.weight_quant == "int4" else ""
    return (f"weight quant {args.weight_quant}{tag}: {wb / 2**20:.1f} MiB swept/token vs "
            f"{bb / 2**20:.1f} MiB bf16 ({bb / max(wb, 1):.2f}x less)")


def disagg_lines(p: dict) -> list:
    """The JAX serve CLI's ``pools:``, ``migration:`` and ``migration
    wait`` report lines of a ``request_summary()["pools"]``."""
    lines = [f"  pools: {p['prefill_shards']} prefill + {p['decode_shards']} decode shards; "
             f"prefill occupancy {p['prefill_occupancy']:.0%} over {p['prefill_steps']} "
             f"chunk steps",
             f"  migration: {p['migrated_blocks']} blocks copied "
             f"({p['migration_bytes'] / 2**20:.1f} MiB), {p['migration_skipped_blocks']} "
             f"skipped via decode-side prefix hits, {p['handoffs']} handoffs, "
             f"{p['migration_deferrals']} deferrals"]
    if "migration_wait_s" in p:
        w = p["migration_wait_s"]
        lines.append(f"  migration wait p50/p95 {w['p50'] * 1e3:.1f}/{w['p95'] * 1e3:.1f} ms")
    return lines


def parse_class_mix(spec):
    """``interactive=0.25,standard=0.5,batch=0.25`` -> (classes,
    probabilities); None for an empty spec.  Weights are normalized, so
    ratios (``interactive=1,batch=3``) work too."""
    if not spec:
        return None
    classes, weights = [], []
    for item in spec.split(","):
        k, _, v = item.strip().partition("=")
        if k not in ("interactive", "standard", "batch"):
            raise ValueError(f"unknown priority class {k!r} in class mix")
        classes.append(k)
        weights.append(float(v) if v else 1.0)
    total = sum(weights)
    if total <= 0:
        raise ValueError("class mix weights must sum to > 0")
    return classes, [w / total for w in weights]


def submit_workload(sched, cfg, args) -> None:
    """The JAX serve CLI's workload, the same draws from the same seed: one
    shared prefix of ``--shared-prefix`` tokens, then per request a prompt
    length from [4, --prompt-len], a budget from [max_new // spread,
    max_new] when ``--max-new-spread`` > 1, and uniform token ids, (plen,
    ncb) frames for a multi-codebook arch, which takes no shared prefix;
    request i arrives at decode step i * ``--arrival-every``.  With
    ``--class-mix`` each request's class is drawn from a stream of its own,
    so the mix leaves the prompts and budgets as they were."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, args.shared_prefix).astype(np.int32)
    mix = parse_class_mix(getattr(args, "class_mix", ""))
    cls_rng = np.random.default_rng(0xC1A55) if mix else None
    for i in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        shape = (plen,) if cfg.n_codebooks == 1 else (plen, cfg.n_codebooks)
        max_new = args.max_new
        if args.max_new_spread > 1:
            max_new = int(rng.integers(max(1, args.max_new // args.max_new_spread),
                                       args.max_new + 1))
        prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        if args.shared_prefix and cfg.n_codebooks == 1:
            prompt = np.concatenate([shared, prompt])
        priority = mix[0][int(cls_rng.choice(len(mix[0]), p=mix[1]))] if mix else "standard"
        sched.submit(prompt, max_new=max_new, arrival_step=i * args.arrival_every,
                     priority=priority)


def build_parser(ap: argparse.ArgumentParser = None) -> argparse.ArgumentParser:
    """The engine and scheduler flags, shared with the HTTP frontend
    (``launch.frontend`` adds its server flags to them)."""
    if ap is None:
        ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=ALL_ARCHS)
    ap.add_argument("--list-archs", action="store_true",
                    help="print the architecture capability matrix (which serving paths "
                         "each registered arch supports, and what blocks the rest) and exit")
    ap.add_argument("--scheduler", choices=("wave", "continuous", "paged", "disagg"),
                    default="wave")
    ap.add_argument("--prefill-shards", type=int, default=1,
                    help="disagg scheduler: the first N data shards form "
                         "the prefill pool (prompts admit and chunk-prefill "
                         "there; finished KV blocks migrate to the decode "
                         "pool); needs dp >= 2")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="wave scheduler: requests per wave")
    ap.add_argument("--slots", type=int, default=4,
                    help="continuous/paged scheduler: fixed slot count")
    ap.add_argument("--block-steps", type=int, default=8,
                    help="continuous/paged scheduler: fused decode steps per host round trip")
    ap.add_argument("--responsive-blocks", action="store_true",
                    help="end fused blocks at the shortest active budget while requests "
                         "wait (fewer total steps, more dispatches)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="paged scheduler: tokens per KV block")
    ap.add_argument("--kv-pool-blocks", type=int, default=0,
                    help="paged scheduler: total pool blocks (0 = dense-equivalent footprint)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged scheduler: disable shared-prefix block reuse")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="continuous/paged: admit every prompt through the fused mixed "
                         "prefill/decode step in chunks of at most N tokens (decode "
                         "advances every step during admission); 0 = whole-prompt "
                         "admission; an arch that cannot chunk admits whole prompts")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="continuous/paged: speculative decoding, N n-gram drafts per "
                         "active slot verified in one step (1..N+1 tokens per step); "
                         "0 = plain one-token decode; an arch that cannot verify "
                         "chunks decodes plainly")
    ap.add_argument("--no-spec-decode", action="store_true",
                    help="force plain one-token decode even when --spec-k is set")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="longest n-gram the prompt-lookup drafter matches against "
                         "each request's history")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one common N-token system prompt to every request")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="request i arrives at decode step i*N (continuous/paged)")
    ap.add_argument("--max-new-spread", type=int, default=1,
                    help="draw each request's max_new from [max_new // N, max_new]")
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="longest prompt; lengths are drawn from [4, N]")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128, help="KV cache length")
    ap.add_argument("--top-k", type=int, default=40, help="1 = greedy")
    ap.add_argument("--full", action="store_true",
                    help="the arch at its published widths and depth "
                         "(default: the reduced smoke-test variant)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and of the sampling noise")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    add_tp_args(ap)
    add_weight_quant_args(ap)
    ap.add_argument("--wq-cache", default=None,
                    help="path for the packed weight checkpoint: load it when present "
                         "(no bf16 weights are drawn), else save it after quantizing "
                         "at load")
    add_control_plane_args(ap)
    return ap


def add_control_plane_args(ap: argparse.ArgumentParser) -> None:
    """Overlap, faults, priority classes and the degradation ladder of the
    continuous schedulers, and ``--stats-json`` (the JAX CLI's flags)."""
    ap.add_argument("--overlap", action="store_true",
                    help="continuous schedulers: overlapped host/device loop, decode block "
                         "N+1 dispatched on block N's device outputs while N's tokens land "
                         "on the host (greedy streams equal the blocking loop's)")
    ap.add_argument("--fault-plan", default="", metavar="SPEC",
                    help="deterministic fault injection (continuous schedulers): "
                         "';'-separated clauses, e.g. 'step:at=12;poison:slot=1,at=20;"
                         "alloc:at=8;delay:at=4,s=0.5' (repro_torch.runtime.faults has the "
                         "grammar).  Injured requests are quarantined (finish_reason "
                         "error); survivors' greedy streams equal a clean run's")
    ap.add_argument("--max-step-retries", type=int, default=3,
                    help="a transient step failure is retried this many times (exponential "
                         "backoff) from the exact pre-dispatch state before the blamed "
                         "request is quarantined")
    ap.add_argument("--retry-backoff-s", type=float, default=0.05,
                    help="base backoff before a step retry; doubles per consecutive failure")
    ap.add_argument("--class-mix", default="", metavar="SPEC",
                    help="per-request priority classes of the synthetic workload, drawn "
                         "from a weighted mix, e.g. 'interactive=0.25,standard=0.5,"
                         "batch=0.25' (empty = everything 'standard')")
    ap.add_argument("--slo-interactive", type=float, default=0.0, metavar="S",
                    help="interactive-class per-token SLO target in seconds (0 = unset); "
                         "reported as slo_attainment per class and read by the overload "
                         "ladder's latency signal")
    ap.add_argument("--slo-standard", type=float, default=0.0, metavar="S",
                    help="standard-class per-token SLO target (seconds)")
    ap.add_argument("--slo-batch", type=float, default=0.0, metavar="S",
                    help="batch-class per-token SLO target (seconds)")
    ap.add_argument("--interactive-reserve-slots", type=int, default=0,
                    help="slots held back for interactive requests: non-interactive "
                         "admission stops once free slots drop to this reserve")
    ap.add_argument("--interactive-reserve-blocks", type=int, default=0,
                    help="paged: KV pool blocks held back for interactive admissions")
    ap.add_argument("--overload-degrade", action="store_true",
                    help="the adaptive degradation ladder (shed batch -> suspend spec "
                         "decode -> tighten admission), walked with hysteresis from queue "
                         "depth and landed inter-token latency; see "
                         "repro_torch.runtime.overload")
    ap.add_argument("--overload-queue-hi", type=int, default=0,
                    help="queue depth that counts as pressure (0 = auto: 2x slots)")
    ap.add_argument("--overload-queue-lo", type=int, default=0,
                    help="queue depth that counts as clear (0 = auto: slots/2)")
    ap.add_argument("--overload-patience", type=int, default=3,
                    help="consecutive pressured rounds before escalating one ladder level")
    ap.add_argument("--overload-cooldown", type=int, default=6,
                    help="consecutive clear rounds before restoring one ladder level")
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="dump the scheduler's request_summary() and raw stats counters "
                         "(overlap, faults, classes, ladder) as JSON to PATH")


def _jsonable(obj):
    """numpy scalars and arrays -> what json.dump takes, recursively."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def dump_stats_json(sched, path, extra=None) -> dict:
    """Write ``request_summary()`` and the raw stats counters to ``path``."""
    payload = {"request_summary": _jsonable(sched.request_summary()),
               "stats": _jsonable(sched.stats)}
    if extra:
        payload.update(_jsonable(extra))
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return payload


def main(argv=None):
    """Serve; -> the finished requests (world rank 0's over more than one
    rank)."""
    args = build_parser().parse_args(argv)
    if args.list_archs:
        print(render_text())
        return []
    if args.tp == 1 and args.dp == 1:
        return _serve(Dist(), None, args)
    # refuse what the ranks would (wq_cache at tp > 1, kv_seq_shard's
    # layers, splits) before spawning
    M.check_supported(get_config(args.arch), engine_parallel(args), wq_cache=args.wq_cache)
    mesh.check_backend(args.dp * args.tp, args.dist_backend, args.device)
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build_all()          # once, before the ranks load the libraries
    return mesh.spawn(_serve, args.tp, args, backend=args.dist_backend,
                      device=args.device, dp=args.dp)[0]


def _serve(dist: Dist, device, args):
    """One rank's run (the only one at tp = dp = 1): world rank 0 prints."""
    eng = build_engine(args, dist, device)
    talk = dist.world_rank == 0
    if args.weight_quant != "none" and talk:
        print(weight_quant_line(eng.cfg, args))
    sched = make_scheduler(eng, args)
    submit_workload(sched, eng.cfg, args)
    t0 = time.monotonic()
    try:
        sched.run()
    finally:
        # the report and --stats-json flush even when the run raised: done
        # holds what retired so far, so a crashed chaos run keeps its counters
        if talk:
            _report(sched, eng.cfg, args, time.monotonic() - t0)
    return sched.done


def _report(sched, cfg, args, dt: float) -> None:
    done = sched.done
    total_tokens = sum(len(r.output) for r in done if r.output is not None)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s -> {1000 * dt / max(total_tokens, 1):.1f} ms/token "
          f"({args.scheduler}; arch={cfg.name}, tp={args.tp}, "
          + (f"dp={args.dp}, " if args.dp > 1 else "") + f"device={args.device}"
          + (f", {args.dist_backend}" if args.tp * args.dp > 1 else "") + ")")
    if args.scheduler != "wave":
        s = sched.stats
        lat = sched.request_summary()
        print(f"  decode steps {s['decode_steps']}, slot util "
              f"{s['active_slot_steps'] / max(1, s['slot_steps']):.0%}, admission rounds "
              f"{s['admission_rounds']} ({s['in_flight_admissions']} requests admitted in-flight)")
        if "ttft_s" in lat:
            print(f"  ttft mean {lat['ttft_s']['mean'] * 1e3:.0f} ms (p50 "
                  f"{lat['ttft_s']['p50'] * 1e3:.0f}, max {lat['ttft_s']['max'] * 1e3:.0f}); "
                  f"queue mean {lat['queue_s']['mean'] * 1e3:.0f} ms")
        if s["prefill_chunks"]:
            print(f"  chunked prefill: {s['chunked_admissions']} requests in more than one "
                  f"chunk, {s['prefill_chunks']} chunks of <= {sched.chunk} tokens, "
                  f"{s['mixed_decode_steps']} decode steps during admission")
        if "spec" in lat:
            sp = lat["spec"]
            print(f"  spec decode (k={sched.spec_k}, ngram<={sched.spec_ngram}): acceptance "
                  f"{sp['acceptance_rate']:.0%}, {sp['mean_tokens_per_step']:.2f} tokens "
                  f"per verify step and slot")
        if "decode_itl_s" in lat:
            itl = lat["decode_itl_s"]
            print(f"  decode inter-token p50/p95 {itl['p50'] * 1e3:.1f}/{itl['p95'] * 1e3:.1f} ms")
        if "faults" in lat:
            fc = lat["faults"]
            print(f"  faults: {fc['step_faults']} step faults ({fc['step_retries']} retried), "
                  f"{fc['quarantined']} quarantined, {fc['timeouts']} timeouts, "
                  f"{fc['aborts_exhaustion']} exhaustion aborts; finish_reasons "
                  f"{lat['finish_reasons']}")
        for name, c in lat.get("classes", {}).items():
            line = (f"  class {name}: {c.get('served', 0)} served, {c.get('shed', 0)} shed, "
                    f"{c.get('timeout', 0)} timed out")
            if "itl_s" in c:
                line += f"; itl p50/p95 {c['itl_s']['p50'] * 1e3:.1f}/{c['itl_s']['p95'] * 1e3:.1f} ms"
            if "slo_attainment" in c:
                line += f"; SLO {c['slo_attainment']:.0%} @ {c['slo_target_s'] * 1e3:.0f} ms/token"
            print(line)
        if "overload" in lat:
            ov = lat["overload"]
            print(f"  overload ladder: level {ov['level']} ({ov['level_name']}), peak "
                  f"{ov['max_level_name']}, {ov['escalations']} escalations / "
                  f"{ov['restorations']} restorations")
        ov = lat["overlap"]
        print(f"  host blocked {ov['host_blocked_s']:.3f}s ({ov['host_blocked_per_step_s'] * 1e3:.2f} "
              f"ms/step)" + (f", overlapped {ov['host_overlap_s']:.3f}s, {ov['landings']} "
                             f"landings, dispatch-ahead max {ov['max_dispatch_ahead']}, eos "
                             f"rollbacks {ov['eos_rollbacks']}" if ov["enabled"] else ""))
    if args.scheduler in ("paged", "disagg"):
        s = sched.stats
        print(f"  pool {sched.n_blocks} x {sched.bs}-token blocks, high-water "
              f"{s['blocks_hwm']} blocks; prefill tokens {s['prefill_tokens']} "
              f"(+{s['prefill_tokens_saved']} reused, {s['shared_block_hits']} shared block "
              f"hits), preemptions {s['preemptions']}")
    if args.scheduler == "disagg":
        for line in disagg_lines(sched.request_summary()["pools"]):
            print(line)
    for r in done[:4]:
        if r.output is not None:
            print(f"  req {r.rid}: {len(r.output)} tokens, first 8: {r.output[:8].tolist()}")
    if args.stats_json:
        if args.scheduler == "wave":
            print("  --stats-json needs a continuous scheduler; skipping")
        else:
            dump_stats_json(sched, args.stats_json,
                            extra={"wall_s": dt, "total_tokens": total_tokens,
                                   "scheduler": args.scheduler, "arch": cfg.name})
            print(f"  stats -> {args.stats_json}")


if __name__ == "__main__":
    main()
