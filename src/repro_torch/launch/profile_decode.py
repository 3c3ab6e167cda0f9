"""Where a decode step's time goes, on the card:

    python -m repro_torch.launch.profile_decode --arch yi-9b --batch 4
    python -m repro_torch.launch.profile_decode --arch qwen-72b --weight-quant int4
    python -m repro_torch.launch.profile_decode --scheduler paged
    python -m repro_torch.launch.profile_decode --scheduler continuous --step verify
    python -m repro_torch.launch.profile_decode --scheduler paged --step mixed
    python -m repro_torch.launch.profile_decode --arch recurrentgemma-9b
    python -m repro_torch.launch.profile_decode --arch gptj-parallel
    python -m repro_torch.launch.profile_decode --arch minicpm3-4b
    python -m repro_torch.launch.profile_decode --arch deepseek-moe-16b --weight-quant int4
    python -m repro_torch.launch.profile_decode --arch qwen-72b --weight-quant int4 \
        --kv-quant --prompt-len 2950 --max-len 4096
    python -m repro_torch.launch.profile_decode --arch internvl2-26b
    python -m repro_torch.launch.profile_decode --arch musicgen-medium --scheduler continuous
    python -m repro_torch.launch.profile_decode --tp 2       # ranks share the card over gloo
    python -m repro_torch.launch.profile_decode --arch deepseek-moe-16b --tp 2 --layers 14
    python -m repro_torch.launch.profile_decode --arch mamba2-1.3b --tp 2 --layers 8

Builds the arch at full width from random weights, prefills one wave (or,
with ``--scheduler continuous|paged``, admits ``--batch`` prompts into the
slots of a dense or paged slot cache) and then runs the same ``--steps``
decode steps (same first token, same cache positions) twice: plain, for
the host wall time and CUDA-event time per step, and under
``torch.profiler``, for the device time by kernel.  The slot engine runs
the steps as one ``decode_slots`` block, which ends in its host copy.
``--step verify`` runs spec-decode verify steps instead (every slot
verifies SPEC_K drafts that repeat its last token), ``--step mixed`` fused
mixed steps (slot 0 prefills a CHUNK-token chunk while the others decode
one token); each is one engine call with its own host copy, from the same
state every time.  SPEC_K and CHUNK are those of chip_smoke.py's chunked
spec phases.  A sliding-window arch (recurrentgemma-9b) prefills
window + 64 tokens by default in a wave, so its decode steps run over a
ring that has wrapped, and window - 8 into a slot (admission caps prompts
at the window), so its steps cross the window.  A frontend arch
(internvl2-26b, musicgen-medium) prefills its prefix of zero features
before each prompt, musicgen-medium's prompts are (prompt_len, 4) codebook
frames and its steps sample a frame, and the paths its capability record
blocks (paged, verify, mixed) raise its error.  The wave path also profiles the same
prefill once more, into the same cache, and reports its wall time and the device time
of its lru_scan, flash_prefill and fused_dual_matmul launches.  The
device's idle share divides the profiled pass's device time by the plain
pass's wall time (the profiler slows the host, so its own window overstates
idleness); the profiled window's share is printed beside it.  Prints one
JSON line (step times, device busy time per step, idle shares, kernel
launches per step, the top kernels, and the device time of the
dequant_matmul kernels and of the w_o dense copies under weight
quantization, of the fused_dual_matmul kernels of a parallel-residual
arch, of the dense and paged decode_attention kernels and, with
``--kv-quant`` (the int8 KV cache), of the kv_quant_write kernel; of an MLA
arch's latent attention, which runs in plain PyTorch, of an MoE arch's
routing/dispatch/combine bookkeeping and expert matmuls, and of an SSD
arch's recurrence (plain PyTorch), each a profiler range), the peak
device memory and the cache's bytes, and the profiler's table.  An MLA
arch's latent cache stays bf16 whatever ``--kv-quant`` says, and the
line's ``kv_cache`` says which cache ran.

``--tp N`` runs N ranks (``launch/mesh.py``, ``--dist-backend``; gloo lets
them share one card, its collectives staged through host memory), each
profiling its own shard; rank 0 reports, with its collectives of one pass
of the steps (``comm_per_step``: count and wire bytes by tag) beside its
kernel times.  Ranks that share a card share its time: their step times
are no tensor-parallel speed.  ``--layers N`` cuts the arch to its first N
layers, at full width, as chip_smoke.py's cut-depth phases run it (phase
9's RG-LRU, MoE, MLA, SSD and musicgen-medium jobs: their ``comm`` a
decode step is this line's ``comm_per_step`` at the same depth; an SSD
arch's ``ssd_scan_ms_per_step`` is then a rank's, over its heads).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, SamplingConfig, get_config
from repro_torch.core import collectives as cc
from repro_torch.core.zero_copy import W_O_DENSE_RANGE
from repro_torch.launch import mesh
from repro_torch.launch.serve import add_tp_args, add_weight_quant_args, parallel_config
from repro_torch.models.common import Dist
from repro_torch.models.mla import MLA_RANGE
from repro_torch.models.moe import DISPATCH_RANGE, EXPERTS_RANGE
from repro_torch.models.ssm import SSD_RANGE
from repro_torch.runtime import kvcache
from repro_torch.runtime.engine import Engine

SPEC_K, CHUNK = 4, 64     # --step verify: drafts per slot; --step mixed: slot 0's chunk
# user ranges whose device time the line reports per step, by its key
RANGES = {"w_o_dense_copy": W_O_DENSE_RANGE, "mla_latent_attention": MLA_RANGE,
          "moe_dispatch": DISPATCH_RANGE, "moe_experts": EXPERTS_RANGE,
          "ssd_scan": SSD_RANGE}

def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=ALL_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="default 128; for a sliding-window arch window + 64 (wave) "
                         "or window - 8 (slots)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to its first N layers (0: all of them)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="default the larger of 256 and what the prompt and the steps need")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", choices=("wave", "continuous", "paged"), default="wave",
                    help="decode through the wave cache, or the slot engine over the dense "
                         "slot cache or the paged pool")
    ap.add_argument("--step", choices=("decode", "verify", "mixed"), default="decode",
                    help="slot engine: profile masked decode steps, spec-decode verify "
                         "steps or fused mixed chunk/decode steps")
    add_weight_quant_args(ap)
    add_tp_args(ap)
    ap.add_argument("--kv-quant", action="store_true",
                    help="the int8 KV cache (ParallelConfig.kv_quant)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.prompt_len is None:
        args.prompt_len = (128 if not cfg.window else
                           cfg.window + 64 if args.scheduler == "wave" else cfg.window - 8)
    prefix = cfg.frontend.prefix_len if cfg.frontend is not None else 0
    if args.max_len is None:
        args.max_len = max(256, prefix + args.prompt_len + 3 + args.steps)
    if prefix + args.prompt_len + 3 + args.steps > args.max_len:
        ap.error("--max-len must hold the prefix, the prompt, 3 warm-up steps and --steps")
    if args.step != "decode" and args.scheduler == "wave":
        ap.error("--step verify|mixed runs on the slot engine (--scheduler continuous|paged)")
    if args.dp != 1:
        ap.error("--dp: the profile times one replica's decode step (profile at --dp 1)")
    if args.tp == 1:
        return _profile(Dist(), "cuda", cfg, args)
    from repro_torch.kernels import build
    build.build_all()          # once, before the ranks load the libraries
    return mesh.spawn(_profile, args.tp, cfg, args, backend=args.dist_backend)[0]


def _profile(dist: Dist, device, cfg, args) -> dict:
    """One rank's profile (the only one at tp=1); rank 0 prints."""
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, parallel=dataclasses.replace(parallel_config(args), kv_quant=args.kv_quant),
                 sampling=SamplingConfig(top_k=1), max_len=args.max_len, seed=args.seed,
                 device=device, dist=dist)
    if args.scheduler == "paged":
        eng.caps.require("paged")
    if args.step != "decode":
        eng.caps.require("spec" if args.step == "verify" else "chunked")
    frame = () if cfg.n_codebooks == 1 else (cfg.n_codebooks,)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len, *frame))
    prefill = None
    with torch.inference_mode():
        if args.scheduler == "wave":
            caches = eng.init_caches(args.batch)
            tok = eng.prefill(torch.as_tensor(prompts, device=eng.device), caches,
                              eng.zero_features(args.batch))
            prefill = _profile_prefill(eng, prompts, caches)
            cur = eng.prefix + args.prompt_len
            for _ in range(3):                        # warm-up
                tok = eng.decode(tok, caches, cur)
                cur += 1

            def steps():       # the same steps each time: cache positions cur..
                t = tok
                for i in range(args.steps):
                    t = eng.decode(t, caches, cur + i)
        else:
            steps, caches = _slot_steps(eng, args, prompts)
            steps()                                   # warm-up
        torch.cuda.synchronize()

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        steps()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        event_ms = start.elapsed_time(end)

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t1 = time.perf_counter()
            steps()
            torch.cuda.synchronize()
            prof_wall_s = time.perf_counter() - t1
        with cc.comm_stats() as comm:
            steps()
    avgs = prof.key_averages()
    # device-side events only: an operator's own entry repeats its kernels'
    # time, and so does the device-side copy of a user range
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in avgs if e.device_type == cuda and e.key not in RANGES.values()]
    device_us = sum(e.self_device_time_total for e in device)
    kernels = [e for e in device if not e.key.startswith(("Memcpy", "Memset"))]
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    dq_us = sum(e.self_device_time_total for e in kernels if "::dq_" in e.key)
    fdm = [e for e in kernels if "fdm::" in e.key]
    dec = [e for e in kernels if "decode::kernel" in e.key]
    kvq = [e for e in kernels if "kvq::" in e.key]
    range_ms = {name: sum(e.device_time_total for e in avgs
                          if e.key == key and e.device_type != cuda) / 1e3 / args.steps
                for name, key in RANGES.items()}
    result = {
        "arch": cfg.name, "scheduler": args.scheduler, "step": args.step,
        "spec_k": SPEC_K if args.step == "verify" else 0,
        "prefill_chunk": CHUNK if args.step == "mixed" else 0,
        "weight_quant": args.weight_quant, "kv_quant": "k_scale" in caches,
        "kv_cache": "int8" if "k_scale" in caches else "bf16",
        "wq_group_size": args.wq_group_size, "batch": args.batch, "prompt_len": args.prompt_len,
        "steps": args.steps, "device": torch.cuda.get_device_name(0),
        "tp": dist.tp, "dist_backend": args.dist_backend if dist.tp > 1 else None,
        "comm_per_step": {tag: {k: v / args.steps for k, v in e.items()}
                          for tag, e in comm.by_tag().items()},
        "step_ms_wall": 1e3 * wall_s / args.steps,
        "step_ms_events": event_ms / args.steps,
        "host_enqueue_ms_per_step": 1e3 * enqueue_s / args.steps,
        "profiled_step_ms_wall": 1e3 * prof_wall_s / args.steps,
        "device_busy_ms_per_step": device_us / 1e3 / args.steps,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "device_idle_share": 1 - device_us / 1e6 / wall_s,
        "device_idle_share_profiled_window": 1 - device_us / 1e6 / prof_wall_s,
        "dequant_matmul_ms_per_step": dq_us / 1e3 / args.steps,
        **{f"{name}_ms_per_step": ms for name, ms in range_ms.items()},
        "fused_dual_matmul_ms_per_step": sum(e.self_device_time_total for e in fdm) / 1e3
                                         / args.steps,
        "fused_dual_matmul_launches_per_step": sum(e.count for e in fdm) / args.steps,
        "decode_attention_ms_per_step": sum(e.self_device_time_total for e in dec) / 1e3
                                        / args.steps,
        "decode_attention_launches_per_step": sum(e.count for e in dec) / args.steps,
        "kv_quant_write_ms_per_step": sum(e.self_device_time_total for e in kvq) / 1e3
                                      / args.steps,
        "kv_quant_write_launches_per_step": sum(e.count for e in kvq) / args.steps,
        "cache_gib": kvcache.cache_bytes(caches) / 2**30,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / args.steps
                                    for e in top},
        "top_kernels_calls_per_step": {e.key[:80]: e.count / args.steps for e in top},
        "wave_prefill": prefill,
    }
    if dist.rank == 0:
        print(json.dumps(result))
        print(avgs.table(sort_by="self_device_time_total", row_limit=25))
    return result


def _profile_prefill(eng: Engine, prompts: np.ndarray, caches) -> dict:
    """The same wave prefill of ``prompts`` once more, into the same cache
    (it writes the same bytes; no second cache, which qwen-72b's 4 x 4096
    tokens would not leave room for), under the profiler: its wall time and
    the device time and launches of its kernels by family (``lru::`` the
    lru_scan kernel, ``prefill::`` the flash_prefill body)."""
    tokens = torch.as_tensor(prompts, device=eng.device)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.prefill(tokens, caches, eng.zero_features(len(prompts)))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.key_averages() if e.device_type == cuda
              and e.key not in RANGES.values()]
    fam = lambda tag: [e for e in device if tag in e.key]
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_ms": 1e3 * wall_s,
            "device_busy_ms": sum(e.self_device_time_total for e in device) / 1e3,
            "lru_scan_ms": sum(e.self_device_time_total for e in fam("lru::")) / 1e3,
            "lru_scan_launches": sum(e.count for e in fam("lru::")),
            "flash_prefill_ms": sum(e.self_device_time_total for e in fam("prefill::")) / 1e3,
            "flash_prefill_launches": sum(e.count for e in fam("prefill::")),
            "fused_dual_matmul_ms": sum(e.self_device_time_total for e in fam("fdm::")) / 1e3,
            "fused_dual_matmul_launches": sum(e.count for e in fam("fdm::")),
            "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3 for e in top}}


def _slot_steps(eng: Engine, args, prompts: np.ndarray):
    """Admit every prompt into its own slot (paged: slot b owns pool blocks
    1 + b*nbps ..), and return a function that runs the same ``--steps``
    masked decode steps from there as one ``decode_slots`` block, or
    ``--steps`` verify or mixed steps from there (``--step``), and the
    cache."""
    B, plen = prompts.shape[:2]
    admit, plens = np.ones(B, bool), np.full(B, plen)
    bt = None
    if args.scheduler == "paged":
        bs = eng.parallel.kv_block_size
        nbps = -(-args.max_len // bs)
        caches = eng.init_paged_caches(B, B * nbps + 1, bs)
        bt = (1 + np.arange(B * nbps, dtype=np.int32)).reshape(B, nbps)
        tok = eng.prefill_into_slots_paged(caches, prompts, admit, plens, np.zeros(B), plens, bt)
    else:
        caches = eng.init_slot_caches(B)
        tok = eng.prefill_into_slots(caches, prompts, admit, plens)
    state = (tok, plens + eng.prefix, np.zeros(B, bool), np.full(B, args.max_len),
             np.full(B, -1))
    if args.step == "verify":
        vtok = np.repeat(tok[:, None], SPEC_K + 1, axis=1)

        def steps():
            for _ in range(args.steps):
                eng.verify_slots(caches, vtok, *state[1:], block_tables=bt)
    elif args.step == "mixed":
        C = CHUNK
        admit = np.arange(B) == 0
        ctok = np.zeros((B, C), np.int32)
        ctok[0] = np.resize(prompts[0], C)
        clens, starts = np.where(admit, C, 1), np.zeros(B, np.int32)
        mixed_state = (tok, plens, admit, np.where(admit, 0, args.max_len), np.full(B, -1))

        def steps():
            for _ in range(args.steps):
                eng.mixed_step(caches, ctok, admit, clens, starts, clens, *mixed_state,
                               block_tables=bt)
    else:
        def steps():
            eng.decode_slots(caches, *state, n=args.steps, block_tables=bt)
    return steps, caches


if __name__ == "__main__":
    main()
