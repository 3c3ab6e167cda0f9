"""Where a decode step's time goes, on the card:

    python -m repro_torch.launch.profile_decode --arch yi-9b --batch 4
    python -m repro_torch.launch.profile_decode --arch qwen-72b --weight-quant int4

Builds the arch at full width from random weights, prefills one wave and
then runs the same ``--steps`` decode steps (same first token, same cache
positions) twice: plain, for the host wall time and CUDA-event time per
step, and under ``torch.profiler``, for the device time by kernel.  The
device's idle share divides the profiled pass's device time by the plain
pass's wall time (the profiler slows the host, so its own window overstates
idleness); the profiled window's share is printed beside it.  Prints one
JSON line (step times, device busy time per step, idle shares, kernel
launches per step, the top kernels, and the device time of the
dequant_matmul kernels and of the w_o dense copies under weight
quantization) and the profiler's table.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, SamplingConfig, get_config
from repro_torch.core.zero_copy import W_O_DENSE_RANGE
from repro_torch.launch.serve import add_weight_quant_args, parallel_config
from repro_torch.runtime.engine import Engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=ALL_ARCHS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    add_weight_quant_args(ap)
    args = ap.parse_args(argv)
    if args.prompt_len + 3 + args.steps > args.max_len:
        ap.error("--max-len must hold the prompt, 3 warm-up steps and --steps")

    cfg = get_config(args.arch)
    eng = Engine(cfg, parallel=parallel_config(args), sampling=SamplingConfig(top_k=1),
                 max_len=args.max_len, seed=args.seed, device="cuda")
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    caches = eng.init_caches(args.batch)
    with torch.inference_mode():
        tok = eng.prefill(torch.as_tensor(prompts, device=eng.device), caches)
        cur = args.prompt_len
        for _ in range(3):                        # warm-up
            tok = eng.decode(tok, caches, cur)
            cur += 1
        torch.cuda.synchronize()

        def steps():       # the same steps each time: cache positions cur..
            t = tok
            for i in range(args.steps):
                t = eng.decode(t, caches, cur + i)

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
    avgs = prof.key_averages()
    # device-side events only: an operator's own entry repeats its kernels'
    # time, and so does the device-side copy of a user range
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in avgs if e.device_type == cuda and e.key != W_O_DENSE_RANGE]
    device_us = sum(e.self_device_time_total for e in device)
    kernels = [e for e in device if not e.key.startswith(("Memcpy", "Memset"))]
    top = sorted(device, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    dq_us = sum(e.self_device_time_total for e in kernels if "::dq_" in e.key)
    w_o_us = sum(e.device_time_total for e in avgs
                 if e.key == W_O_DENSE_RANGE and e.device_type != cuda)
    result = {
        "arch": cfg.name, "weight_quant": args.weight_quant,
        "wq_group_size": args.wq_group_size, "batch": args.batch, "prompt_len": args.prompt_len,
        "steps": args.steps, "device": torch.cuda.get_device_name(0),
        "step_ms_wall": 1e3 * wall_s / args.steps,
        "step_ms_events": event_ms / args.steps,
        "host_enqueue_ms_per_step": 1e3 * enqueue_s / args.steps,
        "profiled_step_ms_wall": 1e3 * prof_wall_s / args.steps,
        "device_busy_ms_per_step": device_us / 1e3 / args.steps,
        "kernel_launches_per_step": sum(e.count for e in kernels) / args.steps,
        "device_idle_share": 1 - device_us / 1e6 / wall_s,
        "device_idle_share_profiled_window": 1 - device_us / 1e6 / prof_wall_s,
        "dequant_matmul_ms_per_step": dq_us / 1e3 / args.steps,
        "w_o_dense_copy_ms_per_step": w_o_us / 1e3 / args.steps,
        "top_kernels_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / args.steps
                                    for e in top},
        "top_kernels_calls_per_step": {e.key[:80]: e.count / args.steps for e in top},
    }
    print(json.dumps(result))
    print(avgs.table(sort_by="self_device_time_total", row_limit=25))
    return result


if __name__ == "__main__":
    main()
