"""Serving entry point: ``python -m repro_torch.launch.serve --arch yi-9b``.

Serves a batch of synthetic requests through the wave scheduler on one
device and reports per-token latency (the paper's section 3 metric).
Weights are random, drawn on the device from ``--seed``; with
``--weight-quant int8|int4`` they are quantized as they are drawn and every
projection and the lm_head go through the dequant_matmul kernel.  Runs on
the card unless ``--device cpu`` is given, where the kernels' plain
versions run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ALL_ARCHS, ParallelConfig, SamplingConfig, get_config
from repro_torch.models import model as M
from repro_torch.runtime.engine import Engine
from repro_torch.runtime.scheduler import WaveScheduler


def build_engine(args) -> Engine:
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    return Engine(cfg, parallel=parallel_config(args),
                  sampling=SamplingConfig(top_k=args.top_k), max_len=args.max_len,
                  seed=args.seed, device=args.device)


def parallel_config(args) -> ParallelConfig:
    return ParallelConfig(weight_quant=args.weight_quant, wq_group_size=args.wq_group_size)


def add_weight_quant_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--weight-quant", choices=("none", "int8", "int4"), default="none",
                    help="weight-only quantization at load: int8 = per-output-column "
                         "scales, int4 = group-wise scales")
    ap.add_argument("--wq-group-size", type=int, default=128,
                    help="int4 group length along the reduction dim")


def weight_quant_line(cfg, args) -> str:
    """The JAX serve CLI's line: weight bytes one decode token sweeps,
    quantized against bf16."""
    wb = M.decode_weight_bytes(cfg, parallel_config(args))["swept"]
    bb = M.decode_weight_bytes(cfg)["swept"]
    tag = f"-g{args.wq_group_size}" if args.weight_quant == "int4" else ""
    return (f"weight quant {args.weight_quant}{tag}: {wb / 2**20:.1f} MiB swept/token vs "
            f"{bb / 2**20:.1f} MiB bf16 ({bb / max(wb, 1):.2f}x less)")


def submit_workload(sched: WaveScheduler, cfg, args) -> None:
    """The JAX serve CLI's workload: prompt lengths drawn from [4, --prompt-len],
    token ids uniform over the vocab, from a fixed generator."""
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, (plen,)).astype(np.int32)
        sched.submit(prompt, max_new=args.max_new)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=ALL_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="requests per wave")
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
    add_weight_quant_args(ap)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    eng = build_engine(args)
    if args.weight_quant != "none":
        print(weight_quant_line(eng.cfg, args))
    sched = WaveScheduler(eng, batch_size=args.batch)
    submit_workload(sched, eng.cfg, args)
    t0 = time.monotonic()
    sched.run()
    _report(sched, eng.cfg, args, time.monotonic() - t0)
    return sched.done


def _report(sched, cfg, args, dt: float) -> None:
    done = sched.done
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s -> {1000 * dt / max(total_tokens, 1):.1f} ms/token "
          f"(wave; arch={cfg.name}, tp=1, device={args.device})")
    for r in done[:4]:
        print(f"  req {r.rid}: {len(r.output)} tokens, first 8: {r.output[:8].tolist()}")


if __name__ == "__main__":
    main()
