#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: needs CUDA; prints the card's name and power limit;
2. build: compiles every CUDA kernel of ``src/repro_torch/kernels/csrc``
   with nvcc (one process per source, all at once);
3. kernels: each kernel at the full-width shapes of the serving paths
   (attention and top-k at yi-9b; dequant_matmul at yi-9b int8 and
   qwen-72b int4, decode and prefill widths), against its plain PyTorch
   version on the same inputs (stated tolerance), with its time, the plain
   version's, one PyTorch library call's for the same function (a yardstick
   the port never calls) and the least time the card could take (bytes at
   3.35 TB/s or operations at the peak of their type, whichever is larger);
4. reference: a small GQA model on the card (kernels) against the same
   model on the CPU (plain versions), in bf16, int8 and int4 weights:
   prefill and 8 decode-step logits;
5. serve: three full-width models with random weights from a seed, each
   through the port's WaveScheduler: yi-9b in bf16 and in int8 (48
   layers), qwen-72b in int4 (80 layers).  Each serves 8 requests in waves
   of 4, greedy, 32 new tokens each; tokens in range, a second run
   identical, and every kernel's launch count as the path predicts it.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
hold the kernels' JSON and one serve JSON line per phase.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
L2_FLUSH_BYTES = 128 * 2**20  # > the 50 MB L2: each timed launch starts cold

# yi-9b at full width: 32 q heads over 4 KV heads, head_dim 128, vocab 64000
B, HQ, HKV, HD, VOCAB = 4, 32, 4, 128, 64000
PREFILL_S, DECODE_S, DECODE_VALID = 128, 512, 300
SERVE_REQUESTS, SERVE_BATCH, SERVE_MAX_NEW, SERVE_MAX_LEN = 8, 4, 32, 256
# (arch, weight_quant) of the serve phases, in order
SERVE_PHASES = (("yi-9b", "none"), ("yi-9b", "int8"), ("qwen-72b", "int4"))
# dequant_matmul cases: (what, mode, T, K, N, out dtype); the first is the
# int4 qwen-72b decode hot path and heads the kernels line
DQ_CASES = (("qwen-72b w_up int4, decode", "int4", B, 8192, 24576, torch.bfloat16),
            ("yi-9b w_up int8, decode", "int8", B, 4096, 11008, torch.bfloat16),
            ("qwen-72b lm_head int4, decode", "int4", B, 8192, 151936, torch.float32),
            ("qwen-72b w_down int4, prefill", "int4", 512, 24576, 8192, torch.bfloat16))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cold_ms(fn, flush: torch.Tensor, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of fn() in ms by CUDA events around each call, the
    L2 flushed before each (as the serving path finds it after a layer's
    weight sweep).  The device first sleeps while the host queues every
    call, so host-side launch cost does not show up as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)   # ~0.1 s of GPU clock cycles
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(n_bytes: float, ops: float, peak: float) -> dict:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernels(dev, flush) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    out = []

    # flash prefill: one wave's prompt attention of one layer
    q = rnd(B, HQ, PREFILL_S, HD).bfloat16()
    k, v = rnd(B, HKV, PREFILL_S, HD).bfloat16(), rnd(B, HKV, PREFILL_S, HD).bfloat16()
    q_pos = torch.arange(PREFILL_S, device=dev, dtype=torch.int32).expand(B, -1).contiguous()
    scale = HD ** -0.5
    got = ops.flash_prefill(q, k, v, q_pos, scale)
    want = ref.flash_prefill_ref(q, k, v, q_pos, scale)
    err = (got.float() - want.float()).abs().max().item()
    tol = 3e-2
    if not err <= tol:
        fail(f"flash_prefill differs from its plain version by {err} > {tol}")
    pairs = (q_pos.long() + 1).clamp(max=PREFILL_S).sum().item() * HQ
    out.append({
        "name": "flash_prefill", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/prefill_attention.py:114",
        "counter": "flash_prefill",
        "shape": f"q ({B},{HQ},{PREFILL_S},{HD}) bf16, k/v ({B},{HKV},{PREFILL_S},{HD}), causal",
        "max_abs_err": err, "tolerance": tol,
        "ms": cold_ms(lambda: ops.flash_prefill(q, k, v, q_pos, scale), flush),
        "plain_ms": cold_ms(lambda: ref.flash_prefill_ref(q, k, v, q_pos, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), flush),
        **bound(2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * q_pos.numel(),
                4 * HD * pairs, BF16_FLOPS),
    })

    # decode attention: one decode step of one layer over a part-filled cache
    q = rnd(B, HQ, 1, HD).bfloat16()
    k, v = rnd(B, HKV, DECODE_S, HD).bfloat16(), rnd(B, HKV, DECODE_S, HD).bfloat16()
    valid = torch.arange(DECODE_S, device=dev) < DECODE_VALID
    m, l, acc = ops.decode_attention_partial(q, k, v, valid, scale)
    m2, l2, acc2 = ref.decode_attention_ref(q, k, v, valid, scale)
    o, o2 = acc / l[..., None], acc2 / l2[..., None]
    err = max((o - o2).abs().max().item(), (m - m2).abs().max().item())
    l_rel = ((l - l2).abs() / l2).max().item()
    tol = 1e-3
    if not (err <= tol and l_rel <= 1e-4):
        fail(f"decode_attention differs from its plain version: {err} (tol {tol}), "
             f"l relative {l_rel} (tol 1e-4)")
    mask = valid[None, None, None, :]
    out.append({
        "name": "decode_attention_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:66",
        "counter": "decode_attention",
        "shape": f"q ({B},{HQ},1,{HD}) bf16, k/v ({B},{HKV},{DECODE_S},{HD}), "
                 f"{DECODE_VALID} valid",
        "max_abs_err": err, "tolerance": tol,
        "ms": cold_ms(lambda: ops.decode_attention_partial(q, k, v, valid, scale), flush),
        "plain_ms": cold_ms(lambda: ref.decode_attention_ref(q, k, v, valid, scale), flush),
        "library_ms": cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True), flush),
        # bytes: only the K/V rows the mask keeps need reading
        **bound(2 * (q.numel() + 2 * B * HKV * DECODE_VALID * HD) + valid.numel()
                + 4 * (m.numel() + l.numel() + acc.numel()),
                4 * HD * B * HQ * DECODE_VALID, BF16_FLOPS),
    })

    # top-k over the fp32 logits: k = 1 is the greedy path the serve phase
    # runs; k = 40 (the serve CLI's default) is checked and timed beside it
    x = rnd(B, VOCAB)
    entry = None
    for kk in (1, 40):
        vals, idx = ops.topk(x, kk)
        rv, ri = ref.topk_ref(x, kk)
        err = (vals - rv).abs().max().item()
        if not (err == 0 and torch.equal(idx, ri)):
            fail(f"topk k={kk} differs from its plain version (value error {err}, "
                 f"indices equal {torch.equal(idx, ri)})")
        timed = {
            "max_abs_err": err, "tolerance": 0.0,
            "ms": cold_ms(lambda: ops.topk(x, kk), flush),
            "plain_ms": cold_ms(lambda: ref.topk_ref(x, kk), flush),
            "library_ms": cold_ms(lambda: torch.topk(x, kk), flush),
            **bound(4 * x.numel() + 8 * B * kk, x.numel(), FP32_FLOPS),
        }
        if entry is None:
            entry = {"name": "topk", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/topk.cu",
                     "replaces": "src/repro/kernels/topk_shard.py:66",
                     "counter": "topk",
                     "shape": f"x ({B},{VOCAB}) fp32, k=1", **timed}
        else:
            entry[f"k{kk}"] = timed
    out.append(entry)
    out.append(check_dequant(dev, flush))
    return out


def check_dequant(dev, flush) -> dict:
    """dequant_matmul at the cases of DQ_CASES.  Tolerance: 1e-4 of the
    largest |output| for sums over K <= 24576 in another order (every
    product is exact in fp32), plus, for a bf16 output, one bf16 ulp (the
    spacing of bf16 values) at the plain version's fp32 value."""
    from repro_torch.core import wquant
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for what, mode, T, K, N, out_dtype in DQ_CASES:
        w_dense = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).bfloat16()
        w = wquant.quantize(w_dense, mode, 128)
        x = torch.randn((T, K), generator=gen, device=dev).bfloat16()
        got = ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group, out_dtype=out_dtype)
        want = ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group)
        err = (got.float() - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        if out_dtype == torch.float32:
            ok = err <= tol
        else:
            ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
            ok = bool(((got.float() - want).abs() <= ulp + tol).all())
            tol = f"one bf16 ulp + {tol}"
        if not ok:
            fail(f"dequant_matmul {what} differs from its plain version by {err} (tol {tol})")
        w_dense = wquant.dequantize(w)    # the bf16 weight the quantized one replaces
        n_bytes = (2 * x.numel() + w.q.numel() + 2 * w.scale.numel()
                   + got.element_size() * got.numel())
        cases.append({
            "case": what, "shape": f"x ({T},{K}) bf16 @ {mode} ({K},{N}) g{w.group} -> {out_dtype}",
            "max_abs_err": err, "tolerance": tol,
            "ms": cold_ms(lambda: ops.dequant_matmul(x, w.q, w.scale, mode=mode, group=w.group,
                                                     out_dtype=out_dtype), flush),
            "plain_ms": cold_ms(lambda: ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group),
                                flush),
            "library_ms": cold_ms(lambda: torch.matmul(x, w_dense), flush),
            **bound(n_bytes, 2 * T * K * N, BF16_FLOPS),
        })
        del w_dense, w, x, got, want
    head = cases[0]
    return {"name": "dequant_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "src/repro/kernels/wquant_matmul.py:84",
            "counter": "dequant_matmul",
            "library": "torch.matmul on the dense bf16 weight (cuBLAS; not a dequant)",
            **{k: head[k] for k in ("shape", "max_abs_err", "tolerance", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")},
            "cases": cases}


def to_device(params: dict, dev) -> dict:
    """The port's params (QuantWeight leaves included) copied to ``dev``."""
    from repro_torch.core.wquant import map_tensors

    def mv(t):
        return map_tensors(t, lambda a: a.to(dev))
    return {"embed": {"table": mv(params["embed"]["table"])},
            "layers": [{k: mv(t) for k, t in layer.items()} for layer in params["layers"]],
            "final_norm": mv(params["final_norm"]), "lm_head": mv(params["lm_head"])}


def reference_check(dev, weight_quant: str = "none") -> dict:
    """A small GQA model (head_dim 128) on the card against the same weights
    on the CPU, where the plain versions run: prefill logits and 8
    teacher-forced decode steps.  Tolerance 5e-2 on fp32 logits of
    magnitude ~1, as the port's CPU tests hold it against the JAX package
    (bf16 activations rounded after differently ordered sums)."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("yi-9b").reduced(), n_heads=8, n_kv_heads=2,
                              head_dim=128)
    cpu = M.init_params(cfg, ParallelConfig(weight_quant=weight_quant), seed=1, device="cpu")
    gpu = to_device(cpu, dev)
    b, plen, max_len, tol = 3, 20, 128, 5e-2
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, plen)))
    caches = {d: M.init_caches(cfg, b, max_len, device=d) for d in ("cpu", dev)}
    worst = 0.0
    with torch.inference_mode():
        lc = M.forward(cpu, tokens, cfg, caches=caches["cpu"])
        lg = M.forward(gpu, tokens.to(dev), cfg, caches=caches[dev]).cpu()
        worst = max(worst, (lc - lg).abs().max().item())
        tok = lc[:, -1].argmax(-1)
        for cur in range(plen, plen + 8):
            lc = M.forward(cpu, tok[:, None], cfg, caches=caches["cpu"], cur_pos=cur)
            lg = M.forward(gpu, tok[:, None].to(dev), cfg, caches=caches[dev],
                           cur_pos=cur).cpu()
            worst = max(worst, (lc - lg).abs().max().item())
            tok = lc[:, -1].argmax(-1)
    if not (torch.isfinite(lg).all() and worst <= tol):
        fail(f"{weight_quant} card logits differ from the CPU's by {worst} > {tol}")
    return {"config": cfg.name + "-gqa-hd128", "weight_quant": weight_quant,
            "max_abs_logit_err": worst, "tolerance": tol}


def expected_dequant_launches(cfg, parallel, work) -> int:
    """dequant_matmul launches of the serve workload: per wave one prefill
    (T = batch x longest prompt through the six projections of every
    layer, T = batch through the lm_head) and SERVE_MAX_NEW - 1 decode steps
    (T = batch throughout), each call counted as the kernel splits it."""
    from repro_torch.core import wquant
    from repro_torch.kernels import build
    from repro_torch.models import model as M

    if parallel.weight_quant == "none":
        return 0
    launches = build.library("dequant_matmul").dequant_matmul_launches
    bits = 8 if parallel.weight_quant == "int8" else 4

    def calls(T, K, N):
        g = wquant.effective_group(K, parallel.wq_group_size) if bits == 4 else 0
        return launches(T, K, N, bits, g)

    projections = [shape for name, (shape, _, _) in M.layer_param_defs(cfg).items()
                   if M.WQ_SITES.get(name) == "matmul"]
    head = (cfg.d_model, cfg.vocab_size)

    def forward(T):
        return cfg.n_layers * sum(calls(T, K, N) for K, N in projections) + calls(SERVE_BATCH, *head)

    total = 0
    for w in range(0, len(work), SERVE_BATCH):
        wave = work[w:w + SERVE_BATCH]
        total += forward(len(wave) * max(len(p) for p in wave))
        total += (SERVE_MAX_NEW - 1) * forward(len(wave))
    return total


def serve_phase(dev, arch: str, weight_quant: str) -> dict:
    from repro_torch.configs import ParallelConfig, SamplingConfig, get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.scheduler import WaveScheduler

    t_phase = time.monotonic()
    cfg = get_config(arch)
    parallel = ParallelConfig(weight_quant=weight_quant)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = Engine(cfg, parallel=parallel, sampling=SamplingConfig(top_k=1),
                 max_len=SERVE_MAX_LEN, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.default_rng(0)
    work = [rng.integers(0, cfg.vocab_size, int(rng.integers(16, 129))).astype(np.int32)
            for _ in range(SERVE_REQUESTS)]

    def run():
        sched = WaveScheduler(eng, batch_size=SERVE_BATCH)
        for p in work:
            sched.submit(p, max_new=SERVE_MAX_NEW)
        torch.cuda.synchronize()
        t = time.monotonic()
        done = sched.run()
        torch.cuda.synchronize()
        return {r.rid: r.output for r in done}, time.monotonic() - t

    ops.reset_launches()
    first, dt1 = run()
    launches = dict(ops.LAUNCHES)
    second, dt2 = run()
    n_tokens = sum(len(t) for t in first.values())
    waves = -(-SERVE_REQUESTS // SERVE_BATCH)
    expect = {"flash_prefill": cfg.n_layers * waves,
              "decode_attention": cfg.n_layers * (SERVE_MAX_NEW - 1) * waves,
              "topk": SERVE_MAX_NEW * waves
                      * build.library("topk").topk_launches(cfg.vocab_size, 1),
              "dequant_matmul": expected_dequant_launches(cfg, parallel, work)}
    if launches != expect:
        fail(f"{arch} {weight_quant}: kernel launches {launches} != expected {expect}")
    for rid, toks in first.items():
        if len(toks) != SERVE_MAX_NEW or not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"{arch} {weight_quant} request {rid}: tokens out of range or wrong count: {toks}")
        if not np.array_equal(toks, second[rid]):
            fail(f"{arch} {weight_quant} request {rid}: greedy tokens differ between two runs")
    with torch.inference_mode():   # one full-width logits row: finite, right shape
        logits = M.forward(eng.params, torch.as_tensor(work[0], device=dev)[None].long(), cfg,
                           last_only=True, head_f32=eng.head_f32)
    if logits.shape != (1, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
        fail(f"{arch} {weight_quant}: full-width logits {tuple(logits.shape)} not finite / "
             f"wrong shape")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del eng, logits
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "weight_quant": weight_quant, "layers": cfg.n_layers,
        "params": cfg.param_count(), "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
        "max_new": SERVE_MAX_NEW, "max_len": SERVE_MAX_LEN,
        "prompt_lens": [len(p) for p in work], "tokens": n_tokens, "init_s": init_s,
        "wall_s": [dt1, dt2], "ms_per_token": [1e3 * dt1 / n_tokens, 1e3 * dt2 / n_tokens],
        "swept_bytes_per_token": M.decode_weight_bytes(cfg, parallel),
        "launches": launches, "repeatable": True, "peak_mem_gib": peak,
        "phase_s": time.monotonic() - t_phase,
        "first_tokens": {rid: first[rid][:8].tolist() for rid in sorted(first)[:2]},
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    from repro_torch.kernels import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.monotonic()
    reports = build.build_all()
    print(f"build: {len(reports)} libraries in {time.monotonic() - t0:.1f}s")
    for src, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    kernels = check_kernels(dev, flush)
    del flush
    for mode in ("none", "int8", "int4"):
        print(json.dumps({"reference": reference_check(dev, mode)}), flush=True)
    launches = {k["counter"]: 0 for k in kernels}
    for arch, mode in SERVE_PHASES:
        serve = serve_phase(dev, arch, mode)
        print(json.dumps({"serve": serve}), flush=True)
        for name, n in serve["launches"].items():
            launches[name] += n
    for k in kernels:
        k["launches"] = launches[k.pop("counter")]
        if k["launches"] == 0:
            fail(f"{k['name']} was not launched on the serving paths")
    print(f"chip_smoke: {time.monotonic() - t0:.1f}s after the device check")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
