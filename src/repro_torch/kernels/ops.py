"""Wrappers of the CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors it launches its kernel on the current stream, adds the
  number of launches to ``LAUNCHES[name]`` (one; top-k launches one per
  stage, two for a 64000-wide row; dequant_matmul two when it splits K)
  and raises if a launch is refused;
  there is no fallback to the plain version;
* on CPU tensors it runs the plain version from ``ref`` (the only place the
  plain version serves the port).

Outputs are allocated here with ``torch.empty``; the kernels allocate
nothing and do not synchronise.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build, ref

# launches of each kernel since the last reset: the proof that a run went
# through the kernels (chip_smoke.py zeroes it before the serving phase)
LAUNCHES: Counter = Counter()
KERNELS = ("flash_prefill", "decode_attention", "topk", "dequant_matmul")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES.update({name: 0 for name in KERNELS})


def _device_of(*tensors: torch.Tensor) -> str:
    devs = {t.device.type for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on mixed devices {sorted(devs)}")
    dev = devs.pop()
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {dev!r}")
    return dev


def _check_cuda(name: str, *tensors: torch.Tensor, align: int = 16) -> None:
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{name}: the kernel takes contiguous, {align}-byte aligned tensors")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal GQA flash prefill.  q (b, hq, Sq, hd), k/v (b, hkv, Sk, hd),
    q_pos (b, Sq) int32 view positions (-1 = pad row) -> (b, hq, Sq, hd) in
    q.dtype; row i attends key j iff j <= q_pos[b, i]."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, sk, hd) or v.shape != k.shape or q_pos.shape != (b, sq):
        raise ValueError(f"flash_prefill: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} q_pos{tuple(q_pos.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"flash_prefill: {hq} q heads over {hkv} kv heads")
    if _device_of(q, k, v, q_pos) == "cpu":
        return ref.flash_prefill_ref(q, k, v, q_pos, scale)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_prefill: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in (64, 128) or q_pos.dtype != torch.int32:
        raise ValueError(f"flash_prefill: head_dim {hd} / q_pos {q_pos.dtype} not taken")
    _check_cuda("flash_prefill", q, k, v, q_pos)
    out = torch.empty_like(q)
    build.call("flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               q_pos.data_ptr(), out.data_ptr(), b, hq, hkv, sq, sk, hd,
               _DTYPES[q.dtype], float(scale), _stream())
    LAUNCHES["flash_prefill"] += 1
    return out


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid: torch.Tensor, scale: float):
    """Unnormalized flash partials for one query token per row.
    q (b, hq, 1, hd), k/v (b, hkv, S, hd), valid (S,) or (b, S) bool ->
    m (b, hq, 1), l (b, hq, 1), acc (b, hq, 1, hd) fp32; a row with no
    valid key gives m = -inf, l = 0, acc = 0."""
    b, hq, one, hd = q.shape
    hkv, S = k.shape[1], k.shape[2]
    if (one != 1 or k.shape != (b, hkv, S, hd) or v.shape != k.shape
            or valid.shape not in ((S,), (b, S))):
        raise ValueError(f"decode_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} valid{tuple(valid.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"decode_attention: {hq} q heads over {hkv} kv heads")
    if _device_of(q, k, v, valid) == "cpu":
        return ref.decode_attention_ref(q, k, v, valid, scale)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in (64, 128) or valid.dtype != torch.bool:
        raise ValueError(f"decode_attention: head_dim {hd} / mask {valid.dtype} not taken")
    _check_cuda("decode_attention", q, k, v, valid)
    m = torch.empty((b, hq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hq, 1, hd), dtype=torch.float32, device=q.device)
    build.call("decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               valid.data_ptr(), int(valid.dim() == 2), m.data_ptr(), l.data_ptr(),
               acc.data_ptr(), b, hq, hkv, S, hd, _DTYPES[q.dtype], float(scale),
               _stream())
    LAUNCHES["decode_attention"] += 1
    return m, l, acc


def topk(x: torch.Tensor, k: int):
    """(rows, n) -> (vals (rows, k) fp32, idx (rows, k) int32), largest
    first, ties to the lowest index."""
    if x.dim() != 2 or not 0 < k <= x.shape[1]:
        raise ValueError(f"topk: k={k} over x{tuple(x.shape)}")
    if _device_of(x) == "cpu":
        return ref.topk_ref(x, k)
    if x.dtype not in _DTYPES:
        raise ValueError(f"topk: dtype {x.dtype} not taken")
    _check_cuda("topk", x)
    rows, n = x.shape
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    lib = build.library("topk")
    n_work = lib.topk_workspace(rows, n, k)
    work_v = torch.empty((n_work,), dtype=torch.float32, device=x.device)
    work_i = torch.empty((n_work,), dtype=torch.int32, device=x.device)
    build.call("topk", x.data_ptr(), _DTYPES[x.dtype], rows, n, k, vals.data_ptr(),
               idx.data_ptr(), work_v.data_ptr(), work_i.data_ptr(), _stream())
    LAUNCHES["topk"] += lib.topk_launches(n, k)   # one launch per stage
    return vals, idx


def dequant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *, mode: str,
                   group: int, out_dtype=None) -> torch.Tensor:
    """x (T, K) bf16 @ dequant(q, scale) -> (T, N) in ``out_dtype`` (default
    x.dtype), summed in fp32.  int8: q (K, N) int8, scale (N,) bf16; int4:
    q (K//2, N) uint8, scale (K//group, N) bf16, K a multiple of group."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"dequant_matmul: x{tuple(x.shape)} and q{tuple(q.shape)} must be 2-D")
    T, K = x.shape
    N = q.shape[1]
    if mode == "int8":
        want = ((K, N), torch.int8, (N,))
    elif mode == "int4":
        if group < 2 or group % 2 or K % group:
            raise ValueError(f"dequant_matmul: K={K} is not a whole number of even groups {group}")
        want = ((K // 2, N), torch.uint8, (K // group, N))
    else:
        raise ValueError(f"dequant_matmul: mode {mode!r} not in ('int8', 'int4')")
    if tuple(q.shape) != want[0] or q.dtype != want[1] or tuple(scale.shape) != want[2]:
        raise ValueError(f"dequant_matmul: {mode} x{tuple(x.shape)} takes q {want[0]} "
                         f"{want[1]} and scale {want[2]}, got q{tuple(q.shape)} {q.dtype} "
                         f"and scale{tuple(scale.shape)}")
    if _device_of(x, q, scale) == "cpu":
        return ref.dequant_matmul_ref(x, q, scale, mode, group).to(out_dtype)
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or out_dtype not in _DTYPES:
        raise ValueError(f"dequant_matmul: dtypes x {x.dtype}, scale {scale.dtype}, "
                         f"out {out_dtype} not taken")
    # any alignment: the kernel takes 16-byte loads of q where the row allows
    # them (per-layer views of a stacked weight need not be 16-byte aligned)
    _check_cuda("dequant_matmul", x, q, scale, align=1)
    bits = 8 if mode == "int8" else 4
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    lib = build.library("dequant_matmul")
    work = torch.empty((lib.dequant_matmul_workspace(T, K, N, bits, group),),
                       dtype=torch.float32, device=x.device)
    build.call("dequant_matmul", x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
               _DTYPES[out_dtype], work.data_ptr(), T, K, N, bits, group, _stream())
    LAUNCHES["dequant_matmul"] += lib.dequant_matmul_launches(T, K, N, bits, group)
    return out


reset_launches()
