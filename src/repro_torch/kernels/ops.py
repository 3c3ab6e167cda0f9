"""Wrappers of the CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, then:

* on CUDA tensors it launches its kernel on the current stream, adds the
  number of launches to ``LAUNCHES[name]`` (one; flash_verify two, the
  split pass and the merge; the decode kernels, top-k, dequant_matmul and
  fused_dual_matmul one, their splits merged in the same launch;
  kv_quant_write one for K and V together; a decode kernel's launch over
  an int8 cache counts under ``<name>_int8``, its own instance)
  and raises if a launch is refused;
  there is no fallback to the plain version;
* on CPU tensors it runs the plain version from ``ref`` (the only place the
  plain version serves the port).

Outputs are allocated here with ``torch.empty``; the kernels allocate
nothing and do not synchronise.  The arrival counters of split launches
(``_arrival_counters``) and their partials (``_split_workspace``: the
matmul kernels' fp32 parts, top-k's candidates) are the buffers kept
between calls.
"""
from __future__ import annotations

import functools
import math
from collections import Counter

import torch

from repro_torch.kernels import build, ref

# launches of each kernel since the last reset: the proof that a run went
# through the kernels (chip_smoke.py zeroes it before the serving phase)
LAUNCHES: Counter = Counter()
KERNELS = ("flash_prefill", "decode_attention", "topk", "dequant_matmul",
           "paged_decode_attention", "paged_flash_prefill", "flash_verify", "lru_scan",
           "fused_dual_matmul", "kv_quant_write", "decode_attention_int8",
           "paged_decode_attention_int8")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head_dims every attention kernel has an instance for
HEAD_DIMS = (64, 128, 256)
# the decode kernels (csrc/decode_attention.cuh): keys per tile, one per
# lane (a split chunk is a whole number of tiles), and query heads per block
DECODE_TILE, DECODE_ROWS = 32, 8

# the matmul kernels (csrc/gemm_sm90.cuh): the widest T of the byte-bound
# (narrow) instances, blocks a launch puts on an SM, and the fewest K stages
# a block takes where the work allows
GEMM_NARROW_T, GEMM_BLOCKS_PER_SM, GEMM_MIN_STAGES = 64, 2, 4
# fused_dual_matmul: the chunks each tile's K is cut into, at every T: the
# fewest (each adds a part to every tile's merge) that still give a decode
# step at gptj-parallel's D = 4096 (32 tiles) a block on every SM, 160
FDM_CHUNKS = 5
# lru_scan (csrc/lru_scan.cu, its constants C, G, D): steps a tile,
# segments (warps) a tile, cp.async stages
LRU_TILE = (128, 8, 3)
# top-k (csrc/topk.cu): the most elements a block takes, the fewest, and
# the most candidates (chunks x k) its merge holds in registers
TOPK_MAX_CHUNK, TOPK_MIN_CHUNK, TOPK_MAX_MERGE = 4096, 256, 4096

_SMS: dict = {}        # device index -> SM count, read once
_ARRIVALS: dict = {}   # device index -> int32 arrival counters of split launches
_WORK: dict = {}       # device index -> partials of split launches


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCHES.update({name: 0 for name in KERNELS})


def _device_of(name: str, *tensors: torch.Tensor) -> str:
    """The device every input of wrapper ``name`` lies on.  Raises where an
    input requires grad while grad is enabled, on the CPU as on the card: a
    kernel fills its output through a raw pointer, so that output carries no
    ``grad_fn``, and its plain version on the CPU would hide the break.  A
    training forward takes its own branch (``models/``), never a wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel's output "
                           "carries none; the training forward has its own branch")
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


def _check_stripe(name: str, q, k, v, q_pos, rows):
    """Shapes of a dense call: q (b, hq, Sq, hd), k/v (n, hkv, Sk, hd) with
    n == b, or ``rows`` (b,) naming each batch row's stripe -> (hkv, Sk)."""
    b, hq, sq, hd = q.shape
    n, hkv, sk = k.shape[:3]
    if (k.shape != (n, hkv, sk, hd) or v.shape != k.shape or q_pos.shape != (b, sq)
            or (rows is None and n != b) or (rows is not None and tuple(rows.shape) != (b,))):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} q_pos{tuple(q_pos.shape)} rows "
                         f"{None if rows is None else tuple(rows.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"{name}: {hq} q heads over {hkv} kv heads")
    return hkv, sk


def _check_stripe_cuda(name: str, q, k, v, q_pos, rows) -> None:
    hd = q.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if (hd not in HEAD_DIMS or q_pos.dtype != torch.int32
            or (rows is not None and rows.dtype != torch.int32)):
        raise ValueError(f"{name}: head_dim {hd} / q_pos {q_pos.dtype} / rows not taken")
    _check_cuda(name, q, k, v, q_pos, *(() if rows is None else (rows,)))


def _stripes(k, v, rows):
    """The plain versions' view of a row-indexed stripe: a gathered copy."""
    return (k, v) if rows is None else (k[rows.long()], v[rows.long()])


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, scale: float, rows: torch.Tensor = None,
                  window: int = 0) -> torch.Tensor:
    """Causal GQA flash prefill.  q (b, hq, Sq, hd), k/v (b, hkv, Sk, hd),
    q_pos (b, Sq) int32 view positions (-1 = pad row) -> (b, hq, Sq, hd) in
    q.dtype; row i attends key j iff j <= q_pos[b, i] and, with ``window``
    > 0, j > q_pos[b, i] - window.  With ``rows`` (b,) int32, k/v are a slot
    cache (n, hkv, Sk, hd) and batch row b attends cache row rows[b] (a
    chunk reading its slots' stripes in place).  head_dim 64, 128 or
    256."""
    b, hq, sq, hd = q.shape
    hkv, sk = _check_stripe("flash_prefill", q, k, v, q_pos, rows)
    if _device_of("flash_prefill", q, k, v, q_pos, *(() if rows is None else (rows,))) == "cpu":
        return ref.flash_prefill_ref(q, *_stripes(k, v, rows), q_pos, scale, window)
    _check_stripe_cuda("flash_prefill", q, k, v, q_pos, rows)
    out = torch.empty_like(q)
    build.call("flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               None if rows is None else rows.data_ptr(), k.shape[0], q_pos.data_ptr(),
               out.data_ptr(), b, hq, hkv, sq, sk, hd, _DTYPES[q.dtype], float(scale),
               int(window), _stream())
    LAUNCHES["flash_prefill"] += 1
    return out


def flash_verify(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_pos: torch.Tensor, scale: float, rows: torch.Tensor = None) -> torch.Tensor:
    """``flash_prefill`` for a narrow query chunk (the spec-decode verify
    step, Sq = spec_k + 1 <= 8) over dense slot stripes, with the stripe's
    KV axis split across blocks and a merge pass.  Same arguments and
    result as ``flash_prefill``."""
    b, hq, sq, hd = q.shape
    hkv, sk = _check_stripe("flash_verify", q, k, v, q_pos, rows)
    if _device_of("flash_verify", q, k, v, q_pos, *(() if rows is None else (rows,))) == "cpu":
        return ref.flash_verify_ref(q, *_stripes(k, v, rows), q_pos, scale)
    _check_stripe_cuda("flash_verify", q, k, v, q_pos, rows)
    out = torch.empty_like(q)
    n_work = _verify_workspace(b, hq, hkv, sq, sk, hd)
    work = torch.empty((max(n_work, 0),), dtype=torch.float32, device=q.device)
    build.call("flash_verify", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               None if rows is None else rows.data_ptr(), k.shape[0], q_pos.data_ptr(),
               out.data_ptr(), work.data_ptr(), n_work, b, hq, hkv, sq, sk, hd,
               _DTYPES[q.dtype], float(scale), _stream())
    LAUNCHES["flash_verify"] += 2    # the split pass and the merge
    return out


@functools.lru_cache(maxsize=None)
def _verify_workspace(b: int, hq: int, hkv: int, sq: int, sk: int, hd: int) -> int:
    """fp32 floats of flash_verify's partials workspace at these shapes: the
    same for every layer of a step, so asked of the library once."""
    return build.library("flash_verify").flash_verify_workspace(b, hq, hkv, sq, sk, hd)


def decode_split_plan(b: int, hq: int, hkv: int, S: int, sms: int):
    """The decode kernels' split of the KV axis: (chunk, splits) such that
    the grid of b * hkv * ceil(g / DECODE_ROWS) blocks times ``splits``
    gives each of ``sms`` SMs about one block (one wave: a block takes most
    of an SM's shared memory, and every split adds a partial to the last
    block's merge), ``chunk`` is a whole number of DECODE_TILE-key tiles,
    the splits cover the S keys, and none lies wholly past S.  splits == 1
    (chunk >= S) when the unsplit grid already fills the card."""
    blocks = b * hkv * -(-(hq // hkv) // DECODE_ROWS)
    tiles = -(-S // DECODE_TILE)
    want = max(1, min(tiles, -(-sms // blocks)))
    chunk = -(-tiles // want) * DECODE_TILE
    return chunk, -(-S // chunk)


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def _arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for split launches on
    ``device``: zeroed once with ``torch.zeros``, grown (zeroed again) when
    a launch needs more, and left zero by every launch.  They assume that
    the kernels launch on one stream at a time, as every wrapper here does
    (the current stream): launches overlapping on two streams would need a
    buffer each."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 2 * (0 if buf is None else buf.numel())),), dtype=torch.int32,
                          device=device)
        _ARRIVALS[key] = buf
    return buf


def gemm_tile(kind: str, T: int, group: int = 0):
    """(K rows a stage, tokens a block, weight columns a block) of the
    matmul kernels' instance for a ``kind`` ('bf16', 'int8' or 'int4')
    weight at T rows (csrc/dequant_matmul.cu, csrc/fused_dual_matmul.cu).
    Up to GEMM_NARROW_T, T pads to 8, 16, 32 or 64 tokens; int8 / int4 up to
    16 rows take 512 columns (rows of 512 bytes of weight), else 128.  Past
    GEMM_NARROW_T 128 tokens by 128 columns: int8 and int4 on wgmma (int4
    ``group``s that are no whole number of stages take the 64-token
    instance), bf16 on mma.sync.  bf16 takes 64 K rows a stage at every
    T."""
    if T > GEMM_NARROW_T and not (kind == "int4" and group % 64):
        return 64, 128, 128
    nt = 1
    while 8 * nt < min(T, GEMM_NARROW_T):
        nt *= 2
    if kind == "bf16":
        return 64, 8 * nt, 128
    if nt > 2:
        return 128, 8 * nt, 128
    return (64 if kind == "int4" else 32), 8 * nt, 512


@functools.lru_cache(maxsize=None)
def gemm_split_plan(T: int, N: int, stages: int, unit: int, bn: int, bm: int, sms: int,
                    whole: bool = False) -> int:
    """Blocks of a matmul launch.  The work is ceil(T / bn) * ceil(N / bm)
    tiles of ``stages`` K stages, cut into units of ``unit`` stages (int4:
    whole groups); its W units, tile after tile, are shared evenly by the
    blocks (``gemm_segments``): GEMM_BLOCKS_PER_SM a SM, so that one wave
    keeps every SM streaming to the end.  ``whole`` (the wgmma instances,
    one block an SM): one block a tile where the tiles fill half the SMs or
    more, so that the blocks sharing a weight slab or an x tile run in step
    and read it once from device memory.  No fewer than GEMM_MIN_STAGES stages a block (a part
    merged costs its tile a round trip through the workspace)."""
    tiles = -(-T // bn) * -(-N // bm)
    if whole and 2 * tiles >= sms:
        return tiles
    units = -(-stages // unit)
    return max(1, min(sms * GEMM_BLOCKS_PER_SM, tiles * units // -(-GEMM_MIN_STAGES // unit)))


def gemm_segments(T: int, N: int, stages: int, unit: int, bn: int, bm: int, blocks: int,
                  chunk: int = 0) -> list:
    """What each block of a matmul launch multiplies, as the kernel cuts it
    (csrc/gemm_sm90.cuh, ``body``): per block its segments (tile, first
    stage, end stage).  chunk > 0: block b takes chunk b % n of tile b / n;
    else block b owns units [b W / blocks, (b + 1) W / blocks) of the W
    units of all tiles."""
    if chunk:
        n = -(-stages // chunk)
        return [[(b // n, b % n * chunk, min(stages, (b % n + 1) * chunk))] for b in range(blocks)]
    units = -(-stages // unit)
    W = -(-T // bn) * -(-N // bm) * units
    out = []
    for b in range(blocks):
        u, u1, segs = b * W // blocks, (b + 1) * W // blocks, []
        while u < u1:
            tau = u // units
            ue = min(u1, (tau + 1) * units)
            segs.append((tau, (u - tau * units) * unit, min(stages, (ue - tau * units) * unit)))
            u = ue
        out.append(segs)
    return out


@functools.lru_cache(maxsize=None)
def dequant_split_plan(T: int, K: int, N: int, bits: int, group: int, sms: int):
    """``gemm_split_plan`` for dequant_matmul -> (blocks, stages, unit, bn,
    bm, chunk 0): K in stages of ``gemm_tile`` rows; an int4 unit is
    lcm(group, stage rows) rows, whole groups."""
    bk, bn, bm = gemm_tile("int8" if bits == 8 else "int4", T, group)
    unit = 1 if bits == 8 else math.lcm(group, bk) // bk
    stages = -(-K // bk)
    whole = bn == 128   # the wgmma instance
    return gemm_split_plan(T, N, stages, unit, bn, bm, sms, whole), stages, unit, bn, bm, 0


@functools.lru_cache(maxsize=None)
def fused_split_plan(T: int, Ka: int, Kb: int, D: int, sms: int):
    """The split of fused_dual_matmul (bf16) -> (blocks, stages, unit, bn,
    bm, chunk): a's ceil(Ka / bk) stages, then b's, each tile in
    FDM_CHUNKS chunks of the same stages whatever T is (64 K rows a stage
    in every instance), one block a chunk: a row's sums are the same bits
    in a decode step, a verify step, a mixed step or a prefill of any
    width, with or without its cached prefix.  ``sms`` is not read: the
    split may not depend on the card either."""
    bk, bn, bm = gemm_tile("bf16", T)
    stages = -(-Ka // bk) + -(-Kb // bk)
    chunk = -(-stages // FDM_CHUNKS)
    return -(-T // bn) * -(-D // bm) * -(-stages // chunk), stages, 1, bn, bm, chunk


def _split_workspace(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` fp32 floats for the partials of split launches on
    ``device`` (the matmul kernels' partial sums, top-k's candidate keys),
    grown when a launch needs more.  Every launch writes its partials before
    it reads them, and the next launch on the stream starts after it: one
    buffer serves every call, on one stream at a time (as
    ``_arrival_counters``)."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    buf = _WORK.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty((max(n, 2 * (0 if buf is None else buf.numel())),),
                          dtype=torch.float32, device=device)
        _WORK[key] = buf
    return buf


def _matmul_split(device: torch.device, T: int, N: int, blocks: int, bn: int, bm: int):
    """(workspace, counters) pointers of a matmul launch of ``blocks``
    blocks: two fp32 tiles of parts a block, one counter a tile."""
    if blocks == 1:
        return None, None
    return (_split_workspace(device, blocks * 2 * bn * bm).data_ptr(),
            _arrival_counters(device, -(-T // bn) * -(-N // bm)).data_ptr())


def _decode_split(q: torch.Tensor, hkv: int, S: int):
    """The partials workspace of a decode launch (fp32 acc, m and l per
    split and query head; None when the plan does not split) and the
    launch's split arguments: (work, work floats, counters, counter count,
    chunk, splits).  The caller holds the workspace until it has
    launched."""
    b, hq, _, hd = q.shape
    chunk, splits = decode_split_plan(b, hq, hkv, S, _sm_count(q.device))
    if splits == 1:
        return None, (None, 0, None, 0, chunk, splits)
    n_work = splits * b * hq * (hd + 2)
    work = torch.empty((n_work,), dtype=torch.float32, device=q.device)
    counters = _arrival_counters(q.device, b * hkv * -(-(hq // hkv) // DECODE_ROWS))
    return work, (work.data_ptr(), n_work, counters.data_ptr(), counters.numel(), chunk,
                  splits)


def _check_kv_scales(name: str, q, k, v, k_scale, v_scale):
    """An int8 cache k/v (…, hd) takes bf16 scales of its shape less hd;
    a bf16 / fp32 cache takes none.  -> the scales, or None."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: both scales or neither")
    if k_scale is None:
        if k.dtype == torch.int8:
            raise ValueError(f"{name}: an int8 cache needs its scales")
        return None
    if (k.dtype != torch.int8 or v.dtype != torch.int8 or q.dtype != torch.bfloat16
            or k_scale.shape != k.shape[:-1] or v_scale.shape != v.shape[:-1]
            or k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16):
        raise ValueError(f"{name}: an int8 cache ({k.dtype}/{v.dtype}, q {q.dtype}) takes "
                         f"bf16 scales of shape {tuple(k.shape[:-1])}, got "
                         f"{tuple(k_scale.shape)} {k_scale.dtype} / {tuple(v_scale.shape)}")
    return k_scale, v_scale


def _cache_pointers(name: str, q, k, v, scales) -> tuple:
    """Dtype checks of a decode launch and its (k_scale, v_scale) pointers
    (None for a bf16 / fp32 cache)."""
    if scales is None:
        if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
            raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
        return None, None
    _check_cuda(name, *scales, align=2)
    return scales[0].data_ptr(), scales[1].data_ptr()


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid: torch.Tensor, scale: float,
                             k_scale: torch.Tensor = None, v_scale: torch.Tensor = None):
    """Unnormalized flash partials for one query token per row.
    q (b, hq, 1, hd), k/v (b, hkv, S, hd), valid (S,) or (b, S) bool ->
    m (b, hq, 1), l (b, hq, 1), acc (b, hq, 1, hd) fp32; a row with no
    valid key gives m = -inf, l = 0, acc = 0.  An int8 cache (k, v int8,
    q bf16) comes with its bf16 scales k_scale, v_scale (b, hkv, S) and is
    attended as ``ref.dequantize_kv`` of it.  On the card the KV axis is
    split across blocks by ``decode_split_plan`` and merged in the launch."""
    b, hq, one, hd = q.shape
    hkv, S = k.shape[1], k.shape[2]
    if (one != 1 or k.shape != (b, hkv, S, hd) or v.shape != k.shape
            or valid.shape not in ((S,), (b, S))):
        raise ValueError(f"decode_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} valid{tuple(valid.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"decode_attention: {hq} q heads over {hkv} kv heads")
    scales = _check_kv_scales("decode_attention", q, k, v, k_scale, v_scale)
    if _device_of("decode_attention_partial", q, k, v, valid, *(scales or ())) == "cpu":
        if scales is not None:
            k, v = ref.dequantize_kv(k, k_scale), ref.dequantize_kv(v, v_scale)
        return ref.decode_attention_ref(q, k, v, valid, scale)
    ks, vs = _cache_pointers("decode_attention", q, k, v, scales)
    if hd not in HEAD_DIMS or valid.dtype != torch.bool:
        raise ValueError(f"decode_attention: head_dim {hd} / mask {valid.dtype} not taken")
    _check_cuda("decode_attention", q, k, v, valid)
    m = torch.empty((b, hq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hq, 1, hd), dtype=torch.float32, device=q.device)
    work, split = _decode_split(q, hkv, S)
    build.call("decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), ks, vs,
               valid.data_ptr(), int(valid.dim() == 2), m.data_ptr(), l.data_ptr(),
               acc.data_ptr(), *split, b, hq, hkv, S, hd,
               _DTYPES[q.dtype], float(scale), _stream())
    del work    # held until the launch was queued
    LAUNCHES["decode_attention" if scales is None else "decode_attention_int8"] += 1
    return m, l, acc


def _check_pool(name: str, q, k_pool, v_pool, bt) -> tuple:
    """Shapes of a paged call: q (b, hq, s, hd), pools (nb, hkv, bs, hd),
    bt (b, nbps) -> (nb, hkv, bs, nbps)."""
    b, hq, _, hd = q.shape
    nb, hkv, bs = k_pool.shape[:3]
    if (k_pool.shape != (nb, hkv, bs, hd) or v_pool.shape != k_pool.shape
            or bt.dim() != 2 or bt.shape[0] != b):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} pools{tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} bt{tuple(bt.shape)} do not agree")
    if hq % hkv:
        raise ValueError(f"{name}: {hq} q heads over {hkv} kv heads")
    return nb, hkv, bs, bt.shape[1]


def _check_paged_cuda(name: str, q, k_pool, v_pool, bt, idx, idx_dtype) -> None:
    hd = q.shape[-1]
    if hd not in HEAD_DIMS or bt.dtype != torch.int32 or idx.dtype != idx_dtype:
        raise ValueError(f"{name}: head_dim {hd} / table {bt.dtype} / {idx.dtype} not taken")
    _check_cuda(name, q, k_pool, v_pool, bt, idx)


def paged_decode_attention_partial(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                                   bt: torch.Tensor, valid: torch.Tensor, scale: float,
                                   k_scale: torch.Tensor = None, v_scale: torch.Tensor = None):
    """``decode_attention_partial`` with K/V read from block pools through
    each slot's block table.  q (b, hq, 1, hd), pools (nb, hkv, bs, hd),
    bt (b, nbps) int32 (entries outside the pool read the null block 0),
    valid (b, nbps*bs) bool -> fp32 m, l (b, hq, 1), acc (b, hq, 1, hd); a
    row with no valid key gives m = -inf, l = 0, acc = 0.  int8 pools (q
    bf16) come with their bf16 scale pools k_scale, v_scale (nb, hkv, bs).
    The view is split across blocks as ``decode_attention_partial``'s
    cache is."""
    nb, hkv, bs, nbps = _check_pool("paged_decode_attention", q, k_pool, v_pool, bt)
    b, hq, one, hd = q.shape
    if one != 1 or valid.shape != (b, nbps * bs):
        raise ValueError(f"paged_decode_attention: q{tuple(q.shape)} valid{tuple(valid.shape)} "
                         f"for a view of {nbps * bs}")
    scales = _check_kv_scales("paged_decode_attention", q, k_pool, v_pool, k_scale, v_scale)
    if _device_of("paged_decode_attention_partial", q, k_pool, v_pool, bt, valid,
                  *(scales or ())) == "cpu":
        if scales is not None:
            k_pool, v_pool = ref.dequantize_kv(k_pool, k_scale), ref.dequantize_kv(v_pool, v_scale)
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, bt, valid, scale)
    ks, vs = _cache_pointers("paged_decode_attention", q, k_pool, v_pool, scales)
    _check_paged_cuda("paged_decode_attention", q, k_pool, v_pool, bt, valid, torch.bool)
    m = torch.empty((b, hq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((b, hq, 1, hd), dtype=torch.float32, device=q.device)
    work, split = _decode_split(q, hkv, nbps * bs)
    build.call("paged_decode_attention", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               ks, vs, bt.data_ptr(), valid.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
               *split, b, hq, hkv, nb, bs, nbps, hd,
               _DTYPES[q.dtype], float(scale), _stream())
    del work    # held until the launch was queued
    LAUNCHES["paged_decode_attention" if scales is None else "paged_decode_attention_int8"] += 1
    return m, l, acc


def paged_flash_prefill(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                        bt: torch.Tensor, q_pos: torch.Tensor, scale: float) -> torch.Tensor:
    """``flash_prefill`` with K/V read from block pools through each slot's
    block table: row i of slot b attends view index j iff j <= q_pos[b, i]
    (view index == position; pad rows carry -1 and come out as zeros).
    q (b, hq, Sq, hd), pools (nb, hkv, bs, hd), bt (b, nbps) int32, q_pos
    (b, Sq) int32 -> (b, hq, Sq, hd) in q.dtype."""
    nb, hkv, bs, nbps = _check_pool("paged_flash_prefill", q, k_pool, v_pool, bt)
    b, hq, sq, hd = q.shape
    if q_pos.shape != (b, sq):
        raise ValueError(f"paged_flash_prefill: q_pos{tuple(q_pos.shape)} for q{tuple(q.shape)}")
    if _device_of("paged_flash_prefill", q, k_pool, v_pool, bt, q_pos) == "cpu":
        return ref.paged_flash_prefill_ref(q, k_pool, v_pool, bt, q_pos, scale)
    _cache_pointers("paged_flash_prefill", q, k_pool, v_pool, None)
    _check_paged_cuda("paged_flash_prefill", q, k_pool, v_pool, bt, q_pos, torch.int32)
    out = torch.empty_like(q)
    build.call("paged_flash_prefill", q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
               bt.data_ptr(), q_pos.data_ptr(), out.data_ptr(), b, hq, hkv, sq, nb, bs, nbps,
               hd, _DTYPES[q.dtype], float(scale), _stream())
    LAUNCHES["paged_flash_prefill"] += 1
    return out


def kv_quant_write(k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, k_scale: torch.Tensor, v_scale: torch.Tensor,
                   dst_row: torch.Tensor, dst_idx: torch.Tensor, dequantized: bool = False):
    """Quantize a layer's fresh K and V (b, h, s, hd) bf16 as
    ``ref.quantize_kv`` does and write them in place: token t of the flat
    (row, position) order goes to [dst_row[t], :, dst_idx[t]] of the int8
    caches (n, h, m, hd) and of their bf16 scales (n, h, m); dst_row[t] < 0
    drops it.  ``dst_row``, ``dst_idx`` (b * s,) int32.  k and v may be
    strided views (last dim contiguous).  -> the dequantized fresh (k, v)
    (b, h, s, hd) bf16 when ``dequantized`` (what a prefill attends), else
    None.  One launch for both sides on the card."""
    b, h, s, hd = k.shape
    n, m = k_cache.shape[0], k_cache.shape[2]
    if (v.shape != k.shape or k_cache.shape != (n, h, m, hd) or v_cache.shape != k_cache.shape
            or k_scale.shape != (n, h, m) or v_scale.shape != k_scale.shape
            or dst_row.shape != (b * s,) or dst_idx.shape != (b * s,)):
        raise ValueError(f"kv_quant_write: shapes k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"caches{tuple(k_cache.shape)} scales{tuple(k_scale.shape)} "
                         f"targets{tuple(dst_row.shape)}/{tuple(dst_idx.shape)} do not agree")
    if _device_of("kv_quant_write", k, v, k_cache, v_cache, k_scale, v_scale, dst_row,
                  dst_idx) == "cpu":
        out = ref.kv_quant_write_ref(k, v, k_cache, v_cache, k_scale, v_scale, dst_row, dst_idx)
        return out if dequantized else None
    if (k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 or k_cache.dtype != torch.int8
            or v_cache.dtype != torch.int8 or k_scale.dtype != torch.bfloat16
            or v_scale.dtype != torch.bfloat16 or dst_row.dtype != torch.int32
            or dst_idx.dtype != torch.int32 or hd not in HEAD_DIMS):
        raise ValueError(f"kv_quant_write: dtypes k {k.dtype}, caches {k_cache.dtype}, scales "
                         f"{k_scale.dtype}, targets {dst_row.dtype} / head_dim {hd} not taken")
    for x in (k, v):
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
            raise ValueError("kv_quant_write: k and v take 16-byte aligned rows, hd contiguous")
    _check_cuda("kv_quant_write", k_cache, v_cache)
    _check_cuda("kv_quant_write", k_scale, v_scale, dst_row, dst_idx, align=2)
    kd = vd = None
    if dequantized:
        kd = torch.empty((b, h, s, hd), dtype=torch.bfloat16, device=k.device)
        vd = torch.empty_like(kd)
    build.call("kv_quant_write", k.data_ptr(), v.data_ptr(), *k.stride()[:3], *v.stride()[:3],
               k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
               dst_row.data_ptr(), dst_idx.data_ptr(), None if kd is None else kd.data_ptr(),
               None if vd is None else vd.data_ptr(), b, h, s, hd, n, m, _stream())
    LAUNCHES["kv_quant_write"] += 1
    return (kd, vd) if dequantized else None


def lru_tile_plan():
    """(C, G, stages) of the lru_scan kernel: tiles of C steps, scanned by G
    warps of C / G steps each, staged ``stages`` deep.  The same at every
    shape: (C, G) fixes where the carries combine, so a row's states are
    the same bits at any batch (a wave of 4 or a one-request admission)."""
    return LRU_TILE


def lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t`` over the
    sequence.  a, b (batch, seq, w) fp32 or bf16, read as fp32; h0 (batch,
    w) fp32 -> (h (batch, seq, w), h_final (batch, w)), both fp32; any w.
    On the card the sequence is scanned in tiles of ``lru_tile_plan``."""
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"lru_scan: shapes a{tuple(a.shape)} b{tuple(b.shape)} "
                         f"h0{tuple(h0.shape)} do not agree")
    if _device_of("lru_scan", a, b, h0) == "cpu":
        return ref.lru_scan_ref(a, b, h0)
    if a.dtype not in _DTYPES or b.dtype != a.dtype or h0.dtype != torch.float32:
        raise ValueError(f"lru_scan: dtypes {a.dtype}/{b.dtype}/{h0.dtype} not taken")
    _check_cuda("lru_scan", a, b, h0, align=4)
    batch, s, w = a.shape
    hs = torch.empty((batch, s, w), dtype=torch.float32, device=a.device)
    h_final = torch.empty((batch, w), dtype=torch.float32, device=a.device)
    build.call("lru_scan", a.data_ptr(), b.data_ptr(), _DTYPES[a.dtype], h0.data_ptr(),
               hs.data_ptr(), h_final.data_ptr(), batch, s, w, _stream())
    LAUNCHES["lru_scan"] += 1
    return hs, h_final


def topk_chunk_plan(rows: int, n: int, k: int, sms: int):
    """(chunk, n_chunks) of the top-k kernel: each row cut into chunks of
    ``chunk`` elements (a multiple of 32), one block a chunk, enough that
    rows * n_chunks fills the ``sms`` SMs, but few enough that the row's
    n_chunks * k candidates fit the merge's registers (TOPK_MAX_MERGE),
    within [TOPK_MIN_CHUNK, TOPK_MAX_CHUNK].  Past that (large k over a
    wide row) the merge reads its candidates through L2.  The result does
    not depend on the plan (the kernel's keys are unique), so the plan may
    follow the card."""
    chunk = n // max(1, -(-sms // rows)) // 32 * 32
    chunk = max(chunk, -(-n // max(1, TOPK_MAX_MERGE // k) // 32) * 32)
    chunk = min(TOPK_MAX_CHUNK, max(TOPK_MIN_CHUNK, chunk))
    return chunk, -(-n // chunk)


def topk(x: torch.Tensor, k: int):
    """(rows, n) -> (vals (rows, k) fp32, idx (rows, k) int32), largest
    first, ties to the lowest index, NaN above +inf (NaNs by index).  On the
    card one launch: the row's chunks (``topk_chunk_plan``) select their k
    best and the row's last block merges them."""
    if x.dim() != 2 or not 0 < k <= x.shape[1]:
        raise ValueError(f"topk: k={k} over x{tuple(x.shape)}")
    if _device_of("topk", x) == "cpu":
        return ref.topk_ref(x, k)
    if x.dtype not in _DTYPES:
        raise ValueError(f"topk: dtype {x.dtype} not taken")
    _check_cuda("topk", x)
    rows, n = x.shape
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    chunk, n_chunks = topk_chunk_plan(rows, n, k, _sm_count(x.device))
    work = counters = None
    if n_chunks > 1:    # 64-bit candidate keys: two floats each
        work = _split_workspace(x.device, 2 * rows * n_chunks * k).data_ptr()
        counters = _arrival_counters(x.device, rows).data_ptr()
    build.call("topk", x.data_ptr(), _DTYPES[x.dtype], rows, n, k, chunk, vals.data_ptr(),
               idx.data_ptr(), work, counters, _stream())
    LAUNCHES["topk"] += 1
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
    if _device_of("dequant_matmul", x, q, scale) == "cpu":
        return ref.dequant_matmul_ref(x, q, scale, mode, group).to(out_dtype)
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or out_dtype not in _DTYPES:
        raise ValueError(f"dequant_matmul: dtypes x {x.dtype}, scale {scale.dtype}, "
                         f"out {out_dtype} not taken")
    # any alignment: the kernel takes 16-byte loads of q where the row allows
    # them (per-layer views of a stacked weight need not be 16-byte aligned)
    _check_cuda("dequant_matmul", x, q, scale, align=1)
    bits = 8 if mode == "int8" else 4
    group = group if bits == 4 else 0
    out = torch.empty((T, N), dtype=out_dtype, device=x.device)
    blocks, _, _, bn, bm, _ = dequant_split_plan(T, K, N, bits, group, _sm_count(x.device))
    work, counters = _matmul_split(x.device, T, N, blocks, bn, bm)
    build.call("dequant_matmul", x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
               _DTYPES[out_dtype], work, counters, blocks, T, K, N, bits, group, _stream())
    LAUNCHES["dequant_matmul"] += 1
    return out


def fused_dual_matmul(a: torch.Tensor, wa: torch.Tensor, b: torch.Tensor,
                      wb: torch.Tensor) -> torch.Tensor:
    """``a @ wa + b @ wb`` summed in fp32 and written once in a's type: a
    parallel-residual layer's attention out-projection and FFN
    down-projection partials in one output.  a (T, Ka), or attention heads
    (n, h, s, hd) read in place as the (n * s, h * hd) matrix of their
    transpose (the kernel addresses them by strides: no copy); wa (Ka, D) or
    (h, hd, D); b (T, Kb); wb (Kb, D) -> (T, D).  fp32 or bf16, all alike;
    any sizes and alignments."""
    if a.dim() == 4:
        n, h, s, hd = a.shape
    elif a.dim() == 2:
        n, h, s, hd = a.shape[0], 1, 1, a.shape[1]
    else:
        raise ValueError(f"fused_dual_matmul: a{tuple(a.shape)} is neither (T, Ka) nor heads")
    T, Ka = n * s, h * hd
    wa2 = wa.reshape(Ka, -1) if wa.dim() == 3 else wa
    D = wa2.shape[-1]
    if (wa2.shape != (Ka, D) or (wa.dim() == 3 and wa.shape[:2] != (h, hd)) or b.dim() != 2
            or b.shape[0] != T or wb.shape != (b.shape[1], D)):
        raise ValueError(f"fused_dual_matmul: shapes a{tuple(a.shape)} wa{tuple(wa.shape)} "
                         f"b{tuple(b.shape)} wb{tuple(wb.shape)} do not agree")
    if _device_of("fused_dual_matmul", a, wa, b, wb) == "cpu":
        a2 = a.transpose(1, 2).reshape(T, Ka) if a.dim() == 4 else a
        return ref.fused_dual_matmul_ref(a2, wa2, b, wb)
    if a.dtype not in _DTYPES or {wa.dtype, b.dtype, wb.dtype} != {a.dtype}:
        raise ValueError(f"fused_dual_matmul: dtypes {a.dtype}/{wa.dtype}/{b.dtype}/{wb.dtype}")
    # any alignment: the kernel takes 16-byte loads where a row allows them
    _check_cuda("fused_dual_matmul", a, wa2, b, wb, align=1)
    out = torch.empty((T, D), dtype=a.dtype, device=a.device)
    blocks, bn, bm, chunk = 1, 0, 0, 0   # fp32: the CUDA-core GEMM, one block a tile
    if a.dtype == torch.bfloat16:
        blocks, _, _, bn, bm, chunk = fused_split_plan(T, Ka, b.shape[1], D, _sm_count(a.device))
    work, counters = _matmul_split(a.device, T, D, blocks, bn, bm)
    build.call("fused_dual_matmul", a.data_ptr(), s, h, hd, wa2.data_ptr(), b.data_ptr(),
               wb.data_ptr(), out.data_ptr(), T, b.shape[1], D, _DTYPES[a.dtype], work,
               counters, blocks, chunk, _stream())
    LAUNCHES["fused_dual_matmul"] += 1
    return out


reset_launches()
