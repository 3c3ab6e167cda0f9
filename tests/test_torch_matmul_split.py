"""The arithmetic around the redesigned matmul kernels, on the CPU.

dequant_matmul and fused_dual_matmul run only on the card
(tests/test_torch_cuda.py); what surrounds them is held here:

* the exact conversions their A fragments use (csrc/gemm_sm90.cuh:
  ``i8_pair``, ``i4_pair``), emulated with integer ops on the bits, byte
  permutes included: every int8 byte and both nibbles of every int4 byte
  come out as their signed values in bf16;
* the split plans (``ops.gemm_split_plan``, ``ops.gemm_segments``,
  ``ops.fused_split_plan``) at every main-path shape and at ragged ones:
  every tile's K rows covered once, int4 parts on group boundaries, no
  block without work, at least 132 blocks where the work has that many
  units (an int8 / int4 prefill whose tiles fill half the SMs: one block a
  tile), and fused_dual_matmul's split rows the same at every T past 16;
* the merge the last block of a shared tile does: the parts added in block
  order equal an unsplit fp32 sum within 1e-6 of the largest output;
* the order of the int4 scales, sum_g s_g sum_{k in g} x_k q_k, then the
  parts merged, emulated in fp32 from seeded inputs at chip_smoke.py's
  DQ_CASES shapes (a sample of 256 columns), inside its dequant tolerance
  against ``ref.dequant_matmul_ref``.

    python tests/test_torch_matmul_split.py

prints that emulation's worst error and its margin under the tolerance at
each DQ_CASES shape.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from repro_torch.core import wquant
from repro_torch.kernels import ops, ref

SMS = 132

# -- the exact conversions ----------------------------------------------------


def _prmt(a: int, b: int, sel: int) -> int:
    """prmt.b32 in its default mode: byte n of the result is byte
    (sel >> 4n) & 7 of the 8 bytes {b, a} (a's low byte first), or that
    byte's sign bit replicated when bit 3 of the selector nibble is set."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for n in range(4):
        nib = (sel >> (4 * n)) & 0xF
        byte = src[nib & 7]
        if nib & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << (8 * n)
    return out


def _bf16_halves(word: int):
    """The two bf16 values (low half first) of a 32-bit word, as floats."""
    h = torch.tensor([word & 0xFFFF, word >> 16], dtype=torch.int32)
    return torch.where(h >= 0x8000, h - 0x10000, h).to(torch.int16).view(torch.bfloat16).float()


def _f32(bits: int) -> float:
    return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])


def _bits(f: float) -> int:
    return int(np.array([f], dtype=np.float32).view(np.uint32)[0])


def test_int8_pairs_are_exact():
    """Each byte b of a row, and of the next row, XOR 0x80 and placed under
    the exponent of 2^23 (selector 0x7540 | J), less 2^23 + 128 in fp32,
    then the upper halves of the two floats packed (selector 0x7632): the
    bf16 pair of the two signed values, for all 256 bytes in each of the
    four byte slots."""
    values = np.arange(-128, 128)
    for j in range(4):
        for lo in values:
            hi = -lo if lo > -128 else 127
            words = [(int(v) & 0xFF) << (8 * j) for v in (lo, hi)]
            f = [_f32(_prmt(w ^ 0x80808080, 0x4B000000, 0x7540 | j)) for w in words]
            f = [float(np.float32(x) - np.float32(8388736.0)) for x in f]
            assert f == [float(lo), float(hi)]
            pair = _prmt(_bits(f[0]), _bits(f[1]), 0x7632)
            assert _bf16_halves(pair).tolist() == [float(lo), float(hi)]


def test_int4_pairs_are_exact():
    """Each byte of a packed int4 word (even k in the low nibble, as
    wquant.pack4 stores it): its nibbles XOR 8 placed in bytes 0 and 2 of a
    word (selector J | 0x80 | (4 + J) << 8 | 0x8000, the zero bytes the sign
    of a byte below 0x80), OR-ed with bf16 0x4300 twice, less 136 twice in
    bf16: the signed values of the even and the odd k, for all 256 bytes."""
    q = torch.arange(-7, 8).repeat_interleave(15)
    pairs = torch.stack([q, torch.arange(-7, 8).repeat(15)], 1).reshape(-1, 1)  # (450, 1)
    packed = wquant.pack4(pairs.to(torch.int8))                              # (225, 1)
    every = torch.arange(256, dtype=torch.int32)
    for word_bytes, want in ((packed[:, 0].int(), pairs.reshape(-1, 2).float()),
                             (every, None)):
        for j in range(4):
            for n, byte in enumerate(word_bytes.tolist()):
                w = byte << (8 * j)
                lo = (w & 0x0F0F0F0F) ^ 0x08080808
                hi = ((w >> 4) & 0x0F0F0F0F) ^ 0x08080808
                v = _prmt(lo, hi, j | (0x8 << 4) | ((4 + j) << 8) | (0x8 << 12)) | 0x43004300
                got = _bf16_halves(v) - 136.0      # exact: integers in bf16
                even, odd = byte & 0xF, byte >> 4
                signed = [even - 16 if even > 7 else even, odd - 16 if odd > 7 else odd]
                assert got.tolist() == [float(x) for x in signed]
                if want is not None:
                    assert got.tolist() == want[n].tolist()


# -- the split plans ------------------------------------------------------------


def _dq_shapes():
    """(T, K, N, bits, group): the qwen-72b int4 and yi-9b int8 projections
    and heads at decode, verify, chunk and prefill widths, and ragged ones."""
    main = [(T, K, N, 4, 128) for T in (4, 20, 64, 500, 512)
            for K, N in ((8192, 24576), (24576, 8192), (8192, 8192), (8192, 1024),
                         (8192, 151936))]
    main += [(T, K, N, 8, 0) for T in (4, 8, 512) for K, N in ((4096, 11008), (11008, 4096),
                                                                 (4096, 64000), (4096, 512))]
    ragged = [(1, 200, 97, 8, 0), (17, 384, 97, 4, 64), (130, 1408, 520, 4, 128),
              (65, 384, 200, 4, 96), (3, 384, 200, 4, 6), (129, 384, 200, 4, 2)]
    return main + ragged


def _fdm_shapes():
    """(T, Ka, Kb, D): gptj-parallel's decode, verify, chunk and prefill
    widths, and the JAX sweep's odd shapes."""
    return ([(T, 4096, 16384, 4096) for T in (4, 8, 20, 64, 512, 1024)]
            + [(257, 129, 65, 33), (1, 64, 64, 64), (9, 64, 72, 136), (100, 300, 700, 200)])


def _check_plan(T, N, stages, unit, bn, bm, blocks, k_rows, ks, group=0, whole=False, chunk=0):
    """Every tile's stages covered exactly once; each block with work; parts
    that start on a unit (int4: a group) boundary; blocks as the plan
    promises.  k_rows(stage) -> the K rows it holds (range, first, end);
    ks: each range's K."""
    tiles = -(-T // bn) * -(-N // bm)
    units = -(-stages // unit)
    segs = ops.gemm_segments(T, N, stages, unit, bn, bm, blocks, chunk)
    assert len(segs) == blocks and all(segs)               # no block without work
    covered = np.zeros((tiles, stages), dtype=int)
    for block in segs:
        for tau, s0, s1 in block:
            assert s0 < s1 and s0 % unit == 0
            covered[tau, s0:s1] += 1
            if group:
                assert k_rows(s0)[1] % group == 0          # a group boundary
    assert (covered == 1).all()
    min_units = -(-ops.GEMM_MIN_STAGES // unit)
    if chunk:
        assert blocks == tiles * -(-stages // chunk)        # a block a chunk of a tile
    elif whole and 2 * tiles >= SMS:
        assert blocks == tiles                              # a block a tile
    else:
        assert blocks == min(SMS * ops.GEMM_BLOCKS_PER_SM, max(1, tiles * units // min_units))
        if tiles * units >= SMS * min_units:
            assert blocks >= SMS
    # the K rows of a tile's stages: each row once
    rows = [k_rows(s) for s in range(stages)]
    for r, K in enumerate(ks):
        spans = sorted((a, b) for rr, a, b in rows if rr == r)
        assert spans[0][0] == 0 and spans[-1][1] == K and all(a < b for a, b in spans)
        assert all(b == a2 for (_, b), (a2, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("T,K,N,bits,group", _dq_shapes())
def test_dequant_split_plan(T, K, N, bits, group):
    blocks, stages, unit, bn, bm, chunk = ops.dequant_split_plan(T, K, N, bits, group, SMS)
    assert chunk == 0
    bk, bn2, bm2 = ops.gemm_tile("int8" if bits == 8 else "int4", T, group)
    assert (bn, bm) == (bn2, bm2) and stages == -(-K // bk)
    assert T > ops.GEMM_NARROW_T or bn >= T
    if bits == 4:
        assert (unit * bk) % group == 0 and unit * bk == math.lcm(group, bk)
    _check_plan(T, N, stages, unit, bn, bm, blocks,
                lambda s: (0, s * bk, min(K, (s + 1) * bk)), [K], group, whole=bn == 128)


@pytest.mark.parametrize("T,Ka,Kb,D", _fdm_shapes())
def test_fused_split_plan(T, Ka, Kb, D):
    blocks, stages, unit, bn, bm, chunk = ops.fused_split_plan(T, Ka, Kb, D, SMS)
    bk = ops.gemm_tile("bf16", T)[0]
    assert chunk > 0
    sa = -(-Ka // bk)
    assert stages == sa + -(-Kb // bk) and unit == 1

    def k_rows(s):
        return (0, s * bk, min(Ka, (s + 1) * bk)) if s < sa else \
               (1, (s - sa) * bk, min(Kb, (s - sa + 1) * bk))

    _check_plan(T, D, stages, unit, bn, bm, blocks, k_rows, [Ka, Kb], chunk=chunk)


def test_fused_rows_sum_alike_at_every_width():
    """Every fused_dual_matmul instance splits a tile's K at the same rows,
    whatever T: a row's sums are the same bits in a decode step, a verify
    step, a mixed step or a prefill of one prompt or of four, whole or after
    a cached prefix (the slot schedulers then agree, as chip_smoke.py
    checks)."""
    def splits(T):
        blocks, stages, unit, bn, bm, chunk = ops.fused_split_plan(T, 4096, 16384, 4096, SMS)
        bk = ops.gemm_tile("bf16", T)[0]
        first = ops.gemm_segments(T, 4096, stages, unit, bn, bm, blocks, chunk)
        return sorted({(s0 * bk, s1 * bk) for segs in first for tau, s0, s1 in segs if tau == 0})

    want = splits(1)
    assert len(want) == ops.FDM_CHUNKS
    for T in (4, 8, 9, 17, 20, 33, 64, 65, 128, 192, 256, 512):
        assert splits(T) == want


def test_main_shapes_fill_the_card():
    """A decode step's dequant_matmul calls run 264 blocks, two an SM, each
    reading rows of 512 bytes of weight; T pads to the narrow instances' 8,
    16, 32 or 64 rows; an int8 / int4 prefill takes the wgmma tiles, one
    block a tile, except int4 groups of no whole 64-row stage;
    fused_dual_matmul takes FDM_CHUNKS blocks a tile at every T."""
    for T, want in ((1, 8), (4, 8), (8, 8), (9, 16), (20, 32), (33, 64), (64, 64)):
        assert ops.gemm_tile("int4", T)[1] == want
    assert ops.gemm_tile("int4", 4) == (64, 8, 512) and ops.gemm_tile("bf16", 4) == (64, 8, 128)
    assert ops.gemm_tile("bf16", 65) == (64, 128, 128)
    assert ops.gemm_tile("int8", 65) == (64, 128, 128) == ops.gemm_tile("int4", 512, 128)
    assert ops.gemm_tile("int4", 512, 6) == ops.gemm_tile("int4", 512, 32) == (128, 64, 128)
    assert ops.dequant_split_plan(512, 24576, 8192, 4, 128, SMS)[0] == 4 * 64
    assert ops.dequant_split_plan(4, 8192, 24576, 4, 128, SMS)[0] == 264
    assert ops.fused_split_plan(4, 4096, 16384, 4096, SMS)[0] == 32 * ops.FDM_CHUNKS
    assert ops.fused_split_plan(512, 4096, 16384, 4096, SMS)[0] == 128 * ops.FDM_CHUNKS


# -- the merge of the parts -----------------------------------------------------


def _parts_sum(x, w, bk, T, N, blocks, stages, unit, bn, bm):
    """The kernel's order: each segment's fp32 sum over its stages, a tile's
    parts added in block order (a tile one block covers written as is)."""
    out = np.zeros((T, N), dtype=np.float32)
    parts = {}
    for block in ops.gemm_segments(T, N, stages, unit, bn, bm, blocks):
        for tau, s0, s1 in block:
            parts.setdefault(tau, []).append((s0, s1))
    t_tiles = -(-T // bn)
    for tau, segs in parts.items():
        t0, n0 = (tau % t_tiles) * bn, (tau // t_tiles) * bm
        rows, cols = slice(t0, min(T, t0 + bn)), slice(n0, min(N, n0 + bm))
        acc = np.zeros((rows.stop - rows.start, cols.stop - cols.start), dtype=np.float32)
        for s0, s1 in segs:
            k = slice(s0 * bk, min(x.shape[1], s1 * bk))
            acc = acc + (x[rows, k] @ w[k, cols]).astype(np.float32)
        out[rows, cols] = acc
    return out


@pytest.mark.parametrize("T,K,N", [(4, 8192, 384), (20, 4096, 300), (64, 2048, 640)])
def test_merge_order_equals_an_unsplit_sum(T, K, N):
    rng = np.random.default_rng(T + K)
    x = rng.standard_normal((T, K), dtype=np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.float32)
    blocks, stages, unit, bn, bm, _ = ops.dequant_split_plan(T, K, N, 8, 0, SMS)
    assert blocks > -(-T // bn) * -(-N // bm)              # tiles are shared
    got = _parts_sum(x, w, ops.gemm_tile("int8", T)[0], T, N, blocks, stages, unit, bn, bm)
    want = (x.astype(np.float64) @ w.astype(np.float64)).astype(np.float32)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


# -- the order of the int4 scales -----------------------------------------------


def _dq_cases():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(what, mode, T, K, N, dt == torch.float32) for what, mode, T, K, N, dt in mod.DQ_CASES]


COLS = 256      # output columns sampled: each column's sums are independent


def _emulate(x, w, mode, T, K, N):
    """The kernel's order in fp32 on a sample of columns: int4 per-group
    sums, each added as fma(scale, sum, total); int8 the sum times the
    column scale; the parts of shared tiles merged in block order."""
    bits = 8 if mode == "int8" else 4
    blocks, stages, unit, bn, bm, _ = ops.dequant_split_plan(T, K, N, bits, w.group, SMS)
    bk = ops.gemm_tile(mode, T)[0]
    xf = x.float()
    qf = (w.q.float() if bits == 8 else wquant.unpack4(w.q).float())
    sf = w.scale.float()
    # per segment (tile columns are sampled: the sample's own tiles' parts)
    segs = {}
    for block in ops.gemm_segments(T, N, stages, unit, bn, bm, blocks):
        for tau, s0, s1 in block:
            segs.setdefault(tau, []).append((s0, s1))
    t_tiles = -(-T // bn)
    out = torch.zeros((T, COLS), dtype=torch.float32)
    for tau, parts in segs.items():
        n0 = (tau // t_tiles) * bm
        if n0 >= COLS:
            continue
        t0 = (tau % t_tiles) * bn
        rows, cols = slice(t0, min(T, t0 + bn)), slice(n0, min(COLS, n0 + bm))
        total = None
        for s0, s1 in parts:
            k0, k1 = s0 * bk, min(K, s1 * bk)
            if bits == 8:
                acc = xf[rows, k0:k1] @ qf[k0:k1, cols]
            else:
                acc = torch.zeros((rows.stop - rows.start, cols.stop - cols.start), dtype=torch.float64)
                for g in range(k0 // w.group, k1 // w.group):
                    ks = slice(g * w.group, (g + 1) * w.group)
                    part = (xf[rows, ks] @ qf[ks, cols]).double()
                    acc = (acc + sf[g, cols].double() * part).float().double()   # one rounding: fma
                acc = acc.float()
            total = acc if total is None else total + acc
        if bits == 8:
            total = total * sf[cols]
        out[rows, cols] = total
    return out


def _scale_order_margin(what, mode, T, K, N, f32_out):
    # the sampled columns alone: a column's scales depend on it only
    gen = torch.Generator().manual_seed(T * 7 + K)
    w = wquant.quantize((torch.randn((K, COLS), generator=gen) * K ** -0.5).bfloat16(), mode, 128)
    x = torch.randn((T, K), generator=gen).bfloat16()
    want = ref.dequant_matmul_ref(x, w.q, w.scale, mode, w.group)
    got = _emulate(x, w, mode, T, K, N)
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs()
    if not f32_out:    # chip_smoke's bf16 rule: one bf16 ulp at want, plus tol
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
        err = (got.bfloat16().float() - want).abs() - ulp
    return err.max().item(), tol


@pytest.mark.parametrize("case", _dq_cases(), ids=lambda c: c[0])
def test_scale_order_within_the_dequant_tolerance(case):
    err, tol = _scale_order_margin(*case)
    assert err <= tol


if __name__ == "__main__":
    for case in _dq_cases():
        err, tol = _scale_order_margin(*case)
        print(f"{case[0]}: worst error {err:.3e} against tolerance {tol:.3e} "
              f"(margin {tol - err:.3e}, {err / tol:.3f} of it)")
