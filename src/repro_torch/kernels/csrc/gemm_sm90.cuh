// The GEMM shared by dequant_matmul.cu and fused_dual_matmul.cu: out (T, N)
// = sum over one or two K ranges of x_r (T, K_r) @ W_r (K_r, N), x in
// bf16, the weight streamed from device memory once, in bf16, int8 or
// packed int4, summed in fp32 on the tensor cores.
//
// Both callers multiply a thin or wide activation by a weight read once, so
// one design serves both; each picks a weight mode and a block shape (Cfg).
//
//  * The weight is the M side of the products (out^T = W^T x^T), so a
//    decode step's T = 4 pads to one n8 tile, not to a 16-row m tile.  A
//    block owns BM weight columns (WM warps of MT m16 tiles) and BN tokens
//    (WN warps of NT n8 tiles).  mma.sync m16n8k16, or for the wide int8 /
//    int4 tile wgmma m64n128k16 (WG): two warpgroups of 64 columns by 128
//    tokens, A from registers, x from shared memory in 8 x 16-byte core
//    matrices.  bf16 operands, fp32 sums.
//  * A fragments.  bf16 weights: ldmatrix.trans from the [k][n] tile.
//    int8 and int4 weights are converted in registers, exactly: the A
//    register of pair (k, k + 1) of row n is two bytes q[k][n], q[k+1][n]
//    (int8) or the two nibbles of one byte q[k/2][n] (int4: even k in the
//    low nibble).  A lane group's 2 MT rows are 2 MT adjacent columns, so
//    one 2-, 4- or 8-byte shared load gives a byte for each of them: the M
//    rows are those columns in the order 2 MT (lane / 4) + 2 i + h (m16
//    tile i, half h), and the epilogue writes them back in place.
//    int8 byte b: the float 2^23 + (b ^ 0x80) made by a byte permute, less
//    2^23 + 128, is the signed value; its upper 16 bits are its bf16.
//    int4 nibble p: bf16 0x4300 | (p ^ 8) is 136 + n, so one bf16x2 fma
//    (x 1, - 136) gives both nibbles' signed values.  Both are exact:
//    |n| <= 127 has 8 significant bits, and its product with a bf16 x is
//    exact in fp32.
//  * Scales.  int8's column scale multiplies the fp32 sum once, at the end
//    (as the reference does).  int4's group scale multiplies each group's
//    fp32 partial, which is then added to the total: sum_g s_g sum_{k in g}
//    x_k q_k, the scales of the next group loaded a group ahead.  A group
//    that is no whole number of 16-row steps is taken by masking the A
//    registers of the other groups, one product per group a step meets
//    (mma.sync only; wgmma takes groups of whole stages, flushed after the
//    stage's products are awaited, so that no other instruction writes
//    their accumulators while they run).
//  * Stages.  Each block streams its weight slab and the matching x tile
//    through a ring of STAGES shared-memory stages filled by cp.async
//    (16-byte copies, zero-filled past the matrix's edges), AHEAD of them in
//    flight while one is multiplied: 48-64 KB of weight a block, two blocks
//    an SM (wgmma: one, ~190 KB, and one stage fewer in flight, since the
//    products of the previous stage may still read it).  Rows that are not
//    16-byte aligned (an unaligned per-layer view, a head_dim that is no
//    multiple of 8) take a narrower path of the same kernel: element loads
//    stored to the same stage.  x's row offsets (heads read by strides) are
//    worked out once a tile, into shared memory.
//  * Split K.  The work, ceil(T / BN) * ceil(N / BM) tiles of `stages` K
//    stages in units of `unit` stages (int4: whole groups), is shared
//    evenly by the caller's `blocks` blocks (ops.gemm_split_plan: two an
//    SM, so that one wave keeps every SM streaming; one a tile for the
//    wgmma tiles): block b owns units [b W / G, (b + 1) W / G) of the W
//    units, tile after tile, cut at tile edges into segments.  A block
//    that covers a whole tile writes it; one that covers a part writes its
//    fp32 part to the workspace, makes it visible (__threadfence) and adds
//    one to the tile's arrival counter; the block that arrives last adds
//    the parts in block order, applies the int8 scale, casts, writes the
//    output and sets the counter back to 0.  One launch, and two calls give
//    the same bits.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace gemm {

enum Mode { W_BF16 = 0, W_INT8 = 1, W_INT4 = 2 };

// x of one K range: row t, column k at
// (t / s) * h * s * hd + (t % s) * hd + (k / hd) * s * hd + k % hd, the
// heads (n, h, s, hd) read as the (n * s, h * hd) matrix; a plain (T, K)
// matrix is s = 1, h = 1, hd = K
struct XLayout {
  int s, h, hd;
};

__device__ __forceinline__ size_t x_row(const XLayout& L, int t) {
  return (size_t)(t / L.s) * L.h * L.s * L.hd + (size_t)(t % L.s) * L.hd;
}

__device__ __forceinline__ size_t x_col(const XLayout& L, int k) {
  return (size_t)(k / L.hd) * L.s * L.hd + k % L.hd;
}

struct Range {
  const __nv_bfloat16* x;
  XLayout lx;
  const uint8_t* w;  // (K, N) bf16 or int8, or (K / 2, N) packed int4
  int K;
  bool x_vec, w_vec;  // 16-byte copies: rows and base aligned
};

struct Params {
  Range r[2];
  int stages_a, stages;  // range 0's stages; both ranges'
  int unit;              // stages in a unit of the split (int4: whole groups)
  int chunk;             // > 0: each tile split at every chunk stages (see body)
  const __nv_bfloat16* scale;  // int8 (N,), int4 (K / group, N); else null
  int group;
  void* out;
  bool out_f32;
  int T, N;
  float* work;    // (blocks, 2, BN, BM) fp32 partials of the tiles a block shares
  int* counters;  // one per tile, zero between launches
};

// A stage's weight tile of BM columns in padded rows of `STRIDE` bytes:
// bf16 rows padded by 16 bytes (ldmatrix rows land on distinct banks),
// int8 / int4 rows by 16 / 32 so that a warp's loads of rows 2c (+1, +8,
// +9) or c (+4) at columns 2 MT (lane / 4) hit distinct banks.
template <int MODE, int BK, int BM>
struct WTile {
  static constexpr int ROWS = MODE == W_INT4 ? BK / 2 : BK;
  static constexpr int STRIDE = MODE == W_BF16 ? 2 * BM + 16 : (MODE == W_INT8 ? BM + 16 : BM + 32);
  static constexpr int BYTES = ROWS * STRIDE;
  static constexpr int CHUNKS_PER_ROW = (MODE == W_BF16 ? 2 * BM : BM) / 16;
  static constexpr int ESZ = MODE == W_BF16 ? 2 : 1;  // bytes a column of a stored row
};

// A block: WM x WN warps, each MT m16 tiles of weight columns by NT n8
// tiles of tokens; BK K rows a stage; MINB blocks an SM for the compiler.
// WG: the products are wgmma m64n128k16, two warpgroups of 64 columns each
// (WM 8, MT 1, NT 16), x and bf16 weights in core-matrix tiles.
template <int MODE_, int WM_, int MT_, int WN_, int NT_, int BK_, int MINB_, bool WG_ = false>
struct Cfg {
  static constexpr int MODE = MODE_, WM = WM_, MT = MT_, WN = WN_, NT = NT_, BK = BK_;
  static constexpr int MINB = MINB_;
  static constexpr bool WG = WG_;
  static constexpr int WARPS = WM * WN, THREADS = 32 * WARPS;
  static constexpr int BM = WM * MT * 16;  // weight columns a block
  static constexpr int BN = WN * NT * 8;   // tokens a block
  using W = WTile<MODE, BK, BM>;
  static constexpr int XSTRIDE = BK + 8;  // bf16 elements; rows off the same banks
  static constexpr int X_BYTES = WG ? BN * BK * 2 : BN * XSTRIDE * 2;
  // byte offset of x's 8 columns from kc (a multiple of 8) of row tr:
  // padded rows, or core matrices [t / 8][k / 8][t % 8]
  __device__ static int x_off(int tr, int kc) {
    return WG ? ((tr & 7) + 8 * ((kc >> 3) + (BK / 8) * (tr >> 3))) * 16 : (tr * XSTRIDE + kc) * 2;
  }
  static constexpr int STAGE_BYTES = W::BYTES + X_BYTES;
  // as many stages as fit ~96 KB (two blocks an SM; ~192 KB, one, for
  // wgmma), 3 to 8
  static constexpr int STAGES_FIT = (WG ? 196608 : 98304) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 3 ? 3 : (STAGES_FIT > 8 ? 8 : STAGES_FIT);
  static constexpr int CSTRIDE = BM + 4;  // the fp32 output tile's row stride
  static constexpr int C_BYTES = BN * CSTRIDE * 4;
  // cp.async stages in flight while one is multiplied: one fewer for
  // wgmma, whose products of stage i - 1 may still read it while i is issued
  static constexpr int AHEAD = WG ? STAGES - 2 : STAGES - 1;
  // the stages (or the output tile), then x's row offsets of both ranges
  static constexpr int ROWS_AT = STAGES * STAGE_BYTES > C_BYTES ? STAGES * STAGE_BYTES : C_BYTES;
  static constexpr int SMEM = ROWS_AT + 2 * BN * 8;
  static_assert(BK % 16 == 0 && BM % 128 == 0 && (MT == 1 || MT == 2 || MT == 4) && STAGES >= 2,
                "tile shape");
  static_assert(!WG || (WM == 8 && MT == 1 && WN == 1 && NT == 16 && MODE != W_BF16),
                "wgmma tile shape");
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, of which the first `bytes` are read and the
// rest zero-filled (0: all zeros, src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c[0..3] += A B for one m16n8k16 tile, c the tile's 4 accumulators
__device__ __forceinline__ void mma(float* c, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma: a shared-memory matrix descriptor (no swizzle: 8 x 16-byte core
// matrices, `lbo` bytes between the two along K, `sbo` between neighbours
// along M or N)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// orders a register around the asynchronous products (it is read or
// written only after the wait, before the next fence)
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
// shared-memory stores by this thread seen by wgmma's reads (cp.async's
// writes need no fence once waited for)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 128 fp32, d[4j + e] as an mma.sync n8 tile j) += A (64 x 16) B (16 x
// 128): A bf16 in registers, the fragments of mma.sync m16n8k16 A (warp w of
// the warpgroup holding rows 16w..16w+15), B bf16 in shared memory (a
// K-major descriptor)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---------------------------------------------------------------------------
// Exact conversions to bf16 pairs
// ---------------------------------------------------------------------------

// prmt.b32 in its default mode: byte n of the result is byte (sel >> 4n) & 7
// of {b, a}, or that byte's sign replicated when bit 3 of the nibble is set
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// bytes J of lo_row and hi_row (signed int8 values; the words already XOR-ed
// with 0x80808080, so byte u = n + 128) -> bf16x2 (n_lo, n_hi)
template <int J>
__device__ __forceinline__ uint32_t i8_pair(uint32_t lo_row, uint32_t hi_row) {
  constexpr uint32_t SEL = 0x7540u | J;  // [byte J, 0, 0, 0x4B]: the float 2^23 + u
  const float lo = __uint_as_float(prmt(lo_row, 0x4B000000u, SEL)) - 8388736.f;
  const float hi = __uint_as_float(prmt(hi_row, 0x4B000000u, SEL)) - 8388736.f;
  return prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);  // the upper halves
}

// byte J of a word of two signed nibbles (even k low) -> bf16x2 (n_even,
// n_odd).  lo / hi: the word's low / high nibbles XOR 8, one a byte.
template <int J>
__device__ __forceinline__ uint32_t i4_pair(uint32_t lo, uint32_t hi) {
  // [lo byte J, 0, hi byte J, 0]: the zeros are the sign of lo's byte 0 (< 0x80)
  constexpr uint32_t SEL = J | (0x8u << 4) | ((4u + J) << 8) | (0x8u << 12);
  const uint32_t v = prmt(lo, hi, SEL) | 0x43004300u;  // bf16 136 + n, twice
  uint32_t r;  // v * 1 - 136, exact
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// ---------------------------------------------------------------------------
// A fragments of one warp's 32 weight rows for one 16-row K step
// ---------------------------------------------------------------------------

// a[i] for m16 tile i, from the stage's weight tile `ws` (row stride S
// bytes), K step `kk` (stage-local, a multiple of 16), the warp's columns
// from `wm`.  int8 / int4: lane group g owns the 2 MT adjacent columns
// wm + 2 MT g + j, j = 2i + h (tile i, row g or g + 8), one 2-, 4- or
// 8-byte load a row.
template <int MODE, int MT, int S>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][4], const uint8_t* ws, int kk, int wm,
                                       int lane) {
  const int g = lane >> 2, c = lane & 3;
  if constexpr (MODE == W_BF16) {
    // 8 x 8 matrices (k rows of 8 columns n), transposed: a0 (n 0-7, k 0-7),
    // a1 (n 8-15, k 0-7), a2 (n 0-7, k 8-15), a3 (n 8-15, k 8-15)
    const int m = lane >> 3, k = kk + (lane & 7) + (m >> 1) * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4_trans(a[i], ws + k * S + (wm + 16 * i + (m & 1) * 8) * 2);
  } else if constexpr (MT == 1) {
    // 2 columns: one 16-bit load a row, bytes 0 and 1 rows g and g + 8
    const uint8_t* p = ws + wm + 2 * g;
    auto row = [&](int rr) { return (uint32_t)*reinterpret_cast<const uint16_t*>(p + rr * S); };
    if constexpr (MODE == W_INT8) {
      const uint32_t r0 = row(kk + 2 * c) ^ 0x8080u, r1 = row(kk + 2 * c + 1) ^ 0x8080u;
      const uint32_t r8 = row(kk + 2 * c + 8) ^ 0x8080u, r9 = row(kk + 2 * c + 9) ^ 0x8080u;
      a[0][0] = i8_pair<0>(r0, r1); a[0][1] = i8_pair<1>(r0, r1);
      a[0][2] = i8_pair<0>(r8, r9); a[0][3] = i8_pair<1>(r8, r9);
    } else {
      const uint32_t u = row(kk / 2 + c), v = row(kk / 2 + c + 4);
      const uint32_t ul = (u & 0x0F0Fu) ^ 0x0808u, uh = ((u >> 4) & 0x0F0Fu) ^ 0x0808u;
      const uint32_t vl = (v & 0x0F0Fu) ^ 0x0808u, vh = ((v >> 4) & 0x0F0Fu) ^ 0x0808u;
      a[0][0] = i4_pair<0>(ul, uh); a[0][1] = i4_pair<1>(ul, uh);
      a[0][2] = i4_pair<0>(vl, vh); a[0][3] = i4_pair<1>(vl, vh);
    }
  } else {
    constexpr int WORDS = MT / 2;  // 4 columns a word
    uint32_t r[4][WORDS];          // int8: rows 2c, 2c + 1, 2c + 8, 2c + 9; int4: rows c, c + 4
    const uint8_t* p = ws + wm + 2 * MT * g;
    auto row = [&](int rr, uint32_t (&w)[WORDS]) {
      if constexpr (WORDS == 1) {
        w[0] = *reinterpret_cast<const uint32_t*>(p + rr * S);
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(p + rr * S);
        w[0] = v.x;
        w[1] = v.y;
      }
    };
    if constexpr (MODE == W_INT8) {
      row(kk + 2 * c, r[0]); row(kk + 2 * c + 1, r[1]); row(kk + 2 * c + 8, r[2]); row(kk + 2 * c + 9, r[3]);
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q][w] ^= 0x80808080u;
        // byte j = 2i + h of each word is row h of tile 2w + j / 2
        a[2 * w][0] = i8_pair<0>(r[0][w], r[1][w]); a[2 * w][1] = i8_pair<1>(r[0][w], r[1][w]);
        a[2 * w][2] = i8_pair<0>(r[2][w], r[3][w]); a[2 * w][3] = i8_pair<1>(r[2][w], r[3][w]);
        a[2 * w + 1][0] = i8_pair<2>(r[0][w], r[1][w]); a[2 * w + 1][1] = i8_pair<3>(r[0][w], r[1][w]);
        a[2 * w + 1][2] = i8_pair<2>(r[2][w], r[3][w]); a[2 * w + 1][3] = i8_pair<3>(r[2][w], r[3][w]);
      }
    } else {
      row(kk / 2 + c, r[0]);      // k pair 2c
      row(kk / 2 + c + 4, r[1]);  // k pair 2c + 8
#pragma unroll
      for (int w = 0; w < WORDS; ++w) {
        const uint32_t ul = (r[0][w] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t uh = ((r[0][w] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t vl = (r[1][w] & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t vh = ((r[1][w] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        a[2 * w][0] = i4_pair<0>(ul, uh); a[2 * w][1] = i4_pair<1>(ul, uh);
        a[2 * w][2] = i4_pair<0>(vl, vh); a[2 * w][3] = i4_pair<1>(vl, vh);
        a[2 * w + 1][0] = i4_pair<2>(ul, uh); a[2 * w + 1][1] = i4_pair<3>(ul, uh);
        a[2 * w + 1][2] = i4_pair<2>(vl, vh); a[2 * w + 1][3] = i4_pair<3>(vl, vh);
      }
    }
  }
}

// The warp-local M row of tile i, half h (row g or g + 8) for lane group g:
// bf16 keeps the columns in order, int8 / int4 give each lane group 2 MT
// adjacent columns.
template <bool NATURAL, int MT>
__device__ __forceinline__ int m_row(int i, int h, int g) {
  return NATURAL ? 16 * i + 8 * h + g : 2 * MT * g + 2 * i + h;
}

// ---------------------------------------------------------------------------
// Stage loads
// ---------------------------------------------------------------------------

// The stage sequence: range 0's ceil(K0 / BK) stages, then range 1's.
// Stage c -> its range (picked field by field: a dynamic index into the
// kernel's parameters would copy them to local memory), first K row and
// row count.
__device__ __forceinline__ Range stage_range(const Params& p, int c, int BK, int& k0, int& kn) {
  const bool second = c >= p.stages_a;
  Range R;
  R.x = second ? p.r[1].x : p.r[0].x;
  R.lx = second ? p.r[1].lx : p.r[0].lx;
  R.w = second ? p.r[1].w : p.r[0].w;
  R.K = second ? p.r[1].K : p.r[0].K;
  R.x_vec = second ? p.r[1].x_vec : p.r[0].x_vec;
  R.w_vec = second ? p.r[1].w_vec : p.r[0].w_vec;
  k0 = (second ? c - p.stages_a : c) * BK;
  kn = min(BK, R.K - k0);
  return R;
}

// Stage c into `stage`: its weight rows and the x tile.  xrows: x's row
// offsets of rows t0.. in range 0, then range 1 (shared memory).
template <class C>
__device__ __forceinline__ void load_stage(const Params& p, uint8_t* stage, int c, int t0, int n0,
                                           int tid, const size_t* xrows) {
  using W = typename C::W;
  int k0, kn;
  const Range R = stage_range(p, c, C::BK, k0, kn);
  const size_t* rows_r = xrows + (c >= p.stages_a ? C::BN : 0);
  // x's column offset of k0 + kc: k itself for one position a head (s 1),
  // one head's base for the stage when a stage never straddles two heads
  const XLayout& L = R.lx;
  const bool one_head = L.s == 1 || L.hd % C::BK == 0;
  const size_t cbase = L.s == 1 ? (size_t)k0 : (size_t)(k0 / L.hd) * L.s * L.hd + k0 % L.hd;
  // weight rows [k0, k0 + kn) (packed int4: [k0 / 2, (k0 + kn) / 2))
  {
    const int row0 = C::MODE == W_INT4 ? k0 / 2 : k0, rows = C::MODE == W_INT4 ? kn / 2 : kn;
    const size_t pitch = (size_t)p.N * W::ESZ;
    constexpr int TOTAL = W::ROWS * W::CHUNKS_PER_ROW;
#pragma unroll
    for (int j = 0; j < (TOTAL + C::THREADS - 1) / C::THREADS; ++j) {
      const int id = tid + j * C::THREADS;
      if (TOTAL % C::THREADS && id >= TOTAL) break;
      const int kr = id / W::CHUNKS_PER_ROW, cc = id % W::CHUNKS_PER_ROW;
      const int n = n0 + cc * (16 / W::ESZ);  // first column of the chunk
      uint8_t* dst = stage + kr * W::STRIDE + cc * 16;
      const int bytes = kr < rows && n < p.N ? min(16, (p.N - n) * W::ESZ) : 0;
      const uint8_t* src = R.w + (row0 + kr) * pitch + (size_t)n * W::ESZ;
      if (R.w_vec) {
        cp_async16(dst, bytes ? src : R.w, bytes);
      } else {  // element loads (2-byte elements for bf16), zeros past the edge
        union {
          uint4 u;
          uint16_t h[8];
          uint8_t b[16];
        } v;
        v.u = make_uint4(0, 0, 0, 0);
        if constexpr (W::ESZ == 2) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (2 * e < bytes) v.h[e] = reinterpret_cast<const uint16_t*>(src)[e];
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (e < bytes) v.b[e] = src[e];
        }
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
  }
  // x rows [t0, t0 + BN), columns [k0, k0 + kn) of the range
  {
    uint8_t* xs = stage + W::BYTES;
    constexpr int CPR = C::BK / 8, TOTAL = C::BN * CPR;
#pragma unroll
    for (int j = 0; j < (TOTAL + C::THREADS - 1) / C::THREADS; ++j) {
      const int id = tid + j * C::THREADS;
      if (TOTAL % C::THREADS && id >= TOTAL) break;
      // core matrices: neighbouring threads fill neighbouring 16 bytes (8
      // rows of one column chunk), else rows of 16-byte chunks
      const int tr = C::WG ? id / C::BK * 8 + (id & 7) : id / CPR;
      const int kc = (C::WG ? (id >> 3) % CPR : id % CPR) * 8, t = t0 + tr;
      uint8_t* dst = xs + C::x_off(tr, kc);
      const int valid = t < p.T ? min(8, kn - kc) : 0;
      if (R.x_vec) {
        const __nv_bfloat16* src =
            valid > 0 ? R.x + rows_r[tr] + (one_head ? cbase + kc : x_col(L, k0 + kc)) : R.x;
        cp_async16(dst, src, valid > 0 ? 2 * valid : 0);
      } else {
        union {
          uint4 u;
          uint16_t h[8];
        } v;
        v.u = make_uint4(0, 0, 0, 0);
        if (valid > 0) {
          const uint16_t* xb = reinterpret_cast<const uint16_t*>(R.x) + rows_r[tr];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < valid) v.h[e] = xb[L.s == 1 ? k0 + kc + e : x_col(L, k0 + kc + e)];
        }
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
  }
  // plain stores seen by wgmma (cp.async's writes need no fence once awaited)
  if (C::WG && !(R.x_vec && R.w_vec)) fence_proxy_async();
}

// ---------------------------------------------------------------------------
// The body
// ---------------------------------------------------------------------------

// int4: the scales of group gi for the lane's J columns from n (0 past N)
template <int J>
__device__ __forceinline__ void group_scales(const Params& p, int gi, int n, float (&s)[J]) {
  const __nv_bfloat16* row = p.scale + (size_t)gi * p.N;
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = n + j < p.N ? __bfloat162float(__ldg(row + n + j)) : 0.f;
}

__device__ __forceinline__ int cdiv_d(int a, int b) { return (a + b - 1) / b; }

// The block that owns unit u of the W units shared evenly by G blocks
// (block b owns [b W / G, (b + 1) W / G)).
__device__ __forceinline__ int owner(long u, long W, long G) {
  return static_cast<int>(((u + 1) * G - 1) / W);
}

// One segment of a block's share: stages [s_begin, s_end) of tile `tau`,
// multiplied into registers, then written out (b_lo == b_hi: the block
// covers the whole tile) or merged with the tile's other parts, those of
// blocks b_lo..b_hi (the last to arrive adds them in block order; b_lo's is
// in its pair's slot lo_slot).  `first`: the segment starts the block's
// share (its part goes to slot 0 of its pair, else 1).
template <class C>
__device__ __forceinline__ void segment(const Params& p, uint8_t* smem, int tau, int s_begin,
                                        int s_end, bool first, int b_lo, int b_hi, int lo_slot) {
  constexpr int MODE = C::MODE, MT = C::MT, NT = C::NT, BK = C::BK, BM = C::BM;
  constexpr int STAGES = C::STAGES, NACC = MT * NT * 4;
  using W_ = typename C::W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int t_tiles = cdiv_d(p.T, C::BN);
  const int t0 = (tau % t_tiles) * C::BN, n0 = (tau / t_tiles) * BM;
  const int wm = (warp % C::WM) * MT * 16, wn = (warp / C::WM) * NT * 8;
  const int n_st = s_end - s_begin;

  // acc[(i NT + j) 4 + e]: tile i, n8 tile j, element e of an mma.sync C
  // fragment (for wgmma, i = 0 and the 16 n8 tiles of its 128 columns);
  // int4: part is the current group's sum
  float acc[NACC], part[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = part[q] = 0.f;
  const int n_lane = n0 + wm + 2 * MT * g;  // int4: the lane's first column
  // int4 groups of whole 16-row steps: the step within the group, the group,
  // its scales and the next group's, loaded a group ahead (a segment starts
  // on a group boundary, and every stage holds whole steps); other groups
  // (not on wgmma) take one product per group a step meets
  const bool fine = !C::WG && MODE == W_INT4 && p.group % 16 != 0;
  const int gsteps = MODE == W_INT4 && !fine ? p.group / 16 : 1;
  int gstep = 0, gidx = MODE == W_INT4 && !fine ? s_begin * BK / p.group : 0;
  float sc[2 * MT], sn[2 * MT];
#pragma unroll
  for (int j = 0; j < 2 * MT; ++j) sc[j] = sn[j] = 0.f;
  if (MODE == W_INT4 && !fine) group_scales(p, gidx, n_lane, sc);

  // acc += s * part over the lane's rows (row 2 MT g + 2i + h is column n_lane + 2i + h)
  auto flush = [&](const float (&s)[2 * MT]) {
#pragma unroll
    for (int q = 0; q < NACC; ++q) {
      acc[q] = fmaf(s[2 * (q / (4 * NT)) + (q & 3) / 2], part[q], acc[q]);
      part[q] = 0.f;
    }
  };
  // int4, whole groups: after a step's products, the group's end
  // int4, whole groups: after `steps` 16-row steps' products, the group's
  // end (wgmma: at a stage's end, the products awaited, so that no other
  // instruction writes their accumulators while they run)
  auto step_done = [&](int K, int steps) {
    if (gstep == 0 && (gidx + 1) * p.group < K)
      group_scales(p, gidx + 1, n_lane, sn);
    gstep += steps;
    if (gstep == gsteps) {
      flush(sc);
#pragma unroll
      for (int j = 0; j < 2 * MT; ++j) sc[j] = sn[j];
      gstep = 0;
      ++gidx;
    }
  };

  // x's row offsets for this tile, both ranges
  size_t* xrows = reinterpret_cast<size_t*>(smem + C::ROWS_AT);
  const int n_rows = p.stages > p.stages_a ? 2 * C::BN : C::BN;  // one range or two
  for (int i = tid; i < n_rows; i += C::THREADS) {
    const int t = t0 + i % C::BN;
    xrows[i] = t < p.T ? x_row(i < C::BN ? p.r[0].lx : p.r[1].lx, t) : 0;
  }
  __syncthreads();

#pragma unroll
  for (int s = 0; s < C::AHEAD; ++s) {
    if (s < n_st) load_stage<C>(p, smem + s * C::STAGE_BYTES, s_begin + s, t0, n0, tid, xrows);
    cp_async_commit();
  }
  // wgmma: the A fragments of two stages, stage i's products reading one
  // set while stage i + 1's are converted into the other
  uint32_t aw[C::WG ? 2 : 1][BK / 16][1][4];
  // stage it, PAR its parity (a compile-time index into aw)
  auto iter = [&](auto parity, int it) {
    constexpr int PAR = decltype(parity)::value;
    cp_async_wait<C::AHEAD - 1>();
    __syncthreads();  // stage it is in; the stage loaded next is consumed by every warp
    {
      const int nx = it + C::AHEAD;
      if (nx < n_st)
        load_stage<C>(p, smem + (nx % STAGES) * C::STAGE_BYTES, s_begin + nx, t0, n0, tid, xrows);
      cp_async_commit();
    }
    const uint8_t* ws = smem + (it % STAGES) * C::STAGE_BYTES;
    const uint8_t* xs = ws + W_::BYTES;
    int k0, kn;
    const int K = stage_range(p, s_begin + it, BK, k0, kn).K;
    if constexpr (C::WG) {
      // warpgroup wg: columns 64 wg..64 wg + 63, all 128 tokens.  This
      // stage's A fragments converted (int8 / int4) while the previous
      // stage's products run; its products issued; then the previous
      // stage's awaited, so that its stage is free for the next load (int4:
      // this stage's, whose group sums are then flushed).
      const uint32_t xa = smem_addr(xs);
      auto& a = aw[PAR];
#pragma unroll
      for (int s = 0; s < BK / 16; ++s)
        if (16 * s < kn) load_a<MODE, 1, W_::STRIDE>(a[s], ws, 16 * s, wm, lane);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        if (16 * s >= kn) break;
        const uint64_t db = gmma_desc(xa + 256 * s, 128, (BK / 8) * 128);
        if constexpr (MODE == W_INT4)
          wgmma_rs(part, a[s][0], db);
        else
          wgmma_rs(acc, a[s][0], db);
      }
      wgmma_commit();
      if constexpr (MODE == W_INT4) {  // groups end on stage ends (group % BK == 0)
        wgmma_wait<0>();
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          reg_fence(acc[q]);
          reg_fence(part[q]);
        }
        step_done(K, kn / 16);
      } else {
        wgmma_wait<1>();
      }
    } else {
    const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xs);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      if (kk >= kn) break;
      uint32_t a[MT][4], b[NT][2];
      load_a<MODE, MT, W_::STRIDE>(a, ws, kk, wm, lane);
      if constexpr (NT == 1) {
        const int l = lane & 15;
        ldsm_x2(b[0][0], b[0][1], xb + (wn + (l & 7)) * C::XSTRIDE + kk + (l >> 3) * 8);
      } else {
        const int m = lane >> 3;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldsm_x4(r, xb + (wn + 8 * (j + (m >> 1)) + (lane & 7)) * C::XSTRIDE + kk + (m & 1) * 8);
          b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
        }
      }
      if constexpr (MODE != W_INT4) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma(acc + (i * NT + j) * 4, a[i], b[j][0], b[j][1]);
      } else if (!fine) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma(part + (i * NT + j) * 4, a[i], b[j][0], b[j][1]);
        step_done(K, 1);
      } else {
        // one product per group the step meets, the other groups' A
        // registers zeroed (a register's pair never straddles: groups are even)
        const int k = k0 + kk, k_hi = min(k + 16, k0 + kn);
        for (int gi = k / p.group; gi * p.group < k_hi; ++gi) {
          const bool lo_in = (k + 2 * c4) / p.group == gi, hi_in = (k + 2 * c4 + 8) / p.group == gi;
          uint32_t am[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            am[i][0] = lo_in ? a[i][0] : 0u; am[i][1] = lo_in ? a[i][1] : 0u;
            am[i][2] = hi_in ? a[i][2] : 0u; am[i][3] = hi_in ? a[i][3] : 0u;
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(part + (i * NT + j) * 4, am[i], b[j][0], b[j][1]);
          if ((gi + 1) * p.group <= k + 16) {  // the group ends in this step
            group_scales(p, gi, n_lane, sc);
            flush(sc);
          }
        }
      }
    }
    }
  };
  for (int it = 0; it < n_st; it += 2) {
    iter(std::integral_constant<int, 0>{}, it);
    if (it + 1 < n_st) iter(std::integral_constant<int, 1>{}, it + 1);
  }
  cp_async_wait<0>();
  if constexpr (C::WG) {
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < NACC; ++q) {
      reg_fence(acc[q]);
      reg_fence(part[q]);
    }
  }
  __syncthreads();  // every warp is done with the stages: the tile reuses them

  // the fp32 tile [t][n] of this segment
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        cs[(wn + 8 * j + 2 * c4 + (e & 1)) * C::CSTRIDE + wm + m_row<MODE == W_BF16, MT>(i, e >> 1, g)] =
            acc[(i * NT + j) * 4 + e];
  __syncthreads();

  // the tile's cells inside the output, nn a row: cell id is (id / nn, id % nn)
  const int tn = min(C::BN, p.T - t0), nn = min(BM, p.N - n0), cells = tn * nn;
  auto emit = [&](int id, float v) {
    const int t = id / nn, n = id % nn;
    if constexpr (MODE == W_INT8) v *= __bfloat162float(p.scale[n0 + n]);
    const size_t o = (size_t)(t0 + t) * p.N + n0 + n;
    if (p.out_f32)
      static_cast<float*>(p.out)[o] = v;
    else
      static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16(v);
  };
  auto cell = [&](int id) { return cs[(id / nn) * C::CSTRIDE + id % nn]; };
  if (b_lo == b_hi) {  // this block covers the tile
    for (int id = tid; id < cells; id += C::THREADS) emit(id, cell(id));
    __syncthreads();  // the next segment's stages overwrite the tile
    return;
  }
  // a part: slot 0 of the block's pair if the segment starts its share, else 1
  constexpr int SLOT = C::BN * BM;
  float* mine = p.work + ((size_t)blockIdx.x * 2 + (first ? 0 : 1)) * SLOT;
  for (int id = tid; id < cells; id += C::THREADS) mine[id] = cell(id);
  __shared__ int last;
  __threadfence();  // this block's part is visible before its arrival
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.counters + tau, 1) == b_hi - b_lo;
  __syncthreads();
  if (last) {
    __threadfence();
    // the parts in block order.  Eight cells a thread at once, their loads
    // in flight.
    constexpr int Q = 8;
    for (int id0 = tid; id0 < cells; id0 += Q * C::THREADS) {
      float v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) v[q] = 0.f;
      for (int b = b_lo; b <= b_hi; ++b) {
        const float* src = p.work + ((size_t)b * 2 + (b == b_lo ? lo_slot : 0)) * SLOT;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int id = id0 + q * C::THREADS;
          if (id < cells) v[q] += __ldcg(src + id);
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (id0 + q * C::THREADS < cells) emit(id0 + q * C::THREADS, v[q]);
    }
    if (tid == 0) p.counters[tau] = 0;
  }
  __syncthreads();  // the next segment's stages overwrite the tile
}

// A block's share of the tiles' K stages.  chunk > 0: block b takes chunk
// b % n of tile b / n, n = ceil(stages / chunk): the split points do not
// depend on T, so a row's sums are the same bits at every T that takes the
// instance.  Else the W = tiles * units units of the grid's work
// (tile-major; a tile's T tiles are adjacent, so the blocks that read one
// weight slab run together) are divided evenly over the G blocks, each
// share cut at tile edges into segments.
template <class C>
__device__ __forceinline__ void body(const Params& p, uint8_t* smem) {
  if (p.chunk > 0) {
    const int n = cdiv_d(p.stages, p.chunk), c = blockIdx.x % n, b_lo = blockIdx.x - c;
    segment<C>(p, smem, blockIdx.x / n, c * p.chunk, min(p.stages, (c + 1) * p.chunk), true,
               b_lo, b_lo + n - 1, 0);
    return;
  }
  const int units = cdiv_d(p.stages, p.unit);
  const long W = (long)cdiv_d(p.T, C::BN) * cdiv_d(p.N, C::BM) * units, G = gridDim.x;
  const long u0 = blockIdx.x * W / G, u1 = (blockIdx.x + 1) * W / G;
  for (long u = u0; u < u1;) {
    const int tau = static_cast<int>(u / units);
    const long tu = (long)tau * units, ue = min(u1, tu + units);
    const int b_lo = owner(tu, W, G), b_hi = owner(tu + units - 1, W, G);
    // b_lo's part is its slot 1 when its share began in an earlier tile
    segment<C>(p, smem, tau, static_cast<int>(u - tu) * p.unit,
               min(p.stages, static_cast<int>(ue - tu) * p.unit), u == u0, b_lo, b_hi,
               (long)b_lo * W / G < tu ? 1 : 0);
    u = ue;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline int cdiv(long a, long b) { return static_cast<int>((a + b - 1) / b); }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launches `blocks` blocks of kernel (an instance of body<C>): at least
// one, at most one a unit of work, and with more than one the workspace
// and the counters.
template <class C, typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int blocks, cudaStream_t st) {
  const long tiles = (long)cdiv(p.T, C::BN) * cdiv(p.N, C::BM);
  const long work = tiles * cdiv(p.stages, p.unit);
  if (p.unit < 1 || p.chunk < 0 || blocks < 1 || blocks > work ||
      (p.chunk && blocks != tiles * cdiv(p.stages, p.chunk)) ||
      (blocks > 1 && !(p.work && p.counters)))
    return static_cast<cudaError_t>(ERR_BAD_ARGS);
  static bool attr = false;  // once per instance: the stages exceed 48 KB
  if (!attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  kernel<<<blocks, C::THREADS, C::SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace gemm
