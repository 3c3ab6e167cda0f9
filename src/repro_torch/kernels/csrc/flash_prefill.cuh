// Causal GQA flash attention over one query tile: the body shared by
// flash_prefill.cu (a dense (n, hkv, Sk, hd) K/V stripe), flash_verify.cu
// (the same stripe, its KV axis split across blocks) and
// paged_flash_prefill.cu (block pools read through a block table).  The
// template parameter PAGED picks how a key row's address is found; SPLIT
// makes a block walk one chunk of the KV axis and write unnormalized
// partials instead of the output.
//
// Blocking.  The TPU kernel walks a sequential third grid axis over KV
// blocks; GPU blocks run in no order, so here one block owns one (batch, kv
// head, q tile) and loops over the KV tiles itself.  The g query heads that
// share a KV head are folded into the tile (as _fold_q does): a tile is 64
// rows (query position, head) of one KV head.  KV tiles past the tile's
// largest q_pos are skipped (the kv0 <= max(q_pos) rule of _flash_update).
//
// Two bodies, one per input type; each dtype runs only its own:
//
// * bf16 (mma_body::kernel), on the tensor cores.  The work is ~4 * hd
//   FLOPs per (query, key) pair against one read of q/k/v, so at prompt
//   lengths of a few hundred tokens the card is bound by operations, and
//   only the bf16 tensor cores (989 TFLOP/s, against 67 for fp32 FMA) come
//   near that bound.  4 row blocks of 16 folded rows (one m16 fragment row
//   block each); at head_dim 64 and 128 a warp owns a row block, at 256 two
//   warps do (one warp's 16 x 256 fp32 output fills 128 registers, and
//   with the S tile it spilled): each scores half of a tile's keys and owns
//   half the output dimensions, and the two exchange row maxima and P
//   through shared memory.  The Q tile is staged once as bf16; K and V
//   tiles of 64 keys are kept in shared memory as stored (bf16), copied by
//   16-byte cp.async into two stages, so the next tile's copy is in flight
//   while this one is used.  Rows are padded by 16 bytes, so the 8 rows an
//   ldmatrix reads lie in 8 distinct bank groups.  S = Q K^T runs on
//   mma.sync m16n8k16 (bf16 in, fp32 accumulators), Q's fragments read by
//   ldmatrix at each k-step (the whole Q would not fit the registers at
//   head_dim 256).  Mask and online softmax work on the S fragment in
//   registers, in log2 units (exp2): a lane holds rows lane/4 and lane/4 +
//   8 of its row block, and the row max reduces over the quad's 4 lanes; a
//   masked entry gives p = 0 exactly, as _flash_update zeroes it.  O += P V
//   on mma.sync as well: the S accumulator layout is the A layout of the
//   next product (a pair reads it back by ldmatrix), V's fragments come
//   through ldmatrix.trans, O stays in fp32 registers and l sums the fp32
//   p.  P enters the product as two bf16 operands, p = hi + lo with lo =
//   bf16(p - hi): one rounded P puts up to 2^-8 of each weight's error on
//   the output, which at a row's first few keys reaches the 2e-3 + 1e-2
//   |want| limit the windowed prefill is held to; hi + lo carries ~16
//   bits, as near fp32 P as that limit can see, for one more P V product.
//   Pad rows and keys past Sk are zero-filled tiles (cp.async with a
//   source size of 0), so a masked entry multiplies zeros or real values,
//   never stale shared memory.
// * fp32 (fma_body::kernel), on the CUDA cores: the tensor cores would round
//   fp32 inputs to bf16 or TF32, which the fp32 instances' 1e-3 limit
//   would see.  8 warps of 8 rows; per 32-key tile the block stages K and V
//   as fp32 (16-byte loads); each lane scores one key against its warp's 8
//   rows (K rows padded by 4 floats so the 16-byte reads of 8 neighbouring
//   lanes hit distinct banks), the warp does the online softmax with
//   shuffles, and each lane accumulates hd/32 output dimensions of P V.
//
// Sliding window (window > 0, dense fresh K/V): row i attends key j iff
// q_pos[i] - window < j <= q_pos[i]; KV tiles wholly below the band of the
// tile's lowest live row are skipped as well, so a tile walks at most
// window + its own span of keys.  Every other caller passes 0.
//
// Dense rows: batch row b reads the cache row rows[b] of a stripe with
// n_cache rows (rows == nullptr: row b), so a chunk of a few slots attends
// those slots' stripes in the shared slot cache without a gathered copy; a
// row index outside [0, n_cache) attends nothing.
//
// Paged rows: key j of slot b is row j % bs of pool block bt[b, j / bs]
// (entries outside [0, nb) read the null block 0); each thread reads the
// table entry of the row it stages, so a 64-key tile gathers 64 / bs pool
// blocks into one shared-memory tile.
//
// Split KV (flash_verify): block z walks keys [z * chunk, (z + 1) * chunk)
// only and writes fp32 (m, l, acc) per row to a workspace; a block whose
// chunk starts past the tile's largest q_pos writes empty partials before
// any load.  chunk is a whole number of 64-key tiles, which both bodies
// walk.  merge_partials (flash_verify.cu) normalizes.
#pragma once

#include <limits.h>

#include <type_traits>

#include "common.cuh"

namespace prefill {

constexpr int ROWS_BLOCK = 64;  // folded query rows per block, both bodies
constexpr int SPLIT_BK = 64;    // a split chunk is a whole number of these keys

// The KV range [lo, hi) one block walks, in whole BK tiles from lo, and the
// cache row its batch row reads.
struct Span {
  int lo, hi, kv_row;
};

template <bool PAGED, bool SPLIT, int BK>
__device__ __forceinline__ Span kv_span(const int* __restrict__ q_pos, const int* __restrict__ rows,
                                        int n_cache, int b, int sq, int g, int row0, int sk,
                                        int chunk, int window) {
  const int n_rows = sq * g;
  int max_pos = -1, min_pos = INT_MAX;  // over the tile's live rows
  const int last_row = min(row0 + ROWS_BLOCK, n_rows) - 1;
  for (int i = row0 / g; i <= last_row / g; ++i) {
    const int p = q_pos[(size_t)b * sq + i];
    max_pos = max(max_pos, p);
    if (p >= 0) min_pos = min(min_pos, p);
  }
  int kv_row = b;
  if constexpr (!PAGED) {
    if (rows != nullptr) kv_row = rows[b];
    if ((unsigned)kv_row >= (unsigned)n_cache) max_pos = -1;  // attends nothing
  }
  const int kv_end = min(sk, max_pos + 1);
  // the first BK-key tile that holds a key of the lowest live row's band
  const int band_lo = window > 0 && max_pos >= 0 ? max(0, min_pos - window + 1) / BK * BK : 0;
  const int lo = SPLIT ? blockIdx.z * chunk : band_lo;
  return {lo, SPLIT ? min(kv_end, lo + chunk) : kv_end, kv_row};
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
namespace fma_body {

constexpr int WARPS = 8;
constexpr int ROWS = 8;  // query rows per warp
constexpr int BK = 32;   // keys per tile: one per lane

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(ROWS_BLOCK * HD + BK * (HD + 4) + BK * HD) * sizeof(float);
}

// N floats (a multiple of 4) into 16-byte-aligned shared memory
template <int N>
__device__ __forceinline__ void store4(float* dst, const float* x) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

template <int HD, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(WARPS * 32)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const int* __restrict__ bt, int nb, int bs, int nbps,
       const int* __restrict__ rows, int n_cache,
       const int* __restrict__ q_pos, float* __restrict__ out, float* __restrict__ part,
       int hq, int hkv, int sq, int sk, int chunk, float scale, int window) {
  constexpr int DPL = HD / 32;  // output dimensions per lane
  constexpr int KS = HD + 4;    // padded K row stride, in floats
  constexpr int CPR = HD / 4;   // 16-byte chunks per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // ROWS_BLOCK x HD
  float* Ks = Qs + ROWS_BLOCK * HD;             // BK x KS
  float* Vs = Ks + BK * KS;                     // BK x HD

  const int g = hq / hkv;
  const int bh = blockIdx.y;  // b * hkv + kv head
  const int b = bh / hkv, kvh = bh % hkv;
  const int n_rows = sq * g;  // row r is query position r / g, head kvh*g + r % g
  const int row0 = blockIdx.x * ROWS_BLOCK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int pos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int rg = row0 + warp * ROWS + r;
    pos[r] = rg < n_rows ? q_pos[(size_t)b * sq + rg / g] : -1;
  }
  const Span span = kv_span<PAGED, SPLIT, BK>(q_pos, rows, n_cache, b, sq, g, row0, sk, chunk,
                                              window);
  const bool warp_live = row0 + warp * ROWS < n_rows;
  const size_t bhr = SPLIT ? ((size_t)blockIdx.z * gridDim.y + bh) * n_rows : 0;

  if (!SPLIT || span.lo < span.hi) {  // block-uniform: a dead split loads nothing
    for (int c = tid; c < ROWS_BLOCK * CPR; c += blockDim.x) {
      const int rr = c / CPR, d0 = (c % CPR) * 4, r = row0 + rr;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < n_rows) {
        const int h = kvh * g + r % g;
        Vec16<float>::load(q + (((size_t)b * hq + h) * sq + r / g) * HD + d0, x);
      }
      store4<4>(Qs + rr * HD + d0, x);
    }
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_BIG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const int* bt_row = PAGED ? bt + (size_t)b * nbps : nullptr;
  const size_t stripe =
      PAGED ? (size_t)kvh * bs * HD : ((size_t)span.kv_row * hkv + kvh) * sk * HD;
  const float* kb = k + stripe;
  const float* vb = v + stripe;
  const float* qw = Qs + warp * ROWS * HD;
  for (int kv0 = span.lo; kv0 < span.hi; kv0 += BK) {
    __syncthreads();  // Q is staged; the previous tile is consumed
    for (int c = tid; c < BK * CPR; c += blockDim.x) {
      const int j = c / CPR, d0 = (c % CPR) * 4, key = kv0 + j;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (key < sk) {
        size_t row = (size_t)key * HD;
        if constexpr (PAGED) {  // row key % bs of pool block bt[b, key / bs]
          const int e = bt_row[key / bs];
          row = ((size_t)((unsigned)e < (unsigned)nb ? e : 0) * hkv * bs + key % bs) * HD;
        }
        Vec16<float>::load(kb + row + d0, kx);
        Vec16<float>::load(vb + row + d0, vx);
      }
      store4<4>(Ks + j * KS + d0, kx);
      store4<4>(Vs + j * HD + d0, vx);
    }
    __syncthreads();
    if (!warp_live) continue;  // no rows of this warp: staging only

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    const int key = kv0 + lane;
    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool ok = key <= pos[r] && key < sk && (window <= 0 || key > pos[r] - window);
      const float sv = ok ? s[r] * scale : NEG_BIG;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }

    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = Vs[j * HD + lane * DPL + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int rg = row0 + warp * ROWS + r;
    if (rg >= n_rows) continue;
    if constexpr (SPLIT) {
      const size_t i = bhr + rg, n = (size_t)gridDim.z * gridDim.y * n_rows;
      if (lane == 0) {
        part[i] = m[r];
        part[n + i] = l[r];
      }
      float* a = part + 2 * n + i * HD + lane * DPL;
#pragma unroll
      for (int c = 0; c < DPL; ++c) a[c] = acc[r][c];
    } else {
      const int h = kvh * g + rg % g;
      float* o = out + (((size_t)b * hq + h) * sq + rg / g) * HD + lane * DPL;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DPL; ++c) o[c] = acc[r][c] / denom;
    }
  }
}

}  // namespace fma_body

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
namespace mma_body {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 16;  // query rows per row block: one m16 fragment row block
constexpr int BK = 64;    // keys per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Warps per 16-row block: at head_dim 256 one warp's 16 x 256 fp32 output
// alone fills 128 registers, and with the S tile it spills, so two warps
// share a row block there: each scores half the tile's keys and owns half
// the output dimensions, and they exchange row maxima and P through shared
// memory.
template <int HD>
__host__ __device__ constexpr int pair() {
  return HD > 128 ? 2 : 1;
}

template <int HD>
__host__ __device__ constexpr int warps() {
  return 4 * pair<HD>();
}

// A shared-memory row of HD bf16 padded by 16 bytes: the 8 rows an ldmatrix
// reads lie 16 bytes apart modulo 128, in 8 distinct bank groups.
template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 8;
}

constexpr int PLD = BK + 8;  // a padded row of P in shared memory (paired warps)

// Q (64 rows) and two stages of K and V (64 keys each), and for paired
// warps P as bf16 hi and lo (4 row blocks) and the row maxima of each half:
// 187,904 bytes at head_dim 256, 87,040 at 128, 46,080 at 64.
template <int HD>
constexpr size_t smem_bytes() {
  return (size_t)(ROWS_BLOCK + 4 * BK) * ld<HD>() * sizeof(bf16) +
         (pair<HD>() > 1 ? (size_t)4 * 2 * ROWS * PLD * sizeof(bf16) + 2 * ROWS_BLOCK * sizeof(float)
                         : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !fill
// (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the two warps of a row block meet (named barrier 1 + row block, 64 threads)
__device__ __forceinline__ void pair_sync(int row_block) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + row_block) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// p as hi + lo, both bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

template <int HD, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(warps<HD>() * 32, 1)
kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
       const int* __restrict__ bt, int nb, int bs, int nbps,
       const int* __restrict__ rows, int n_cache,
       const int* __restrict__ q_pos, bf16* __restrict__ out, float* __restrict__ part,
       int hq, int hkv, int sq, int sk, int chunk, float scale, int window) {
  constexpr int PAIR = pair<HD>();
  constexpr int THREADS = warps<HD>() * 32;
  constexpr int LD = ld<HD>();
  constexpr int CPR = HD / 8;          // 16-byte chunks per row
  constexpr int NB = BK / 8 / PAIR;    // n8 key blocks of a warp's S tile
  constexpr int DB = HD / 8 / PAIR;    // n8 dimension blocks of a warp's O
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // ROWS_BLOCK x LD
  bf16* Ks = Qs + ROWS_BLOCK * LD;            // 2 stages x BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                // 2 stages x BK x LD
  bf16* Ps = Vs + 2 * BK * LD;                // paired: 4 row blocks x (hi, lo) x ROWS x PLD
  float* Mx = reinterpret_cast<float*>(Ps + 4 * 2 * ROWS * PLD);  // paired: 2 halves x 64 rows

  const int g = hq / hkv;
  const int bh = blockIdx.y;  // b * hkv + kv head
  const int b = bh / hkv, kvh = bh % hkv;
  const int n_rows = sq * g;  // row r is query position r / g, head kvh*g + r % g
  const int row0 = blockIdx.x * ROWS_BLOCK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp & 3, half = warp >> 2;  // the warp's row block, and its half of a pair
  const int qr = lane >> 2, qc = lane & 3;    // the lane's fragment row and column pair

  const Span span = kv_span<PAGED, SPLIT, BK>(q_pos, rows, n_cache, b, sq, g, row0, sk, chunk,
                                              window);
  // this lane's rows: qr and qr + 8 of its row block's 16
  const int r0 = row0 + rb * ROWS + qr, r1 = r0 + 8;
  const int pos0 = r0 < n_rows ? q_pos[(size_t)b * sq + r0 / g] : -1;
  const int pos1 = r1 < n_rows ? q_pos[(size_t)b * sq + r1 / g] : -1;
  // over the row block's 16 rows: the largest position, the smallest (a
  // pad row counts -1) and the smallest of a live row
  int wmax = max(pos0, pos1), wmin = min(pos0, pos1);
  int wlo = min(pos0 < 0 ? INT_MAX : pos0, pos1 < 0 ? INT_MAX : pos1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(FULL, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(FULL, wmin, o));
    wlo = min(wlo, __shfl_xor_sync(FULL, wlo, o));
  }

  const int* bt_row = PAGED ? bt + (size_t)b * nbps : nullptr;
  const size_t stripe =
      PAGED ? (size_t)kvh * bs * HD : ((size_t)span.kv_row * hkv + kvh) * sk * HD;
  const bf16* kb = k + stripe;
  const bf16* vb = v + stripe;

  // one 64-key tile of K and V into a stage, 16 bytes a copy; keys past sk
  // are zeros
  auto load_tile = [&](int kv0, int stage) {
    bf16* ks = Ks + stage * BK * LD;
    bf16* vs = Vs + stage * BK * LD;
    for (int c = tid; c < BK * CPR; c += THREADS) {
      const int j = c / CPR, d0 = (c % CPR) * 8, key = kv0 + j;
      const bool in = key < sk;
      size_t row = 0;
      if (in) {
        row = (size_t)key * HD;
        if constexpr (PAGED) {  // row key % bs of pool block bt[b, key / bs]
          const int e = bt_row[key / bs];
          row = ((size_t)((unsigned)e < (unsigned)nb ? e : 0) * hkv * bs + key % bs) * HD;
        }
      }
      cp_async16(smem_addr(ks + j * LD + d0), kb + row + d0, in);
      cp_async16(smem_addr(vs + j * LD + d0), vb + row + d0, in);
    }
    cp_async_commit();
  };

  const int n_tiles = span.lo < span.hi ? (span.hi - span.lo + BK - 1) / BK : 0;
  if (n_tiles > 0) {  // block-uniform: a block with no keys loads nothing
    for (int c = tid; c < ROWS_BLOCK * CPR; c += THREADS) {
      const int rr = c / CPR, d0 = (c % CPR) * 8, r = row0 + rr;
      const bool live = r < n_rows;
      const bf16* src =
          q + (live ? (((size_t)b * hq + kvh * g + r % g) * sq + r / g) * HD + d0 : 0);
      cp_async16(smem_addr(Qs + rr * LD + d0), src, live);
    }
    cp_async_commit();
    load_tile(span.lo, 0);
  }

  // the warp's keys of a tile and its output dimensions
  const int key0 = half * (BK / PAIR), dim0 = half * (HD / PAIR);
  // per-lane ldmatrix addresses: A of Q (rows lane % 16, column half lane /
  // 16), B of K (keys lane % 8 + 8 * (lane / 16), column half (lane / 8) %
  // 2), B of V transposed (keys lane % 8 + 8 * ((lane / 8) % 2), column half
  // lane / 16), A of a paired row block's P (as Q's)
  const uint32_t q_addr = smem_addr(Qs + (rb * ROWS + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = (key0 + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + dim0 + (lane >> 4) * 8;
  bf16* p_hi = Ps + rb * 2 * ROWS * PLD;  // paired: this row block's P, hi then lo
  bf16* p_lo = p_hi + ROWS * PLD;
  const uint32_t p_addr = smem_addr(p_hi + (lane & 15) * PLD + (lane >> 4) * 8);

  const float sl2 = scale * LOG2E;
  // running max (log2 units, shared by a pair) and this warp's share of
  // the sum over its keys
  float m0 = NEG_BIG, m1 = NEG_BIG, l0 = 0.f, l1 = 0.f;
  float o[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = span.lo + it * BK, stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy in flight while this one is used
      load_tile(kv0 + BK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // uniform over a row block (both warps of a pair): no row attends a
    // key of this tile
    const bool skip = row0 + rb * ROWS >= n_rows || kv0 > wmax ||
                      (window > 0 && kv0 + BK - 1 <= wlo - window);
    if (!skip) {
      const uint32_t k_addr = smem_addr(Ks + stage * BK * LD + k_off);
      const uint32_t v_addr = smem_addr(Vs + stage * BK * LD + v_off);

      float s[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_addr + (n2 * 16 * LD + kk * 16) * 2);
          mma_bf16(s[2 * n2], a, kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], a, kf[2], kf[3]);
        }
      }

      // every key of the tile valid for every row of the block: no mask
      const bool full = kv0 + BK - 1 <= wmin && kv0 + BK <= sk &&
                        (window <= 0 || kv0 > wmax - window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < NB; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kv0 + key0 + i * 8 + 2 * qc + e;
          const bool ok0 = full || (key <= pos0 && key < sk && (window <= 0 || key > pos0 - window));
          const bool ok1 = full || (key <= pos1 && key < sk && (window <= 0 || key > pos1 - window));
          s[i][e] = ok0 ? s[i][e] * sl2 : NEG_BIG;
          s[i][2 + e] = ok1 ? s[i][2 + e] * sl2 : NEG_BIG;
          mx0 = fmaxf(mx0, s[i][e]);
          mx1 = fmaxf(mx1, s[i][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      if constexpr (PAIR > 1) {  // the row max over both halves of the tile
        if (qc == 0) {
          Mx[half * ROWS_BLOCK + rb * ROWS + qr] = mx0;
          Mx[half * ROWS_BLOCK + rb * ROWS + qr + 8] = mx1;
        }
        pair_sync(rb);
        mx0 = fmaxf(mx0, Mx[(half ^ 1) * ROWS_BLOCK + rb * ROWS + qr]);
        mx1 = fmaxf(mx1, Mx[(half ^ 1) * ROWS_BLOCK + rb * ROWS + qr + 8]);
      }
      const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < NB; ++i) {  // p in place of s; a masked entry is exactly 0
        s[i][0] = s[i][0] > NEG_BIG ? exp2f(s[i][0] - mx0) : 0.f;
        s[i][1] = s[i][1] > NEG_BIG ? exp2f(s[i][1] - mx0) : 0.f;
        s[i][2] = s[i][2] > NEG_BIG ? exp2f(s[i][2] - mx1) : 0.f;
        s[i][3] = s[i][3] > NEG_BIG ? exp2f(s[i][3] - mx1) : 0.f;
        rs0 += s[i][0] + s[i][1];
        rs1 += s[i][2] + s[i][3];
      }
      l0 = l0 * c0 + rs0;  // this lane's share; the quad (and the pair) summed at the end
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int j = 0; j < DB; ++j) {
        o[j][0] *= c0;
        o[j][1] *= c0;
        o[j][2] *= c1;
        o[j][3] *= c1;
      }

      // O += P V over the tile's 4 k16 steps of keys, P as hi and lo bf16
      // parts: from the S fragment in registers (the S blocks 2kk, 2kk + 1
      // are the A fragment), or, for a pair, from the P both halves wrote
      if constexpr (PAIR > 1) {
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          uint32_t hi0, lo0, hi1, lo1;
          split_bf16(s[i][0], s[i][1], hi0, lo0);
          split_bf16(s[i][2], s[i][3], hi1, lo1);
          const int col = key0 + i * 8 + 2 * qc;
          *reinterpret_cast<uint32_t*>(p_hi + qr * PLD + col) = hi0;
          *reinterpret_cast<uint32_t*>(p_hi + (qr + 8) * PLD + col) = hi1;
          *reinterpret_cast<uint32_t*>(p_lo + qr * PLD + col) = lo0;
          *reinterpret_cast<uint32_t*>(p_lo + (qr + 8) * PLD + col) = lo1;
        }
        pair_sync(rb);
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t hi[4], lo[4];
        if constexpr (PAIR > 1) {
          ldmatrix_x4(hi, p_addr + kk * 32);
          ldmatrix_x4(lo, p_addr + (ROWS * PLD + kk * 16) * 2);
        } else {
          split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
        }
#pragma unroll
        for (int d2 = 0; d2 < DB / 2; ++d2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_addr + (kk * 16 * LD + d2 * 16) * 2);
          mma_bf16(o[2 * d2], hi, vf[0], vf[1]);
          mma_bf16(o[2 * d2 + 1], hi, vf[2], vf[3]);
          mma_bf16(o[2 * d2], lo, vf[0], vf[1]);
          mma_bf16(o[2 * d2 + 1], lo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage (and P) is consumed before the next copy into it
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  if constexpr (PAIR > 1) {  // the sum over both halves' keys
    if (qc == 0) {
      Mx[half * ROWS_BLOCK + rb * ROWS + qr] = l0;
      Mx[half * ROWS_BLOCK + rb * ROWS + qr + 8] = l1;
    }
    pair_sync(rb);
    l0 += Mx[(half ^ 1) * ROWS_BLOCK + rb * ROWS + qr];
    l1 += Mx[(half ^ 1) * ROWS_BLOCK + rb * ROWS + qr + 8];
  }

  // the lane's two rows: h = 0 is row r0 (o[.][0..1]), h = 1 row r1 (o[.][2..3])
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rg = h ? r1 : r0;
    const float m = h ? m1 : m0, l = h ? l1 : l0;
    if (rg >= n_rows) continue;
    if constexpr (SPLIT) {
      const size_t i = ((size_t)blockIdx.z * gridDim.y + bh) * n_rows + rg;
      const size_t n = (size_t)gridDim.z * gridDim.y * n_rows;
      if (qc == 0 && half == 0) {
        part[i] = m > NEG_BIG ? m * LN2 : NEG_BIG;  // natural units, as merge_partials reads
        part[n + i] = l;
      }
      float* a = part + 2 * n + i * HD + dim0 + 2 * qc;
#pragma unroll
      for (int j = 0; j < DB; ++j)
        *reinterpret_cast<float2*>(a + j * 8) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
    } else {
      const int head = kvh * g + rg % g;
      bf16* dst = out + (((size_t)b * hq + head) * sq + rg / g) * HD + dim0 + 2 * qc;
      const float inv = 1.f / fmaxf(l, 1e-30f);  // a row with no key: 0 * inv = 0
#pragma unroll
      for (int j = 0; j < DB; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
    }
  }
}

}  // namespace mma_body

// Normalizes the partials of a split launch: row r of (batch, kv head) bh
// is max-merged over the splits by log-sum-exp and written to out as query
// position r / g of head kvh * g + r % g.  One block per (row, bh), one
// thread per output dimension; a row with no valid key in any split (a pad
// row) comes out as exact zeros.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
merge_partials(const float* __restrict__ part, T* __restrict__ out, int splits,
               int hq, int hkv, int sq) {
  const int r = blockIdx.x, bh = blockIdx.y, d = threadIdx.x;
  const int n_rows = gridDim.x, BH = gridDim.y;
  const size_t n = (size_t)splits * BH * n_rows;
  float M = NEG_BIG;
  for (int z = 0; z < splits; ++z) M = fmaxf(M, part[((size_t)z * BH + bh) * n_rows + r]);
  float L = 0.f, A = 0.f;
  if (M > NEG_BIG / 2) {
    for (int z = 0; z < splits; ++z) {
      const size_t i = ((size_t)z * BH + bh) * n_rows + r;
      const float c = expf(part[i] - M);
      L += part[n + i] * c;
      A += part[2 * n + i * HD + d] * c;
    }
  }
  const int g = hq / hkv, b = bh / hkv, h = (bh % hkv) * g + r % g;
  store_as(out + (((size_t)b * hq + h) * sq + r / g) * HD + d, L > 0.f ? A / L : 0.f);
}

// The arguments of one launch of either layout.
struct Args {
  const void *q, *k, *v;
  const int* bt;  // paged: block table (b, nbps) over nb pool blocks of bs rows
  int nb, bs, nbps;
  const int* rows;  // dense: cache row of each batch row (nullptr: row b) of n_cache
  int n_cache;
  const void* q_pos;
  void* out;
  float* part;  // split: the partials workspace, part_floats of them
  int part_floats;
  int b, hq, hkv, sq, sk;
  float scale;
  int window;  // dense, unsplit: sliding-window size (0 = none); others 0
  cudaStream_t stream;
};

// The SM count of the first device a split launch runs on, read once: the
// port drives one card per process.
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Split launches: enough KV chunks that b * hkv * q tiles * splits blocks
// give every SM about two, each chunk a whole number of SPLIT_BK-key tiles
// (so of either body's tiles).  Returns the chunk's length in keys and sets
// *splits.
inline int split_chunk(int b, int hq, int hkv, int sq, int sk, int* splits) {
  const int blocks = (sq * (hq / hkv) + ROWS_BLOCK - 1) / ROWS_BLOCK * b * hkv;
  const int sms = sm_count();
  const int tiles = (sk + SPLIT_BK - 1) / SPLIT_BK;
  int want = (2 * sms + blocks - 1) / blocks;
  want = want < 1 ? 1 : (want > tiles ? tiles : want);
  const int chunk = (tiles + want - 1) / want * SPLIT_BK;
  *splits = (sk + chunk - 1) / chunk;
  return chunk;
}

// The partials workspace: m and l (splits, b * hkv, n_rows) each, then acc
// (splits, b * hkv, n_rows, hd), all fp32, n_rows = sq * hq / hkv.
inline int partials_floats(int splits, int b, int hq, int sq, int hd) {
  return splits * b * hq * sq * (hd + 2);
}

template <typename T, int HD, bool PAGED, bool SPLIT>
int launch(const Args& a) {
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value;
  const size_t smem = MMA ? mma_body::smem_bytes<HD>() : fma_body::smem_bytes<HD>();
  cudaError_t err = MMA ? cudaFuncSetAttribute(mma_body::kernel<HD, PAGED, SPLIT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem)
                        : cudaFuncSetAttribute(fma_body::kernel<HD, PAGED, SPLIT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
  if (err != cudaSuccess) return err;
  const int g = a.hq / a.hkv, q_tiles = (a.sq * g + ROWS_BLOCK - 1) / ROWS_BLOCK;
  int splits = 1, chunk = a.sk;
  if (SPLIT) {
    chunk = split_chunk(a.b, a.hq, a.hkv, a.sq, a.sk, &splits);
    if (partials_floats(splits, a.b, a.hq, a.sq, HD) > a.part_floats)
      return ERR_BAD_ARGS;  // the workspace is too small for these splits
  }
  const dim3 grid(q_tiles, a.b * a.hkv, splits);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int* q_pos = static_cast<const int*>(a.q_pos);
  T* out = static_cast<T*>(a.out);
  if constexpr (MMA)
    mma_body::kernel<HD, PAGED, SPLIT><<<grid, mma_body::warps<HD>() * 32, smem, a.stream>>>(
        q, k, v, a.bt, a.nb, a.bs, a.nbps, a.rows, a.n_cache, q_pos, out, a.part, a.hq, a.hkv,
        a.sq, a.sk, chunk, a.scale, a.window);
  else
    fma_body::kernel<HD, PAGED, SPLIT><<<grid, fma_body::WARPS * 32, smem, a.stream>>>(
        q, k, v, a.bt, a.nb, a.bs, a.nbps, a.rows, a.n_cache, q_pos, out, a.part, a.hq, a.hkv,
        a.sq, a.sk, chunk, a.scale, a.window);
  err = cudaGetLastError();
  if (!SPLIT || err != cudaSuccess) return err;
  merge_partials<T, HD><<<dim3(a.sq * g, a.b * a.hkv), HD, 0, a.stream>>>(
      a.part, out, splits, a.hq, a.hkv, a.sq);
  return cudaGetLastError();
}

// The (dtype, head_dim) instances of one layout: head_dim 64, 128 and 256
// (recurrentgemma, gptj-parallel) in every layout, bf16 on the tensor-core
// body and fp32 on the CUDA-core one; the dense unsplit layout is the only
// one that takes a window.
template <bool PAGED, bool SPLIT>
int dispatch(const Args& a, int hd, int dtype) {
  if (a.b <= 0 || a.hkv <= 0 || a.hq % a.hkv || a.sq <= 0 || a.sk <= 0 ||
      a.b * a.hkv > 65535 || (!PAGED && a.n_cache <= 0) || a.window < 0 ||
      ((PAGED || SPLIT) && a.window != 0))
    return ERR_BAD_ARGS;
  if (dtype == DTYPE_BF16 && hd == 256) return launch<__nv_bfloat16, 256, PAGED, SPLIT>(a);
  if (dtype == DTYPE_F32 && hd == 256) return launch<float, 256, PAGED, SPLIT>(a);
  if (dtype == DTYPE_BF16 && hd == 128) return launch<__nv_bfloat16, 128, PAGED, SPLIT>(a);
  if (dtype == DTYPE_BF16 && hd == 64) return launch<__nv_bfloat16, 64, PAGED, SPLIT>(a);
  if (dtype == DTYPE_F32 && hd == 128) return launch<float, 128, PAGED, SPLIT>(a);
  if (dtype == DTYPE_F32 && hd == 64) return launch<float, 64, PAGED, SPLIT>(a);
  return ERR_BAD_ARGS;
}

}  // namespace prefill
