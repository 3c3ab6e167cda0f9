// Causal GQA flash attention over one query tile: the body shared by
// flash_prefill.cu (a dense (n, hkv, Sk, hd) K/V stripe), flash_verify.cu
// (the same stripe, its KV axis split across blocks) and
// paged_flash_prefill.cu (block pools read through a block table).  The
// template parameter PAGED picks how a key row's address is found; SPLIT
// makes a block walk one chunk of the KV axis and write unnormalized
// partials instead of the output.
//
// Design.  The TPU kernel walks a sequential third grid axis over KV blocks;
// GPU blocks run in no order, so here one block owns one (batch, kv head,
// q tile) and loops over the KV tiles itself.  The g query heads that share
// a KV head are folded into the tile (as _fold_q does): a tile is 64 rows
// (query position, head) of one KV head, 8 rows per warp; a warp whose rows
// all lie past the tile's end only helps to stage.  Per 32-key tile the
// block stages K and V in shared memory as fp32 (16-byte loads); each lane
// scores one key against its warp's 8 rows (K rows padded by 4 floats so
// the 16-byte reads of 8 neighbouring lanes hit distinct banks), the warp
// does the online softmax with shuffles, and each lane accumulates hd/32
// output dimensions of P V.  KV tiles past the tile's largest q_pos are
// skipped (the kv0 <= max(q_pos) rule of _flash_update).
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
// table entry of the row it stages, so a 32-key tile gathers 32 / bs pool
// blocks into one shared-memory tile.
//
// Split KV (flash_verify): block z walks keys [z * chunk, (z + 1) * chunk)
// only and writes fp32 (m, l, acc) per row to a workspace; a block whose
// chunk starts past the tile's largest q_pos writes empty partials before
// any load.  merge_partials (flash_verify.cu) normalizes.
#pragma once

#include "common.cuh"

namespace prefill {

constexpr int WARPS = 8;
constexpr int ROWS = 8;                   // query rows per warp
constexpr int BK = 32;                    // keys per tile: one per lane
constexpr int ROWS_BLOCK = WARPS * ROWS;  // query rows per block

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

template <typename T, int HD, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(WARPS * 32)
kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const int* __restrict__ bt, int nb, int bs, int nbps,
       const int* __restrict__ rows, int n_cache,
       const int* __restrict__ q_pos, T* __restrict__ out, float* __restrict__ part,
       int hq, int hkv, int sq, int sk, int chunk, float scale, int window) {
  constexpr int DPL = HD / 32;     // output dimensions per lane
  constexpr int KS = HD + 4;       // padded K row stride, in floats
  constexpr int VN = Vec16<T>::N;  // elements per 16-byte load
  constexpr int CPR = HD / VN;     // 16-byte chunks per row
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
  int max_pos = -1, min_pos = 0x7fffffff;  // over the tile's live rows
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
  // the first 32-key tile that holds a key of the lowest live row's band
  const int band_lo = window > 0 && max_pos >= 0 ? max(0, min_pos - window + 1) / BK * BK : 0;
  const int kv_lo = SPLIT ? blockIdx.z * chunk : band_lo;
  const int kv_hi = SPLIT ? min(kv_end, kv_lo + chunk) : kv_end;
  const bool warp_live = row0 + warp * ROWS < n_rows;
  const size_t bhr = SPLIT ? ((size_t)blockIdx.z * gridDim.y + bh) * n_rows : 0;

  if (!SPLIT || kv_lo < kv_hi) {  // block-uniform: a dead split loads nothing
    for (int c = tid; c < ROWS_BLOCK * CPR; c += blockDim.x) {
      const int rr = c / CPR, d0 = (c % CPR) * VN, r = row0 + rr;
      float x[VN];
      if (r < n_rows) {
        const int h = kvh * g + r % g;
        Vec16<T>::load(q + (((size_t)b * hq + h) * sq + r / g) * HD + d0, x);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
      store4<VN>(Qs + rr * HD + d0, x);
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
  const size_t stripe = PAGED ? (size_t)kvh * bs * HD : ((size_t)kv_row * hkv + kvh) * sk * HD;
  const T* kb = k + stripe;
  const T* vb = v + stripe;
  const float* qw = Qs + warp * ROWS * HD;
  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BK) {
    __syncthreads();  // Q is staged; the previous tile is consumed
    for (int c = tid; c < BK * CPR; c += blockDim.x) {
      const int j = c / CPR, d0 = (c % CPR) * VN, key = kv0 + j;
      float kx[VN], vx[VN];
      if (key < sk) {
        size_t row = (size_t)key * HD;
        if constexpr (PAGED) {  // row key % bs of pool block bt[b, key / bs]
          const int e = bt_row[key / bs];
          row = ((size_t)((unsigned)e < (unsigned)nb ? e : 0) * hkv * bs + key % bs) * HD;
        }
        Vec16<T>::load(kb + row + d0, kx);
        Vec16<T>::load(vb + row + d0, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kx[i] = vx[i] = 0.f;
      }
      store4<VN>(Ks + j * KS + d0, kx);
      store4<VN>(Vs + j * HD + d0, vx);
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
      T* o = out + (((size_t)b * hq + h) * sq + rg / g) * HD + lane * DPL;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DPL; ++c) store_as(o + c, acc[r][c] / denom);
    }
  }
}

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
// give every SM about two, each chunk a whole number of 32-key tiles.
// Returns the chunk's length in keys and sets *splits.
inline int split_chunk(int b, int hq, int hkv, int sq, int sk, int* splits) {
  const int blocks = (sq * (hq / hkv) + ROWS_BLOCK - 1) / ROWS_BLOCK * b * hkv;
  const int sms = sm_count();
  const int tiles = (sk + BK - 1) / BK;
  int want = (2 * sms + blocks - 1) / blocks;
  want = want < 1 ? 1 : (want > tiles ? tiles : want);
  const int chunk = (tiles + want - 1) / want * BK;
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
  auto kern = kernel<T, HD, PAGED, SPLIT>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int g = a.hq / a.hkv, q_tiles = (a.sq * g + ROWS_BLOCK - 1) / ROWS_BLOCK;
  int splits = 1, chunk = a.sk;
  if (SPLIT) {
    chunk = split_chunk(a.b, a.hq, a.hkv, a.sq, a.sk, &splits);
    if (partials_floats(splits, a.b, a.hq, a.sq, HD) > a.part_floats)
      return ERR_BAD_ARGS;  // the workspace is too small for these splits
  }
  const dim3 grid(q_tiles, a.b * a.hkv, splits);
  kern<<<grid, WARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.bt, a.nb, a.bs, a.nbps, a.rows, a.n_cache, static_cast<const int*>(a.q_pos),
      static_cast<T*>(a.out), a.part, a.hq, a.hkv, a.sq, a.sk, chunk, a.scale, a.window);
  err = cudaGetLastError();
  if (!SPLIT || err != cudaSuccess) return err;
  merge_partials<T, HD><<<dim3(a.sq * g, a.b * a.hkv), HD, 0, a.stream>>>(
      a.part, static_cast<T*>(a.out), splits, a.hq, a.hkv, a.sq);
  return cudaGetLastError();
}

// The (dtype, head_dim) instances of one layout: head_dim 64, 128 and 256
// (recurrentgemma, gptj-parallel) in every layout; the dense unsplit one is
// the only one that takes a window.
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
