// Causal GQA flash attention for prompt prefill.
//
// Replaces the Pallas kernel repro/kernels/prefill_attention.py::flash_prefill
// (body _prefill_kernel / _flash_update).  Same contract: q (b, hq, Sq, hd),
// k/v (b, hkv, Sk, hd), q_pos (b, Sq) int32; query row i attends key j iff
// j <= q_pos[b, i] (and j < Sk); rows with q_pos = -1 emit exact zeros;
// fp32 running (m, l, acc) on bf16 or fp32 inputs; normalized output in the
// input type.
//
// Bound on the H100: at prompt lengths of a few hundred tokens the work is
// ~4*hd FLOPs per (query, key) pair against one read of q/k/v, so the card
// is bound by operations, not bytes: it needs the tensor cores to get near
// its bound.  This first version keeps every product in fp32 FMA on the CUDA
// cores (no mma/wgmma yet) and aims only at being right and simple; its time
// beside the bound is in PERF.md.
//
// Design.  The TPU kernel walks a sequential third grid axis over KV blocks;
// GPU blocks run in no order, so here one block owns one (batch, kv head,
// q tile) and loops over the KV tiles itself.  The g query heads that share
// a KV head are folded into the tile (as _fold_q does): a tile is 64 rows
// (query position, head) of one KV head, 8 rows per warp.  Per 32-key tile
// the block stages K and V in shared memory as fp32 (16-byte loads); each
// lane scores one key against its warp's 8 rows (K rows padded by 4 floats
// so the 16-byte reads of 8 neighbouring lanes hit distinct banks), the warp
// does the online softmax with shuffles, and each lane accumulates hd/32
// output dimensions of P V.  KV tiles past the tile's largest q_pos are skipped
// (the kv0 <= max(q_pos) rule of _flash_update).
#include "common.cuh"

namespace {

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

template <typename T, int HD>
__global__ void __launch_bounds__(WARPS * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ q_pos,
                     T* __restrict__ out, int hq, int hkv, int sq, int sk,
                     float scale) {
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

  int pos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int rg = row0 + warp * ROWS + r;
    pos[r] = rg < n_rows ? q_pos[(size_t)b * sq + rg / g] : -1;
  }
  int max_pos = -1;
  const int last_row = min(row0 + ROWS_BLOCK, n_rows) - 1;
  for (int i = row0 / g; i <= last_row / g; ++i) max_pos = max(max_pos, q_pos[(size_t)b * sq + i]);
  const int kv_end = min(sk, max_pos + 1);

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_BIG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const T* kb = k + (size_t)bh * sk * HD;
  const T* vb = v + (size_t)bh * sk * HD;
  const float* qw = Qs + warp * ROWS * HD;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // Q is staged; the previous tile is consumed
    for (int c = tid; c < BK * CPR; c += blockDim.x) {
      const int j = c / CPR, d0 = (c % CPR) * VN, key = kv0 + j;
      float kx[VN], vx[VN];
      if (key < sk) {
        Vec16<T>::load(kb + (size_t)key * HD + d0, kx);
        Vec16<T>::load(vb + (size_t)key * HD + d0, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kx[i] = vx[i] = 0.f;
      }
      store4<VN>(Ks + j * KS + d0, kx);
      store4<VN>(Vs + j * HD + d0, vx);
    }
    __syncthreads();

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
      const bool ok = key <= pos[r] && key < sk;
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
    const int h = kvh * g + rg % g;
    T* o = out + (((size_t)b * hq + h) * sq + rg / g) * HD + lane * DPL;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) store_as(o + c, acc[r][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           void* out, int b, int hq, int hkv, int sq, int sk, float scale,
           cudaStream_t stream) {
  auto kern = flash_prefill_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int g = hq / hkv;
  const dim3 grid((sq * g + ROWS_BLOCK - 1) / ROWS_BLOCK, b * hkv);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_pos),
      static_cast<T*>(out), hq, hkv, sq, sk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* q_pos, void* out, int b, int hq,
                             int hkv, int sq, int sk, int hd, int dtype,
                             float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk <= 0 || b * hkv > 65535)
    return ERR_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, q_pos, out, b, hq, hkv, sq, sk, scale, st);
  if (dtype == DTYPE_BF16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, q_pos, out, b, hq, hkv, sq, sk, scale, st);
  if (dtype == DTYPE_F32 && hd == 128)
    return launch<float, 128>(q, k, v, q_pos, out, b, hq, hkv, sq, sk, scale, st);
  if (dtype == DTYPE_F32 && hd == 64)
    return launch<float, 64>(q, k, v, q_pos, out, b, hq, hkv, sq, sk, scale, st);
  return ERR_BAD_ARGS;
}
