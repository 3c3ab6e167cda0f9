// Single-token GQA attention returning flash partials: the body shared by
// decode_attention.cu (a dense (b, hkv, S, hd) cache) and
// paged_decode_attention.cu (block pools read through a block table).  The
// template parameter PAGED picks how a cache row's address is found; the
// rest -- staging, scoring, the online softmax, the merge of the warps'
// partials -- is one code path.
//
// Design.  The TPU kernel walks cache blocks along a sequential grid axis.
// Here one block owns one (batch, kv head) and up to 8 of its g query heads;
// its warps (8 for bf16, 4 for fp32; at head_dim 256, 4 and 2, so that the
// staged tiles fit the 232,448 bytes a block may use: 206,848 and 140,288)
// split the cache between them, 32 keys at a time (warp w of W takes tiles
// w, w + W, ...), each with its own running
// (m, l, acc).  A warp stages its tile in its own slice of shared memory
// -- K widened to fp32, V as stored -- with 16-byte loads that are all in
// flight together, so a tile costs one round trip to device memory; each
// lane then scores one key against the warp's query heads and accumulates
// hd/32 dimensions of P V.  At the end the warps' partials are merged in
// shared memory by log-sum-exp.  Split-KV across blocks (more SMs for small
// b * hkv) is left for a later version.
//
// Paged rows.  There is no scalar prefetch on Hopper, so the block reads
// its slot's table row itself: lane l loads the pool block of view index
// t0 + l, and a row's block reaches the lanes that copy it by a shuffle.
// A 32-key tile spans 32 / bs pool blocks (two at bs = 16): several table
// entries are gathered into one shared-memory tile, where the TPU takes one
// grid step per pool block.  A tile whose mask is all false (unallocated
// blocks, the slot's unwritten tail) is skipped before any K/V load, as the
// TPU kernel skips a dead block's update.
#pragma once

#include "common.cuh"

namespace decode {

constexpr int ROWS = 8;  // query heads per block
constexpr int BK = 32;   // keys per tile: one per lane

// 8 warps for bf16; 4 for fp32, whose tiles take twice the shared memory;
// half as many at head_dim 256
template <typename T, int HD>
__host__ __device__ constexpr int warps() {
  return (sizeof(T) == 2 ? 8 : 4) / (HD > 128 ? 2 : 1);
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return (size_t)(ROWS * HD + warps<T, HD>() * BK * (HD + 4)) * sizeof(float) +
         (size_t)warps<T, HD>() * BK * HD * sizeof(T);
}

template <typename T, int HD, bool PAGED>
__global__ void __launch_bounds__(warps<T, HD>() * 32)
kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const int* __restrict__ bt, int nb, int bs, int nbps,
       const uint8_t* __restrict__ valid, int valid_stride,
       float* __restrict__ m_out, float* __restrict__ l_out,
       float* __restrict__ acc_out, int hq, int hkv, int S, float scale) {
  constexpr int WARPS = warps<T, HD>();
  constexpr int DPL = HD / 32;
  constexpr int KS = HD + 4;
  constexpr int VN = Vec16<T>::N;  // elements per 16-byte load
  constexpr int CPR = HD / VN;     // 16-byte chunks per row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);                // ROWS x HD
  float* Kall = Qs + ROWS * HD;                               // WARPS x BK x KS fp32
  T* Vall = reinterpret_cast<T*>(Kall + WARPS * BK * KS);     // WARPS x BK x HD, as stored
  __shared__ float Ms[WARPS][ROWS], Ls[WARPS][ROWS];

  const int g = hq / hkv;
  const int bh = blockIdx.x;  // b * hkv + kv head
  const int b = bh / hkv, kvh = bh % hkv;
  const int r0 = blockIdx.y * ROWS;  // first query head of this block in the group
  const int nr = min(ROWS, g - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < ROWS * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    Qs[e] = r < nr ? to_float(q[((size_t)b * hq + kvh * g + r0 + r) * HD + d]) : 0.f;
  }
  __syncthreads();

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_BIG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  const uint8_t* vm = valid + (size_t)b * valid_stride;
  const int* bt_row = PAGED ? bt + (size_t)b * nbps : nullptr;
  const T* kb = k + (PAGED ? (size_t)kvh * bs * HD : (size_t)bh * S * HD);
  const T* vb = v + (PAGED ? (size_t)kvh * bs * HD : (size_t)bh * S * HD);
  const size_t block_stride = (size_t)hkv * bs * HD;  // paged: elements per pool block
  float* Kw = Kall + warp * BK * KS;
  T* Vw = Vall + warp * BK * HD;
  for (int t0 = warp * BK; t0 < S; t0 += WARPS * BK) {
    __syncwarp();
    // the tile's K (widened to fp32), V (as stored) and this lane's mask
    // byte: every load of the tile is in flight at once
    const int key = t0 + lane;
    const bool ok = key < S && vm[key] != 0;
    int blk_lane = 0;  // paged: the pool block holding this lane's key
    if constexpr (PAGED) {
      if (!__any_sync(0xffffffffu, ok)) continue;  // a dead tile: no loads, no update
      if (key < S) {
        const int e = bt_row[key / bs];
        blk_lane = (unsigned)e < (unsigned)nb ? e : 0;
      }
    }
#pragma unroll
    for (int it = 0; it < CPR; ++it) {
      const int c = it * 32 + lane, j = c / CPR, d0 = (c % CPR) * VN;
      size_t row;
      if constexpr (PAGED) {
        const int blk = __shfl_sync(0xffffffffu, blk_lane, j);
        row = (size_t)blk * block_stride + (size_t)((t0 + j) % bs) * HD;
      } else {
        row = (size_t)(t0 + j) * HD;
      }
      float x[VN];
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t0 + j < S) {
        Vec16<T>::load(kb + row + d0, x);
        raw = *reinterpret_cast<const uint4*>(vb + row + d0);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; i += 4)
        *reinterpret_cast<float4*>(Kw + j * KS + d0 + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      *reinterpret_cast<uint4*>(Vw + j * HD + d0) = raw;
    }
    __syncwarp();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = Kw + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + r * HD + d);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float sv = ok ? s[r] * scale : NEG_BIG;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = ok ? expf(sv - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }

    // P V from the staged tile (rows past S are zeros with p = 0)
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) vv[c] = to_float(Vw[j * HD + lane * DPL + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

  // merge the warps' partials; the K tiles are dead, so their space holds acc
  __syncthreads();
  float* As = Kall;  // WARPS x ROWS x HD
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (lane == 0) {
      Ms[warp][r] = m[r];
      Ls[warp][r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) As[(warp * ROWS + r) * HD + lane * DPL + c] = acc[r][c];
  }
  __syncthreads();

  for (int e = tid; e < nr * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    const size_t row = (size_t)b * hq + kvh * g + r0 + r;
    float M = NEG_BIG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Ms[w][r]);
    if (M <= NEG_BIG / 2) {  // no valid key in the whole cache
      acc_out[row * HD + d] = 0.f;
      if (d == 0) {
        m_out[row] = -INFINITY;
        l_out[row] = 0.f;
      }
      continue;
    }
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(Ms[w][r] - M);
      L += Ls[w][r] * c;
      A += As[(w * ROWS + r) * HD + d] * c;
    }
    acc_out[row * HD + d] = A;
    if (d == 0) {
      m_out[row] = M;
      l_out[row] = L;
    }
  }
}

template <typename T, int HD, bool PAGED>
int launch(const void* q, const void* k, const void* v, const int* bt, int nb,
           int bs, int nbps, const void* valid, int valid_stride, void* m,
           void* l, void* acc, int b, int hq, int hkv, int S, float scale,
           cudaStream_t stream) {
  auto kern = kernel<T, HD, PAGED>;
  constexpr size_t smem = smem_bytes<T, HD>();
  static_assert(smem <= 232448, "staged tiles exceed a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int g = hq / hkv;
  const dim3 grid(b * hkv, (g + ROWS - 1) / ROWS);
  kern<<<grid, warps<T, HD>() * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, nb, bs, nbps,
      static_cast<const uint8_t*>(valid), valid_stride,
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), hq, hkv, S, scale);
  return cudaGetLastError();
}

// The (dtype, head_dim) instances of one layout: head_dim 64, 128 and 256
// (recurrentgemma's MQA, gptj-parallel's MHA) in both.
template <bool PAGED>
int dispatch(const void* q, const void* k, const void* v, const int* bt, int nb,
             int bs, int nbps, const void* valid, int valid_stride, void* m,
             void* l, void* acc, int b, int hq, int hkv, int S, int hd,
             int dtype, float scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv || S <= 0 || (hq / hkv + ROWS - 1) / ROWS > 65535)
    return ERR_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16 && hd == 256)
    return launch<__nv_bfloat16, 256, PAGED>(q, k, v, bt, nb, bs, nbps, valid, valid_stride,
                                             m, l, acc, b, hq, hkv, S, scale, st);
  if (dtype == DTYPE_F32 && hd == 256)
    return launch<float, 256, PAGED>(q, k, v, bt, nb, bs, nbps, valid, valid_stride,
                                     m, l, acc, b, hq, hkv, S, scale, st);
  if (dtype == DTYPE_BF16 && hd == 128)
    return launch<__nv_bfloat16, 128, PAGED>(q, k, v, bt, nb, bs, nbps, valid, valid_stride,
                                             m, l, acc, b, hq, hkv, S, scale, st);
  if (dtype == DTYPE_BF16 && hd == 64)
    return launch<__nv_bfloat16, 64, PAGED>(q, k, v, bt, nb, bs, nbps, valid, valid_stride,
                                            m, l, acc, b, hq, hkv, S, scale, st);
  if (dtype == DTYPE_F32 && hd == 128)
    return launch<float, 128, PAGED>(q, k, v, bt, nb, bs, nbps, valid, valid_stride,
                                     m, l, acc, b, hq, hkv, S, scale, st);
  if (dtype == DTYPE_F32 && hd == 64)
    return launch<float, 64, PAGED>(q, k, v, bt, nb, bs, nbps, valid, valid_stride,
                                    m, l, acc, b, hq, hkv, S, scale, st);
  return ERR_BAD_ARGS;
}

}  // namespace decode
