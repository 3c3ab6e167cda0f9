// Single-token GQA attention returning flash partials: the body shared by
// decode_attention.cu (a dense (b, hkv, S, hd) cache) and
// paged_decode_attention.cu (block pools read through a block table).  The
// template parameter PAGED picks how a cache row's address is found; the
// rest -- staging, scoring, the online softmax, the merge of the warps'
// partials -- is one code path.
//
// Design.  The TPU kernel walks cache blocks along a sequential grid axis.
// Here the grid is (b * hkv, query-head groups of 8, splits): block
// (bh, group, z) owns up to 8 of its KV head's g query heads and keys
// [z * chunk, (z + 1) * chunk) of its cache row -- flash-decoding: at
// recurrentgemma-9b's b 4, hkv 1, g 16 an unsplit grid is 8 blocks on 132
// SMs, while the split gives about one block to every SM (the caller's plan,
// ops.decode_split_plan: one wave, since a block takes most of an SM's
// shared memory and every split adds to the merge).  Its warps (8
// for bf16, 4 for fp32; at head_dim 256, 4 and 2, so that the staged tiles
// fit the 232,448 bytes a block may use: 206,848 and 140,288) share the
// chunk 32 keys at a time (warp w of W takes tiles w, w + W, ...), each
// with its own running (m, l, acc).  A warp stages its tile in its own
// slice of shared memory -- K widened to fp32, V as stored -- with 16-byte
// loads that are all in flight together, so a tile costs one round trip to
// device memory; each lane then scores one key against the warp's query
// heads in fp32 FMA (~16 FLOPs a byte at g 16, within the CUDA cores'
// reach) and accumulates hd/32 dimensions of P V.  A tile whose mask is all
// false (unallocated blocks, the slot's unwritten tail, a window's far
// side) is skipped before any K/V load, as the TPU kernel skips a dead
// block's update, so a split with no valid key writes an empty partial
// without touching K/V.  The warps' partials are merged in shared memory
// by log-sum-exp.
//
// The merge of the splits is in the same launch: each block writes its
// fp32 (m, l, acc) per head to a workspace, makes it visible
// (__threadfence) and adds one to its (bh, group)'s arrival counter; the
// block that arrives last merges the splits by log-sum-exp into m, l, acc
// (the output contract) and sets the counter back to 0.  One launch, not a
// second merge launch as flash_verify has: every decode step is host
// bound, and a second launch per layer would add host work on exactly that
// path.  The counters are an int32 buffer the caller keeps zeroed between
// launches; they assume launches on one stream at a time (two streams at
// once would need a buffer each).  With one split (b * hkv large enough to
// fill the card) a block writes the outputs itself and touches neither.
//
// An int8 cache (Q8: the int8 KV cache of ``ParallelConfig.kv_quant``)
// stores int8 K/V with one bf16 scale per (row, KV head, key).  Its tile is
// loaded 16 values a 16-byte load, each value made bf16(fp32(q) * fp32(s))
// in registers -- the bytes of the plain dequantization -- and stored in the
// tile as the bf16 path stores a bf16 cache's (K widened to fp32, V as
// bf16), so the scoring, the softmax, the merge and the split plan are the
// bf16 path's and the result is its result on the dequantized cache, bit
// for bit.  Lane l loads the scales of key t0 + l; a row's scale reaches
// the lanes that copy it by a shuffle, as a paged row's block does.
//
// Paged rows.  There is no scalar prefetch on Hopper, so the block reads
// its slot's table row itself: lane l loads the pool block of view index
// t0 + l, and a row's block reaches the lanes that copy it by a shuffle.
// A 32-key tile spans 32 / bs pool blocks (two at bs = 16): several table
// entries are gathered into one shared-memory tile, where the TPU takes one
// grid step per pool block.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace decode {

constexpr int ROWS = 8;           // query heads per block
constexpr int BK = 32;            // keys per tile: one per lane; a split chunk is whole tiles
constexpr int MAX_SPLITS = 1024;  // the last block's merge weights fit the dead tiles

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

// Stage one 16-byte load of a K row and of a V row into a warp's tile: K
// widened to fp32, V as stored
template <typename T>
__device__ __forceinline__ void stage(const uint4& rk, const uint4& rv, float* kd, T* vd) {
  constexpr int VN = Vec16<T>::N;
  float x[VN];
  Vec16<T>::load(reinterpret_cast<const T*>(&rk), x);
#pragma unroll
  for (int i = 0; i < VN; i += 4)
    *reinterpret_cast<float4*>(kd + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  *reinterpret_cast<uint4*>(vd) = rv;
}

// The same for 16 int8 values of K and of V with their rows' scales: each
// value made bf16(fp32(q) * fp32(s)), K then widened to fp32, V kept bf16
template <typename T>
__device__ __forceinline__ void stage_q8(const uint4& rk, const uint4& rv, float sk, float sv,
                                         float* kd, T* vd) {
  const int8_t* qk = reinterpret_cast<const int8_t*>(&rk);
  const int8_t* qv = reinterpret_cast<const int8_t*>(&rv);
  __align__(16) __nv_bfloat16 y[16];
#pragma unroll
  for (int i = 0; i < 16; i += 4) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[e] = __bfloat162float(__float2bfloat16_rn((float)qk[i + e] * sk));
    *reinterpret_cast<float4*>(kd + i) = make_float4(x[0], x[1], x[2], x[3]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) y[i] = __float2bfloat16_rn((float)qv[i] * sv);
  *reinterpret_cast<uint4*>(vd) = *reinterpret_cast<const uint4*>(y);
  *reinterpret_cast<uint4*>(vd + 8) = *reinterpret_cast<const uint4*>(y + 8);
}

// Q8: the cache holds int8 values and bf16 scales (T is then bf16, the
// type of q and of the staged V tile)
template <typename T, int HD, bool PAGED, bool Q8>
__global__ void __launch_bounds__(warps<T, HD>() * 32)
kernel(const T* __restrict__ q, const std::conditional_t<Q8, int8_t, T>* __restrict__ k,
       const std::conditional_t<Q8, int8_t, T>* __restrict__ v,
       const __nv_bfloat16* __restrict__ k_scale, const __nv_bfloat16* __restrict__ v_scale,
       const int* __restrict__ bt, int nb, int bs, int nbps,
       const uint8_t* __restrict__ valid, int valid_stride,
       float* __restrict__ m_out, float* __restrict__ l_out,
       float* __restrict__ acc_out, float* __restrict__ part, int* __restrict__ counters,
       int hq, int hkv, int S, int chunk, float scale) {
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

  // the block's query heads, widened to fp32, 16 bytes a load
#pragma unroll
  for (int c = tid; c < ROWS * CPR; c += WARPS * 32) {
    const int r = c / CPR, d0 = (c % CPR) * VN;
    float x[VN];
    if (r < nr) {
      Vec16<T>::load(q + ((size_t)b * hq + kvh * g + r0 + r) * HD + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; i += 4)
      *reinterpret_cast<float4*>(Qs + r * HD + d0 + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
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
  const auto* kb = k + (PAGED ? (size_t)kvh * bs * HD : (size_t)bh * S * HD);
  const auto* vb = v + (PAGED ? (size_t)kvh * bs * HD : (size_t)bh * S * HD);
  const size_t block_stride = (size_t)hkv * bs * HD;  // paged: elements per pool block
  float* Kw = Kall + warp * BK * KS;
  T* Vw = Vall + warp * BK * HD;
  // this block's keys: [z * chunk, min(S, (z + 1) * chunk)), whole tiles
  const int kv_hi = min(S, (int)blockIdx.z * chunk + chunk);
  for (int t0 = blockIdx.z * chunk + warp * BK; t0 < kv_hi; t0 += WARPS * BK) {
    __syncwarp();
    // the tile's K (widened to fp32) and V (as stored): every load of the
    // tile is in flight at once, after the mask says the tile is live
    const int key = t0 + lane;
    const bool ok = key < S && vm[key] != 0;
    if (!__any_sync(0xffffffffu, ok)) continue;  // a dead tile: no loads, no update
    int blk_lane = 0;  // paged: the pool block holding this lane's key
    if constexpr (PAGED) {
      if (key < S) {
        const int e = bt_row[key / bs];
        blk_lane = (unsigned)e < (unsigned)nb ? e : 0;
      }
    }
    // the rows' 16-byte loads, LPR a row (VN stored values a load, 16 for
    // Q8); the addressing is shared, only staging a load differs
    constexpr int EPL = Q8 ? 16 : VN;
    constexpr int LPR = HD / EPL;
    float ks_lane = 0.f, vs_lane = 0.f;  // Q8: this lane's key scales (0 past S)
    if constexpr (Q8) {
      if (key < S) {
        const size_t srow = PAGED ? ((size_t)blk_lane * hkv + kvh) * bs + key % bs
                                  : (size_t)bh * S + key;
        ks_lane = __bfloat162float(k_scale[srow]);
        vs_lane = __bfloat162float(v_scale[srow]);
      }
    }
#pragma unroll
    for (int it = 0; it < LPR; ++it) {
      const int c = it * 32 + lane, j = c / LPR, d0 = (c % LPR) * EPL;
      size_t row;
      if constexpr (PAGED) {
        const int blk = __shfl_sync(0xffffffffu, blk_lane, j);
        row = (size_t)blk * block_stride + (size_t)((t0 + j) % bs) * HD;
      } else {
        row = (size_t)(t0 + j) * HD;
      }
      uint4 rk = make_uint4(0, 0, 0, 0), rv = make_uint4(0, 0, 0, 0);
      if (t0 + j < S) {
        rk = *reinterpret_cast<const uint4*>(kb + row + d0);
        rv = *reinterpret_cast<const uint4*>(vb + row + d0);
      }
      float* kd = Kw + j * KS + d0;
      T* vd = Vw + j * HD + d0;
      if constexpr (Q8) {
        const float sk = __shfl_sync(0xffffffffu, ks_lane, j);
        const float sv = __shfl_sync(0xffffffffu, vs_lane, j);
        stage_q8(rk, rv, sk, sv, kd, vd);
      } else {
        stage(rk, rv, kd, vd);
      }
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

  const int splits = gridDim.z;
  const size_t n_part = (size_t)splits * (gridDim.x / hkv) * hq;  // splits x b * hq rows
  for (int e = tid; e < nr * HD; e += blockDim.x) {
    const int r = e / HD, d = e % HD;
    const size_t row = (size_t)b * hq + kvh * g + r0 + r;
    float M = NEG_BIG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Ms[w][r]);
    float L = 0.f, A = 0.f;
    if (M > NEG_BIG / 2) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = expf(Ms[w][r] - M);
        L += Ls[w][r] * c;
        A += As[(w * ROWS + r) * HD + d] * c;
      }
    }
    if (splits == 1) {  // the block's partial is the output
      acc_out[row * HD + d] = A;
      if (d == 0) {
        m_out[row] = M > NEG_BIG / 2 ? M : -INFINITY;  // no valid key in the whole cache
        l_out[row] = L;
      }
    } else {  // workspace: acc (splits, b * hq, HD), then m and l (splits, b * hq)
      const size_t i = (size_t)blockIdx.z * (n_part / splits) + row;
      part[i * HD + d] = A;
      if (d == 0) {
        part[n_part * HD + i] = M;
        part[n_part * (HD + 1) + i] = L;
      }
    }
  }
  if (splits == 1) return;

  // the splits' arrival: the last block of this (bh, group) merges them
  __shared__ int last;
  int* counter = counters + blockIdx.x * gridDim.y + blockIdx.y;
  __threadfence();  // this block's partial is visible before its arrival
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // per (split, head) weight exp(m_z - M) into the dead tiles, then acc by
  // float4 columns, each thread's columns side by side so that its loads
  // of several splits are in flight together; partials are read through
  // L2 (__ldcg), where the other blocks wrote them
  float* Wz = Kall;                     // splits x ROWS
  float* Mf = Wz + splits * ROWS;       // ROWS merged maxima
  float* Lf = Mf + ROWS;                // ROWS merged sums
  const size_t per_split = n_part / splits;
  for (int r = warp; r < nr; r += WARPS) {
    const size_t row = (size_t)b * hq + kvh * g + r0 + r;
    float M = NEG_BIG;
    for (int z = lane; z < splits; z += 32)
      M = fmaxf(M, __ldcg(part + n_part * HD + z * per_split + row));
    M = warp_max(M);
    float L = 0.f;
    for (int z = lane; z < splits; z += 32) {
      const size_t i = z * per_split + row;
      const float c = M > NEG_BIG / 2 ? expf(__ldcg(part + n_part * HD + i) - M) : 0.f;
      Wz[z * ROWS + r] = c;
      L += c * __ldcg(part + n_part * (HD + 1) + i);
    }
    L = warp_sum(L);
    if (lane == 0) {
      Mf[r] = M;
      Lf[r] = L;
    }
  }
  __syncthreads();
  constexpr int C4 = HD / 4;                                   // float4 columns per head
  constexpr int SLOTS = (ROWS * C4 + WARPS * 32 - 1) / (WARPS * 32);  // per thread
  float4 A[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) A[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int z = 0; z < splits; ++z) {
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int e = tid + i * WARPS * 32, r = e / C4;
      if (r < nr) {
        const float c = Wz[z * ROWS + r];
        const size_t row = (size_t)b * hq + kvh * g + r0 + r;
        const float4 x = __ldcg(
            reinterpret_cast<const float4*>(part + (z * per_split + row) * HD + (e % C4) * 4));
        A[i].x += c * x.x;
        A[i].y += c * x.y;
        A[i].z += c * x.z;
        A[i].w += c * x.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int e = tid + i * WARPS * 32, r = e / C4, d = (e % C4) * 4;
    if (r >= nr) continue;
    const size_t row = (size_t)b * hq + kvh * g + r0 + r;
    *reinterpret_cast<float4*>(acc_out + row * HD + d) = A[i];  // zeros when no key was valid
    if (d == 0) {
      m_out[row] = Mf[r] > NEG_BIG / 2 ? Mf[r] : -INFINITY;
      l_out[row] = Lf[r];
    }
  }
  if (tid == 0) *counter = 0;  // zeroed for the next launch
}

// The arguments of one launch of either layout.
struct Args {
  const void *q, *k, *v;
  const void *k_scale, *v_scale;  // non-null: an int8 cache with these bf16 scales
  const int* bt;  // paged: block table (b, nbps) over nb pool blocks of bs rows
  int nb, bs, nbps;
  const void* valid;
  int valid_stride;  // 0: one (S,) mask for every row; S: a (b, S) mask
  void *m, *l, *acc;
  float* part;  // splits > 1: the partials workspace, part_floats of them
  int part_floats;
  int* counters;  // splits > 1: n_counters arrival counters, zero between launches
  int n_counters;
  int chunk, splits;  // keys per split (whole tiles) and splits covering S
  int b, hq, hkv, S;
  float scale;
  cudaStream_t stream;
};

// fp32 floats of the workspace of a split launch: acc (splits, b * hq, hd),
// then m and l (splits, b * hq).
inline long long partials_floats(int splits, int b, int hq, int hd) {
  return (long long)splits * b * hq * (hd + 2);
}

template <typename T, int HD, bool PAGED, bool Q8 = false>
int launch(const Args& a) {
  using C = std::conditional_t<Q8, int8_t, T>;
  auto kern = kernel<T, HD, PAGED, Q8>;
  constexpr size_t smem = smem_bytes<T, HD>();
  static_assert(smem <= 232448, "staged tiles exceed a block's shared memory");
  static_assert(warps<T, HD>() * BK * (HD + 4) >= MAX_SPLITS * ROWS + 2 * ROWS,
                "the merge weights do not fit the dead tiles");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int g = a.hq / a.hkv;
  const dim3 grid(a.b * a.hkv, (g + ROWS - 1) / ROWS, a.splits);
  kern<<<grid, warps<T, HD>() * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k), static_cast<const C*>(a.v),
      static_cast<const __nv_bfloat16*>(a.k_scale), static_cast<const __nv_bfloat16*>(a.v_scale),
      a.bt, a.nb, a.bs, a.nbps, static_cast<const uint8_t*>(a.valid), a.valid_stride,
      static_cast<float*>(a.m), static_cast<float*>(a.l), static_cast<float*>(a.acc), a.part,
      a.counters, a.hq, a.hkv, a.S, a.chunk, a.scale);
  return cudaGetLastError();
}

// The (dtype, head_dim) instances of one layout: head_dim 64, 128 and 256
// (recurrentgemma's MQA, gptj-parallel's MHA) in both, and for an int8
// cache (scales given; q bf16) at each head_dim.  A plan that does not
// cover S with whole tiles and no empty split, or a workspace or counter
// buffer too small for it, is refused.
template <bool PAGED>
int dispatch(const Args& a, int hd, int dtype) {
  if (a.b <= 0 || a.hkv <= 0 || a.hq % a.hkv || a.S <= 0 ||
      (a.hq / a.hkv + ROWS - 1) / ROWS > 65535 || a.b * a.hkv > 0x7fffffff / 4)
    return ERR_BAD_ARGS;
  const int groups = (a.hq / a.hkv + ROWS - 1) / ROWS;
  if (a.chunk <= 0 || a.chunk % BK || a.splits < 1 || a.splits > MAX_SPLITS ||
      (long long)(a.splits - 1) * a.chunk >= a.S || (long long)a.splits * a.chunk < a.S)
    return ERR_BAD_ARGS;
  if (a.splits > 1 && (a.part == nullptr || a.counters == nullptr ||
                       a.part_floats < partials_floats(a.splits, a.b, a.hq, hd) ||
                       (long long)a.n_counters < (long long)a.b * a.hkv * groups))
    return ERR_BAD_ARGS;
  if ((a.k_scale == nullptr) != (a.v_scale == nullptr)) return ERR_BAD_ARGS;
  if (a.k_scale != nullptr) {
    if (dtype != DTYPE_BF16) return ERR_BAD_ARGS;
    if (hd == 256) return launch<__nv_bfloat16, 256, PAGED, true>(a);
    if (hd == 128) return launch<__nv_bfloat16, 128, PAGED, true>(a);
    if (hd == 64) return launch<__nv_bfloat16, 64, PAGED, true>(a);
    return ERR_BAD_ARGS;
  }
  if (dtype == DTYPE_BF16 && hd == 256) return launch<__nv_bfloat16, 256, PAGED>(a);
  if (dtype == DTYPE_F32 && hd == 256) return launch<float, 256, PAGED>(a);
  if (dtype == DTYPE_BF16 && hd == 128) return launch<__nv_bfloat16, 128, PAGED>(a);
  if (dtype == DTYPE_BF16 && hd == 64) return launch<__nv_bfloat16, 64, PAGED>(a);
  if (dtype == DTYPE_F32 && hd == 128) return launch<float, 128, PAGED>(a);
  if (dtype == DTYPE_F32 && hd == 64) return launch<float, 64, PAGED>(a);
  return ERR_BAD_ARGS;
}

}  // namespace decode
