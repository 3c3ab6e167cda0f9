// Fused dequantize-and-matmul over weight-only-quantized weights.
//
// Replaces the Pallas kernel repro/kernels/wquant_matmul.py::dequant_matmul
// (bodies _dq8_kernel and _dq4_kernel).  Same contract: x (T, K) bf16 times
// dequant(q, scale) -> (T, N) in fp32 or bf16, summed in fp32, the bf16
// weight never written to device memory.
//  * int8: q int8 (K, N) and one bf16 scale per column (N,).  The scale
//    commutes with the K sum, so it is applied once to the fp32 sum.
//  * int4: q uint8 (K/2, N), even k in the low nibble, and one bf16 scale per
//    group-long K segment and column (K/group, N).  Each weight is q * s in
//    fp32 (exact: 3 bits times 8) before its product with x.
//
// Bound on the H100.  At decode widths (T = 4) each weight byte is read once
// and feeds 2T operations, far below the ~295 operations per byte at which
// the tensor cores would become the limit: the kernel is bound by bytes, the
// packed weights and scales at 3.35 TB/s.  At prefill widths (T = 512) a byte
// feeds 1024 (int8) or 2048 (int4) operations: bound by operations.
//
// Design.  Pallas walks K along a sequential grid axis and carries the sum
// in VMEM scratch; here a block loops over its own K range.  K is also split
// across blocks, so that narrow outputs (N = 512 or 8192) still fill the 132
// SMs: each split writes fp32 partial sums to a workspace and a second kernel
// adds the splits in a fixed order, applies the int8 scale and casts.  No
// atomics: two calls give the same bits.
//  * GEMV (T <= 16): a thread owns CPT adjacent columns for the TT rows of x
//    its block serves (TT * CPT = 64 sums in registers; TT is 4, 8 or 16).
//    Neighbouring threads own neighbouring columns, so a warp's loads of a
//    row of q are contiguous: 16 bytes a thread at TT = 4 (8 and 4 bytes at
//    TT = 8 and 16) where the row allows it, byte loads at a ragged edge.
//    Each thread loads the next 4 rows of q before it uses the current 4,
//    so loads stay in flight while it computes.  x is staged in shared
//    memory 128 K rows at a time and read as broadcasts.  Bytes and
//    nibbles become floats through the mantissa of 2^23 (an OR and a
//    subtraction), not through the slower int-to-float conversion.
//  * GEMM (T > 16): 128 x 128 output tiles, 256 threads with 8 x 8 sums
//    each; x and the dequantized weight are staged as fp32 in shared memory
//    16 K rows at a time (16-byte loads where aligned), and every product is
//    an fp32 FMA on the CUDA cores, 64 per four 16-byte shared loads.  A
//    dequantized int4 weight has up to 11 significant bits, more than bf16
//    holds, so exact sums on the tensor cores need TF32 (int4) or bf16 on the
//    raw int8 values (int8): later work.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int SM_TARGET = 264;     // blocks to aim for: two per SM of 132
constexpr int GEMV_THREADS = 128;
constexpr int GEMV_KT = 128;       // K rows of x staged at a time
constexpr int GEMV_SUMS = 64;      // TT * CPT sums per thread
constexpr int BM = 128, BN = 128, BK = 16, GEMM_THREADS = 256;
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }

// Small integers to float without a conversion instruction: OR-ing v < 2^23
// into the mantissa of 2^23 (0x4B000000) gives the float 2^23 + v exactly.
// A stored byte u of a signed value n has u ^ 0x80 = n + 128, a stored
// nibble p has p ^ 8 = n + 8, so subtracting the biases below gives n.
constexpr float BYTE_BIAS = 8388736.f;  // 2^23 + 128
constexpr float NIB_BIAS = 8388616.f;   // 2^23 + 8

__device__ __forceinline__ float biased_byte(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFFu) ^ 0x4B000080u);
}

__device__ __forceinline__ float biased_nibble(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u);
}

// CPT bytes of a row of q starting at p, as CPT/4 little-endian words: one
// vector load when the row allows it, else byte loads of the `valid` ones.
template <int CPT>
__device__ __forceinline__ void load_cols(const uint8_t* p, bool vec, int valid,
                                          uint32_t (&w)[CPT / 4]) {
  if (vec && valid >= CPT) {
    if constexpr (CPT == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (CPT == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < CPT / 4; ++i) w[i] = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j)
    if (j < valid) w[j / 4] |= static_cast<uint32_t>(p[j]) << (8 * (j % 4));
}

// Final value of one output: the int8 scale once, then the cast.
template <bool INT4, typename OutT>
__device__ __forceinline__ void emit(OutT* out, const __nv_bfloat16* scale, int t, int c,
                                     int N, float v) {
  if (!INT4) v *= bf(scale[c]);
  store_as(out + (size_t)t * N + c, v);
}

// One block: GEMV_THREADS * CPT columns, TT rows of x, one split of K.
// With `work` set the block writes its partial sums there, else the output.
// Rows of q are loaded U at a time, and the next U are loaded before the
// current ones are used, so that each thread keeps U loads in flight while
// it computes.
template <int TT, bool INT4, typename OutT>
__global__ void __launch_bounds__(GEMV_THREADS)
dq_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const __nv_bfloat16* __restrict__ scale, OutT* __restrict__ out,
               float* __restrict__ work, int T, int K, int N, int group, int chunk,
               bool vec) {
  constexpr int CPT = GEMV_SUMS / TT;
  constexpr int U = 4;                  // rows of q per batch
  constexpr int ROWS = INT4 ? 2 : 1;    // K rows in one row of q
  constexpr int STEP = U * ROWS;        // K rows per batch
  __shared__ float xs[GEMV_KT][TT];
  const int c0 = (blockIdx.x * GEMV_THREADS + threadIdx.x) * CPT;
  const int t0 = blockIdx.z * TT;
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int valid = N - c0;  // this thread's columns inside the matrix
  float acc[TT][CPT];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[t][j] = 0.f;
  float s[CPT];  // int4: the scales of the current group
  int cur_group = -1;
  uint32_t w[U][CPT / 4], next[U][CPT / 4];

  // the batch of K rows [kt + kk, kt + kk + STEP) of this tile of kn rows;
  // rows past kn read nothing and meet x = 0
  auto load_batch = [&](int k0, int kk, int kn, uint32_t (&dst)[U][CPT / 4]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kk + u * ROWS < kn) {
        load_cols<CPT>(q + (size_t)((k0 + kk) / ROWS + u) * N + c0, vec, valid, dst[u]);
      } else {
#pragma unroll
        for (int i = 0; i < CPT / 4; ++i) dst[u][i] = 0;
      }
    }
  };

  for (int kt = k_begin; kt < k_end; kt += GEMV_KT) {
    const int kn = min(GEMV_KT, k_end - kt);
    __syncthreads();
    for (int i = threadIdx.x; i < TT * GEMV_KT; i += GEMV_THREADS) {
      const int t = i / GEMV_KT, kk = i % GEMV_KT;
      xs[kk][t] = (kk < kn && t0 + t < T) ? bf(x[(size_t)(t0 + t) * K + kt + kk]) : 0.f;
    }
    __syncthreads();
    if (valid <= 0) continue;
    load_batch(kt, 0, kn, w);
    for (int kk = 0; kk < kn; kk += STEP) {
      if (kk + STEP < kn) load_batch(kt, kk + STEP, kn, next);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = kk + u * ROWS;  // row of xs
        if constexpr (!INT4) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float wf = biased_byte(w[u][j / 4], 8 * (j % 4)) - BYTE_BIAS;
#pragma unroll
            for (int t = 0; t < TT; ++t) acc[t][j] = fmaf(xs[r][t], wf, acc[t][j]);
          }
        } else {
          const int g = (kt + r) / group;
          if (r < kn && g != cur_group) {
            cur_group = g;
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[j] = j < valid ? bf(scale[(size_t)g * N + c0 + j]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < CPT; ++j) {  // nibble * scale, both exact in fp32
            const int sh = 8 * (j % 4);
            const float lo = (biased_nibble(w[u][j / 4], sh) - NIB_BIAS) * s[j];
            const float hi = (biased_nibble(w[u][j / 4], sh + 4) - NIB_BIAS) * s[j];
#pragma unroll
            for (int t = 0; t < TT; ++t) {
              acc[t][j] = fmaf(xs[r][t], lo, acc[t][j]);
              acc[t][j] = fmaf(xs[r + 1][t], hi, acc[t][j]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < CPT / 4; ++i) w[u][i] = next[u][i];
    }
  }
  if (valid <= 0) return;
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    if (t0 + t >= T) break;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (j >= valid) break;
      if (work)
        work[((size_t)blockIdx.y * T + t0 + t) * N + c0 + j] = acc[t][j];
      else
        emit<INT4>(out, scale, t0 + t, c0 + j, N, acc[t][j]);
    }
  }
}

// The i-th (0..7) of a thread's 8 rows (or columns) in a 128-wide tile:
// four consecutive ones at 4 * lane16, then four more 64 further on, so
// that each four are one aligned 16-byte load.
__device__ __forceinline__ int quad(int lane16, int i) {
  return (i / 4) * 64 + lane16 * 4 + i % 4;
}

// One block: a BM x BN output tile, one split of K.  Each thread keeps an
// 8 x 8 tile of sums; per K row it reads 8 values of x and 8 weights from
// shared memory as four 16-byte loads for 64 FMAs.
template <bool INT4, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS)
dq_gemm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const __nv_bfloat16* __restrict__ scale, OutT* __restrict__ out,
               float* __restrict__ work, int T, int K, int N, int group, int chunk) {
  __shared__ __align__(16) float xs[BK][BM];
  __shared__ __align__(16) float ws[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    {  // x: thread -> one row, 8 consecutive K; neighbouring threads store
       // neighbouring rows, so the transposing store is free of conflicts
      const int m = threadIdx.x % BM, kk0 = (threadIdx.x / BM) * 8, k0 = kt + kk0;
      const __nv_bfloat16* p = x + (size_t)(m0 + m) * K + k0;
      float v[8];
      if (m0 + m < T && k0 + 8 <= k_end && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
        Vec16<__nv_bfloat16>::load(p, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (m0 + m < T && k0 + e < k_end) ? bf(p[e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[kk0 + e][m] = v[e];
    }
    if constexpr (INT4) {  // thread -> 4 columns of one row of q: 2 K rows
      const int pr = threadIdx.x / 32, c = (threadIdx.x % 32) * 4, k = kt + 2 * pr;
      const int valid = k < k_end ? N - n0 - c : 0;
      uint32_t w[1];
      const uint8_t* p = q + (size_t)(k / 2) * N + n0 + c;
      load_cols<4>(p, reinterpret_cast<uintptr_t>(p) % 4 == 0, valid, w);
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = j < valid ? bf(scale[(size_t)(k / group) * N + n0 + c + j]) : 0.f;
        lo[j] = (biased_nibble(w[0], 8 * j) - NIB_BIAS) * s;
        hi[j] = (biased_nibble(w[0], 8 * j + 4) - NIB_BIAS) * s;
      }
      *reinterpret_cast<float4*>(&ws[2 * pr][c]) = make_float4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<float4*>(&ws[2 * pr + 1][c]) = make_float4(hi[0], hi[1], hi[2], hi[3]);
    } else {  // thread -> 8 columns of one K row
      const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 8, k = kt + r;
      const int valid = k < k_end ? N - n0 - c : 0;
      uint32_t w[2];
      const uint8_t* p = q + (size_t)k * N + n0 + c;
      load_cols<8>(p, reinterpret_cast<uintptr_t>(p) % 8 == 0, valid, w);
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = biased_byte(w[j / 4], 8 * (j % 4)) - BYTE_BIAS;
      *reinterpret_cast<float4*>(&ws[r][c]) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(&ws[r][c + 4]) = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 av = *reinterpret_cast<const float4*>(&xs[kk][quad(ty, 4 * h)]);
        const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][quad(tx, 4 * h)]);
        a[4 * h] = av.x; a[4 * h + 1] = av.y; a[4 * h + 2] = av.z; a[4 * h + 3] = av.w;
        b[4 * h] = bv.x; b[4 * h + 1] = bv.y; b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + quad(ty, i);
    if (m >= T) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + quad(tx, j);
      if (c >= N) continue;
      if (work)
        work[((size_t)blockIdx.z * T + m) * N + c] = acc[i][j];
      else
        emit<INT4>(out, scale, m, c, N, acc[i][j]);
    }
  }
}

// Second pass of a split call: the splits' partial sums in order, the int8
// scale (scale is null for int4), the cast.
template <typename OutT>
__global__ void __launch_bounds__(REDUCE_THREADS)
dq_reduce_kernel(const float* __restrict__ work, int splits, int T, int N,
                 const __nv_bfloat16* __restrict__ scale, OutT* __restrict__ out) {
  const size_t total = (size_t)T * N;
  const size_t i = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= total) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += work[s * total + i];
  if (scale) v *= bf(scale[i % N]);
  store_as(out + i, v);
}

int cdiv(long a, long b) { return static_cast<int>((a + b - 1) / b); }

int gemv_rows(int T) { return T <= 4 ? 4 : (T <= 8 ? 8 : 16); }

bool bad_args(int T, int K, int N, int bits, int group) {
  if (T <= 0 || K <= 0 || N <= 0 || (bits != 8 && bits != 4)) return true;
  return bits == 4 && (group < 2 || group % 2 || K % group);
}

// How K is split: `splits` blocks along K, each over `chunk` rows (a
// multiple of the int4 group, so a group never straddles two splits).
struct Plan {
  int splits, chunk;
};

Plan make_plan(int T, int K, int N, int bits, int group) {
  const int unit = bits == 4 ? group : BK;
  const int units = cdiv(K, unit);
  int blocks;
  if (T <= 16) {
    const int tt = gemv_rows(T);
    blocks = cdiv(N, GEMV_THREADS * (GEMV_SUMS / tt)) * cdiv(T, tt);
  } else {
    blocks = cdiv(T, BM) * cdiv(N, BN);
  }
  int splits = std::min(units, std::max(1, cdiv(SM_TARGET, blocks)));
  const int per = cdiv(units, splits);
  splits = cdiv(units, per);  // no empty split
  return {splits, per * unit};
}

template <int TT, bool INT4, typename OutT>
void launch_gemv(const __nv_bfloat16* x, const uint8_t* q, const __nv_bfloat16* scale,
                 OutT* out, float* work, int T, int K, int N, int group, const Plan& p,
                 cudaStream_t st) {
  constexpr int CPT = GEMV_SUMS / TT;
  const bool vec = reinterpret_cast<uintptr_t>(q) % CPT == 0 && N % CPT == 0;
  const dim3 grid(cdiv(N, GEMV_THREADS * CPT), p.splits, cdiv(T, TT));
  dq_gemv_kernel<TT, INT4, OutT><<<grid, GEMV_THREADS, 0, st>>>(
      x, q, scale, out, work, T, K, N, group, p.chunk, vec);
}

template <bool INT4, typename OutT>
cudaError_t run(const __nv_bfloat16* x, const uint8_t* q, const __nv_bfloat16* scale,
                OutT* out, float* work, int T, int K, int N, int group, cudaStream_t st) {
  const Plan p = make_plan(T, K, N, INT4 ? 4 : 8, group);
  OutT* direct = p.splits > 1 ? nullptr : out;
  float* partial = p.splits > 1 ? work : nullptr;
  if (T <= 16) {
    switch (gemv_rows(T)) {
      case 4: launch_gemv<4, INT4>(x, q, scale, direct, partial, T, K, N, group, p, st); break;
      case 8: launch_gemv<8, INT4>(x, q, scale, direct, partial, T, K, N, group, p, st); break;
      default: launch_gemv<16, INT4>(x, q, scale, direct, partial, T, K, N, group, p, st);
    }
  } else {
    const dim3 grid(cdiv(N, BN), cdiv(T, BM), p.splits);
    dq_gemm_kernel<INT4, OutT><<<grid, GEMM_THREADS, 0, st>>>(
        x, q, scale, direct, partial, T, K, N, group, p.chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  dq_reduce_kernel<OutT><<<cdiv((long)T * N, REDUCE_THREADS), REDUCE_THREADS, 0, st>>>(
      work, p.splits, T, N, INT4 ? nullptr : scale, out);
  return cudaGetLastError();
}

}  // namespace

// fp32 workspace elements a call of these sizes needs (0: not split).
extern "C" int dequant_matmul_workspace(int T, int K, int N, int bits, int group) {
  if (bad_args(T, K, N, bits, group)) return 0;
  const Plan p = make_plan(T, K, N, bits, group);
  return p.splits > 1 ? p.splits * T * N : 0;
}

// Kernel launches a call of these sizes makes: two when K is split.
extern "C" int dequant_matmul_launches(int T, int K, int N, int bits, int group) {
  if (bad_args(T, K, N, bits, group)) return 0;
  return make_plan(T, K, N, bits, group).splits > 1 ? 2 : 1;
}

extern "C" int dequant_matmul(const void* x, const void* q, const void* scale, void* out,
                              int out_dtype, void* work, int T, int K, int N, int bits,
                              int group, void* stream) {
  if (bad_args(T, K, N, bits, group) || (out_dtype != DTYPE_F32 && out_dtype != DTYPE_BF16))
    return ERR_BAD_ARGS;
  if (dequant_matmul_workspace(T, K, N, bits, group) > 0 && work == nullptr) return ERR_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* sb = static_cast<const __nv_bfloat16*>(scale);
  float* wk = static_cast<float*>(work);
  if (out_dtype == DTYPE_F32)
    return bits == 4 ? run<true>(xb, qb, sb, static_cast<float*>(out), wk, T, K, N, group, st)
                     : run<false>(xb, qb, sb, static_cast<float*>(out), wk, T, K, N, group, st);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  return bits == 4 ? run<true>(xb, qb, sb, ob, wk, T, K, N, group, st)
                   : run<false>(xb, qb, sb, ob, wk, T, K, N, group, st);
}
