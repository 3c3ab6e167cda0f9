// Row-wise top-k with ties to the lowest index.
//
// Replaces the Pallas kernel repro/kernels/topk_shard.py::topk (body
// _topk_kernel).  Same contract: x (rows, n) -> the k largest values of each
// row, largest first, as fp32 values and int32 indices; among equal values
// the lowest index comes first (greedy sampling is idx[:, 0], so the tie
// order decides tokens).
//
// Bound on the H100: one read of the logits (rows * n * 4 bytes for fp32)
// and about one comparison per element, so the kernel is bound by bytes.
//
// Design.  A 64000-float row is 250 KiB, more than a block's 227 KB of
// shared memory, and a TPU-style running top-k along a sequential grid axis
// has no GPU counterpart.  So the work is cut in stages: one block per
// (row, chunk of 4096 elements) keeps its chunk in registers (16 elements a
// thread) and extracts the chunk's k best by k rounds of block-wide argmax
// on (value, index) pairs, the order being value descending, then index
// ascending.  Each chunk's k candidates, with their original indices, form
// the input of the next stage, until one chunk is left per row; that stage
// writes the result.  For the vocabularies served here two stages suffice.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int EPT = 16;                 // elements per thread
constexpr int CHUNK = THREADS * EPT;    // elements per block
constexpr int MAX_K = CHUNK / 16;       // each stage shrinks a row >= 16x

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// x (rows, n) with optional original indices x_idx (rows, n); writes the k
// best of each chunk to out (rows, n_chunks, k) in order.  Empty slots are
// (-inf, INT_MAX), which lose to every element, -inf ones included.
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_chunk_kernel(const T* __restrict__ x, const int* __restrict__ x_idx,
                  int n, int k, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  __shared__ float sv[THREADS / 32];
  __shared__ int si[THREADS / 32];
  __shared__ int win;
  const int row = blockIdx.y, chunk = blockIdx.x, n_chunks = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* xr = x + (size_t)row * n;
  const int* ir = x_idx ? x_idx + (size_t)row * n : nullptr;

  float val[EPT];
  int idx[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int c = chunk * CHUNK + e * THREADS + threadIdx.x;
    if (c < n) {
      val[e] = to_float(xr[c]);
      idx[e] = ir ? ir[c] : c;
    } else {
      val[e] = -INFINITY;
      idx[e] = INT_MAX;
    }
  }

  float* ov = out_v + ((size_t)row * n_chunks + chunk) * k;
  int* oi = out_i + ((size_t)row * n_chunks + chunk) * k;
  for (int t = 0; t < k; ++t) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (better(val[e], idx[e], bv, bi)) {
        bv = val[e];
        bi = idx[e];
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    if (lane == 0) {
      sv[warp] = bv;
      si[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < THREADS / 32 ? sv[lane] : -INFINITY;
      bi = lane < THREADS / 32 ? si[lane] : INT_MAX;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, bv, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(v2, i2, bv, bi)) {
          bv = v2;
          bi = i2;
        }
      }
      if (lane == 0) {
        win = bi;
        ov[t] = bv;
        oi[t] = bi;
      }
    }
    __syncthreads();
    const int w = win;  // indices are unique within a row: remove the winner
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (idx[e] == w) {
        val[e] = -INFINITY;
        idx[e] = INT_MAX;
      }
  }
}

int n_chunks(int n) { return (n + CHUNK - 1) / CHUNK; }

}  // namespace

// Pairs of (float, int) scratch the wrapper must pass for these sizes.
extern "C" int topk_workspace(int rows, int n, int k) {
  return n_chunks(n) > 1 ? 2 * rows * n_chunks(n) * k : 0;
}

// Kernel launches one topk call makes for these sizes: one per stage.
extern "C" int topk_launches(int n, int k) {
  int stages = 1;
  for (; n_chunks(n) > 1; ++stages) n = n_chunks(n) * k;
  return stages;
}

extern "C" int topk(const void* x, int dtype, int rows, int n, int k,
                    void* vals, void* idx, void* work_v, void* work_i,
                    void* stream) {
  if (rows <= 0 || rows > 65535 || k <= 0 || k > n || k > MAX_K ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return ERR_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* buf_v[2] = {static_cast<float*>(work_v),
                     static_cast<float*>(work_v) + (size_t)rows * n_chunks(n) * k};
  int* buf_i[2] = {static_cast<int*>(work_i),
                   static_cast<int*>(work_i) + (size_t)rows * n_chunks(n) * k};
  const float* in_v = nullptr;  // stage >= 1 input: candidates of the last stage
  const int* in_i = nullptr;
  for (int stage = 0;; ++stage) {
    const int c = n_chunks(n);
    float* ov = c == 1 ? static_cast<float*>(vals) : buf_v[stage % 2];
    int* oi = c == 1 ? static_cast<int*>(idx) : buf_i[stage % 2];
    const dim3 grid(c, rows);
    if (stage == 0 && dtype == DTYPE_BF16)
      topk_chunk_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), nullptr, n, k, ov, oi);
    else
      topk_chunk_kernel<float><<<grid, THREADS, 0, st>>>(
          stage == 0 ? static_cast<const float*>(x) : in_v, in_i, n, k, ov, oi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || c == 1) return err;
    in_v = ov;
    in_i = oi;
    n = c * k;
  }
}
