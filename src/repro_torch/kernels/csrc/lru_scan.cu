// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over the sequence.
//
// Replaces the Pallas kernel repro/kernels/lru_scan.py::lru_scan (body
// _lru_kernel).  Same contract: a, b (batch, seq, w), read as fp32 (fp32 or
// bf16 in memory); h0 (batch, w) fp32; writes every state h (batch, seq, w)
// and the last one h_final (batch, w), both fp32.  Any width: the kernel
// masks the ragged edge itself, so the caller pads nothing.
//
// Bound on the H100: bytes.  Each (row, channel) reads its a and b once and
// writes its h once, with one FMA per element, far below the ~295 operations
// a byte the card needs to be bound by operations.  At the wave shape of
// recurrentgemma-9b (4, 2304, 4096) that is 302 MB read and 151 MB written,
// 0.135 ms at 3.35 TB/s.
//
// Design.  On the TPU a block of 128 channels holds its state in vector
// registers and walks the sequence in a sequential loop.  Here one thread
// owns one (row, channel), neighbouring threads on neighbouring channels, so
// a warp's loads of one step are one 128-byte line; the thread walks the
// sequence itself.  The chain of multiply-adds is serial, but the loads do
// not depend on h: the loop takes U steps at a time and issues all 2U loads
// of a group before the group's first step, so each warp keeps 2U loads in
// flight instead of one pair.  At the wave shape there are only 16,384 threads,
// about one 128-thread block per SM, so the kernel is bound by the latency
// of these groups rather than by bandwidth; splitting the sequence across
// blocks (chunk-local scans carrying (prod a, h), then a fix-up pass) is
// left for a later version.  The product and the sum round separately (no
// FMA), as the plain PyTorch version's do, so the two agree bit for bit.
#include "common.cuh"

namespace lru {

constexpr int THREADS = 128;  // channels per block
constexpr int U = 16;         // steps whose loads are issued together

template <typename T>
__global__ void __launch_bounds__(THREADS)
kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
       float* __restrict__ hs, float* __restrict__ h_final, int s, int w) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= w) return;
  const size_t base = (size_t)row * s * w + c;
  float h = h0[(size_t)row * w + c];
  for (int t0 = 0; t0 < s; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = base + (size_t)(t0 + u) * w;
      const bool live = t0 + u < s;
      av[u] = live ? to_float(a[i]) : 1.f;
      bv[u] = live ? to_float(b[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);  // no FMA: the plain version's rounding
      if (t0 + u < s) hs[base + (size_t)(t0 + u) * w] = h;
    }
  }
  h_final[(size_t)row * w + c] = h;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* hs, void* h_final,
           int batch, int s, int w, cudaStream_t stream) {
  const dim3 grid((w + THREADS - 1) / THREADS, batch);
  kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<float*>(hs), static_cast<float*>(h_final), s, w);
  return cudaGetLastError();
}

}  // namespace lru

// dtype: DTYPE_F32 or DTYPE_BF16 for a and b; h0, hs and h_final are fp32.
extern "C" int lru_scan(const void* a, const void* b, int dtype, const void* h0, void* hs,
                        void* h_final, int batch, int s, int w, void* stream) {
  if (batch <= 0 || batch > 65535 || s <= 0 || w <= 0) return ERR_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return lru::launch<float>(a, b, h0, hs, h_final, batch, s, w, st);
  if (dtype == DTYPE_BF16)
    return lru::launch<__nv_bfloat16>(a, b, h0, hs, h_final, batch, s, w, st);
  return ERR_BAD_ARGS;
}
