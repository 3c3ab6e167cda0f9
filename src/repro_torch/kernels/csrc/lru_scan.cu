// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t over the sequence.
//
// Replaces the Pallas kernel repro/kernels/lru_scan.py::lru_scan (body
// _lru_kernel).  Same contract: a, b (batch, seq, w), read as fp32 (fp32 or
// bf16 in memory); h0 (batch, w) fp32; writes every state h (batch, seq, w)
// and the last one h_final (batch, w), both fp32.  Any width: the kernel
// masks the ragged edge itself, so the caller pads nothing.
//
// Bound on the H100: bytes.  Each (row, channel) reads its a and b once and
// writes its h once, with one multiply and one add per element, far below
// the ~295 operations a byte the card needs to be bound by operations.  At
// the wave shape of recurrentgemma-9b (4, 2304, 4096) that is 302 MB read
// and 151 MB written, 0.135 ms at 3.35 TB/s; a one-request admission
// (1, 2048, 4096) moves 101 MB, 0.030 ms.
//
// Design.  The card is filled by cutting the channels, not the sequence: a
// block owns 32 channels (one 128-byte line of an fp32 row) of one batch
// row, so a call has ceil(w / 32) * batch blocks (512 at the wave shape,
// 128 at a one-request admission).  The block walks the sequence in tiles
// of C steps, staged in shared memory by 16-byte cp.async copies in D
// stages, so the next D - 1 tiles' loads are in flight while one tile is
// scanned: the bytes in flight, not the serial chain, are what a
// byte-bound scan needs.  Each tile is scanned by G warps, lane = channel,
// in three steps:
//   1. warp g scans its segment of L = C / G steps from zero, giving per
//      channel the pair (P_g, H_g) = (prod a, h) of the segment;
//   2. the carry into segment g is the tile's carry passed through
//      segments 0..g-1 in that order, c <- P_j c + H_j (each warp folds
//      its own predecessors, all in the same order);
//   3. warp g rescans its segment from that carry and writes each state,
//      32 lanes to one 128-byte line per step.
// The last segment's final state is the next tile's carry; h_final is the
// state of the last step, from the segment that rescans it.  Every product
// and sum rounds on its own (no FMA), as in the plain version, so inside a
// segment the kernel repeats its arithmetic; only the carries into
// segments 1..G-1 are combined in another order.  The order depends on
// (C, G) alone, never on the batch, the width, the arrival of blocks or the
// card: a row's states are the same bits at any batch and in every call.
// Steps past the sequence's end are identities (a = 1, b = -0: h + -0 is h,
// bit for bit).
//
// Widths whose rows are not whole 16-byte copies (w * sizeof(T) % 16), or
// unaligned base pointers, take the same kernel with plain loads staged
// through registers (VEC false): right at any width, not tuned.
#include "common.cuh"

namespace lru {

constexpr int LANES = 32;  // channels a block owns
// The tile: C steps, scanned by G warps (segments) of C / G steps each,
// staged D deep.  (C, G) fix where the carries combine, and so the bits;
// D does not.  ops.lru_tile_plan() names the same three numbers, and
// tests/test_torch_scan_topk_split.py emulates the order at (C, G).
constexpr int C = 128, G = 8, D = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !fill
// (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
constexpr int smem_bytes() {
  // D stages of (a, b) tiles, then P and H per segment, then two carries
  return D * 2 * C * LANES * (int)sizeof(T) + (2 * G + 2) * LANES * (int)sizeof(float);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(G * 32)
kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
       float* __restrict__ hs, float* __restrict__ h_final, int s, int w) {
  static_assert(C % G == 0 && D >= 2, "a tile is G whole segments, in two stages or more");
  constexpr int L = C / G;
  constexpr int THREADS = G * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [D][a, b][C][LANES]
  float* P = reinterpret_cast<float*>(smem + D * 2 * C * LANES * sizeof(T));  // [G][LANES]
  float* H = P + G * LANES;
  float* carry = H + G * LANES;  // [2][LANES]: read by tile i at i & 1
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int c0 = blockIdx.x * LANES, c = c0 + lane;
  const size_t base = (size_t)blockIdx.y * s * w;
  const int n_tiles = (s + C - 1) / C;

  auto load = [&](int tile) {
    T* ta = tiles + (tile % D) * 2 * C * LANES;
    T* tb = ta + C * LANES;
    const int t0 = tile * C;
    if constexpr (VEC) {
      constexpr int E = 16 / sizeof(T);     // elements a copy
      constexpr int PER_STEP = LANES / E;   // copies a step of one array
      static_assert(C * PER_STEP % THREADS == 0, "whole copies a thread");
#pragma unroll
      for (int r = 0; r < C * PER_STEP / THREADS; ++r) {
        const int i = r * THREADS + threadIdx.x;
        const int t = i / PER_STEP, q = i % PER_STEP * E;
        const bool in = t0 + t < s && c0 + q < w;   // w % E == 0: a copy is wholly in or out
        const size_t off = in ? base + (size_t)(t0 + t) * w + c0 + q : 0;
        cp_async16(ta + t * LANES + q, a + off, in);
        cp_async16(tb + t * LANES + q, b + off, in);
      }
    } else {
#pragma unroll
      for (int r = 0; r < L; ++r) {   // thread (seg, lane): steps seg, seg + G, .. of channel c
        const int t = r * G + seg;
        if (t0 + t < s && c < w) {
          const size_t off = base + (size_t)(t0 + t) * w + c;
          ta[t * LANES + lane] = a[off];
          tb[t * LANES + lane] = b[off];
        }
      }
    }
  };

  if (threadIdx.x < LANES) carry[lane] = c < w ? h0[(size_t)blockIdx.y * w + c] : 0.f;
#pragma unroll
  for (int i = 0; i < D - 1; ++i) {
    if (i < n_tiles) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<D - 2>();
    __syncthreads();  // tile i has landed for every thread; the carry into it is written
    if (i + D - 1 < n_tiles) load(i + D - 1);   // into tile i - 1's stage: every warp has left it
    cp_async_commit();
    const T* ta = tiles + (i % D) * 2 * C * LANES + seg * L * LANES;
    const T* tb = ta + C * LANES;
    const int t0 = i * C + seg * L;

    // 1. the segment from zero: (prod a, h)
    float p = 1.f, h = 0.f;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const bool live = t0 + u < s;
      const float av = live ? to_float(ta[u * LANES + lane]) : 1.f;
      const float bv = live ? to_float(tb[u * LANES + lane]) : -0.f;
      h = __fadd_rn(__fmul_rn(av, h), bv);
      p = __fmul_rn(p, av);
    }
    P[seg * LANES + lane] = p;
    H[seg * LANES + lane] = h;
    __syncthreads();

    // 2. the carry into this segment, through segments 0..seg-1 in order
    h = carry[(i & 1) * LANES + lane];
    for (int j = 0; j < seg; ++j)
      h = __fadd_rn(__fmul_rn(P[j * LANES + lane], h), H[j * LANES + lane]);

    // 3. the segment again from its carry, writing every state
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const bool live = t0 + u < s;
      const float av = live ? to_float(ta[u * LANES + lane]) : 1.f;
      const float bv = live ? to_float(tb[u * LANES + lane]) : -0.f;
      h = __fadd_rn(__fmul_rn(av, h), bv);
      if (live && c < w) hs[base + (size_t)(t0 + u) * w + c] = h;
    }
    if (seg == G - 1) carry[((i + 1) & 1) * LANES + lane] = h;
    if (t0 < s && s <= t0 + L && c < w) h_final[(size_t)blockIdx.y * w + c] = h;
  }
}

template <typename T, bool VEC>
int launch_as(const void* a, const void* b, const void* h0, void* hs, void* h_final, int batch,
              int s, int w, cudaStream_t stream) {
  auto fn = kernel<T, VEC>;
  const int bytes = smem_bytes<T>();
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((w + LANES - 1) / LANES, batch);
  fn<<<grid, G * 32, bytes, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                      static_cast<const float*>(h0), static_cast<float*>(hs),
                                      static_cast<float*>(h_final), s, w);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* hs, void* h_final, int batch,
           int s, int w, cudaStream_t stream) {
  const bool vec = (w * sizeof(T)) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  return vec ? launch_as<T, true>(a, b, h0, hs, h_final, batch, s, w, stream)
             : launch_as<T, false>(a, b, h0, hs, h_final, batch, s, w, stream);
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
