// Dual-matmul accumulate epilogue of a parallel-residual layer.
//
// Replaces the Pallas kernel repro/kernels/fused_residual.py::fused_dual_matmul
// (:47; body _fused_kernel, pallas_call at :74).  Same contract: out (T, D)
// = a (T, Ka) @ wa (Ka, D) + b (T, Kb) @ wb (Kb, D), both products summed
// in the same fp32 registers and the tile written once, in a's type (bf16
// or fp32).  In the layer, a @ wa is the attention out-projection partial
// and b @ wb the FFN down-projection partial (paper sections 2.2 and 2.3):
// their sum is the one buffer that a tensor-parallel all-reduce would read.
// Any T, Ka, Kb and D: ragged tiles are zero-filled in the kernel, and rows
// whose 16-byte chunks are not aligned (a 33-wide bf16 row) are read
// element by element, never through a padded copy.
//
// a is read by strides, so the attention heads need no transposed copy
// (paper section 2.3's zero-copy): a is the (T, Ka) matrix of heads
// (n, h, s, hd), row t = (t / s, t % s) and column k = (k / hd, k % hd) at
// ((t / s * h + k / hd) * s + t % s) * hd + k % hd.  A plain (T, Ka) matrix
// is n = T, h = 1, s = 1, hd = Ka.  At decode (s = 1) that is the heads'
// own contiguous (b, h * hd) layout.
//
// Bound on the H100.  Decode (T = 4 at gptj-parallel: (4, 4096) @ (4096,
// 4096) + (4, 16384) @ (16384, 4096)) streams 167.8 MB of bf16 weights for
// 2T operations a weight: bound by bytes, 0.0501 ms at 3.35 TB/s.  Prefill
// (T = 512) is 85.9 GFLOP against the same bytes: bound by operations,
// 0.0869 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design, bf16: the tensor-core GEMM of gemm_sm90.cuh with the weight on
// the M side (A fragments by ldmatrix.trans), one loop over both K ranges
// (a's stages, then b's) into the same accumulators, fed by cp.async
// stages.  Each tile's K is cut into the same FDM_CHUNKS chunks at every T
// (ops.fused_split_plan), one block a chunk, merged in chunk order by the
// block that arrives last: at gptj-parallel's D = 4096, 160 blocks at
// decode widths, and a row's output the same bits whether it is computed
// in a decode step, a verify step, a mixed step or a prefill of any
// width, so that the slot schedulers agree with each other as the wave
// does.
//  * T <= 64 (decode, a verify step's T 20, a 64-token chunk): byte
//    bound.  4 warps over 128 columns, T padded to 8, 16, 32 or 64 rows,
//    16 KB of weight a stage, as many stages as fit two blocks an SM.
//  * T > 64 (prefill): operations bound.  mma.sync, 128 columns x 128
//    tokens a block (4 x 2 warps of 32 x 64), 64 K rows a stage, two blocks
//    an SM.  Not wgmma: the two-warpgroup wgmma tile that dequant_matmul
//    runs, tried here with bf16 operands from shared memory, was slower:
//    its tile loads, not its products, bound it, and it holds one block an
//    SM where this tile holds two (PERF.md, section 6).
// The split plan comes from the caller (ops.fused_split_plan).  Two calls
// give the same bits.
//
// Design, fp32 (the JAX package's kernel sweep, not the model): 64 x 64
// output tiles on the CUDA cores in fp32 FMA, 4 x 4 sums a thread, one
// block a tile, no split, the next K step's loads in flight in registers.
#include <type_traits>

#include "gemm_sm90.cuh"

// named, so that a profiler's kernel names carry "fdm::"
namespace fdm {

using gemm::Cfg;
using gemm::Params;
using gemm::W_BF16;
using gemm::XLayout;

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB) gemm_bf16(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  gemm::body<C>(p, smem);
}

// T <= 64: 4 warps of 32 columns, T padded to 8, 16, 32 or 64 rows; T >
// 64: 4 x 2 warps of 32 columns x 64 tokens, two blocks an SM (mma.sync:
// see the note above).  Every instance takes 64 K rows a stage and the
// caller's fixed chunks, so that a row's sums do not depend on T.
template <int NT>
using Narrow = Cfg<W_BF16, 4, 2, 1, NT, 64, 2>;
using Wide = Cfg<W_BF16, 4, 2, 2, 8, 64, 2>;

template <class C>
cudaError_t go(Params p, int blocks, cudaStream_t st) {
  p.stages_a = gemm::cdiv(p.r[0].K, C::BK);
  p.stages = p.stages_a + gemm::cdiv(p.r[1].K, C::BK);
  p.unit = 1;
  return gemm::launch<C>(gemm_bf16<C>, p, blocks, st);
}

cudaError_t run_bf16(const Params& p, int blocks, cudaStream_t st) {
  if (p.T <= 8) return go<Narrow<1>>(p, blocks, st);
  if (p.T <= 16) return go<Narrow<2>>(p, blocks, st);
  if (p.T <= 32) return go<Narrow<4>>(p, blocks, st);
  if (p.T <= 64) return go<Narrow<8>>(p, blocks, st);
  return go<Wide>(p, blocks, st);
}

// --------------------------------------------------------------------------
// fp32 on the CUDA cores
// --------------------------------------------------------------------------

constexpr int SG_B = 64, SG_BK = 32, SG_THREADS = 256;
constexpr int SG_PER = SG_B * SG_BK / SG_THREADS;  // elements of each tile a thread loads

// 64 x 64 output tiles, 32 K rows a step; each thread loads its elements
// of the next step's a and w tiles into registers while the current step's
// products run, so a step waits for no round trip to device memory.
__global__ void __launch_bounds__(SG_THREADS)
gemm_f32_kernel(const float* __restrict__ a, XLayout la, const float* __restrict__ wa, int Ka,
                const float* __restrict__ b, const float* __restrict__ wb, int Kb,
                float* __restrict__ out, int T_rows, int D) {
  __shared__ float As[SG_BK][SG_B + 4];  // [k][m]
  __shared__ float Ws[SG_BK][SG_B + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SG_B, n0 = blockIdx.x * SG_B;
  const int na = (Ka + SG_BK - 1) / SG_BK, n_chunks = na + (Kb + SG_BK - 1) / SG_BK;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ra[SG_PER], rw[SG_PER];
  // chunk c of a's K, then b's: thread's elements i = tid + e * SG_THREADS
  auto load = [&](int c) {
    const bool second = c >= na;
    const int k0 = (second ? c - na : c) * SG_BK, kn = min(SG_BK, (second ? Kb : Ka) - k0);
    const float* w = second ? wb : wa;
#pragma unroll
    for (int e = 0; e < SG_PER; ++e) {
      const int i = tid + e * SG_THREADS;
      const int m = i / SG_BK, kk = i % SG_BK, t = m0 + m, k = k0 + kk;
      ra[e] = t < T_rows && kk < kn
                  ? (second ? b[(size_t)t * Kb + k] : a[gemm::x_row(la, t) + gemm::x_col(la, k)])
                  : 0.f;
      const int kw = i / SG_B, n = i % SG_B;
      rw[e] = kw < kn && n0 + n < D ? w[(size_t)(k0 + kw) * D + n0 + n] : 0.f;
    }
  };
  load(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int e = 0; e < SG_PER; ++e) {
      const int i = tid + e * SG_THREADS;
      As[i % SG_BK][i / SG_BK] = ra[e];
      Ws[i / SG_B][i % SG_B] = rw[e];
    }
    __syncthreads();
    if (c + 1 < n_chunks) load(c + 1);
#pragma unroll
    for (int kk = 0; kk < SG_BK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(As[kk][ty + 16 * i], Ws[kk][tx + 16 * j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < T_rows && col < D) out[(size_t)row * D + col] = acc[i][j];
    }
}

}  // namespace fdm

// a: the heads (n, h, s, hd) read as the (n * s, h * hd) matrix (a plain
// (T, Ka) matrix: s = 1, h = 1, hd = Ka); wa (Ka, D), b (T, Kb), wb (Kb, D),
// out (T, D), all of one dtype.  bf16: `blocks` blocks share the work
// (ops.fused_split_plan; chunk > 0: each tile split at every chunk stages),
// and with more than one an fp32 workspace of blocks * 2 * BN * BM and
// zeroed int32 counters, one per output tile; fp32 takes one block a 64 x
// 64 tile (blocks 1).  One launch.
extern "C" int fused_dual_matmul(const void* a, int a_s, int a_h, int a_hd, const void* wa,
                                 const void* b, const void* wb, void* out, int T_rows,
                                 int Kb, int D, int dtype, void* work, void* counters,
                                 int blocks, int chunk, void* stream) {
  if (T_rows <= 0 || Kb <= 0 || D <= 0 || a_s <= 0 || a_h <= 0 || a_hd <= 0 ||
      T_rows % a_s || (long)a_h * a_hd > 0x7fffffff || (long)T_rows > 65535L * fdm::SG_B ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return ERR_BAD_ARGS;
  const gemm::XLayout la{a_s, a_h, a_hd};
  const int Ka = a_h * a_hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    if (blocks != 1) return ERR_BAD_ARGS;
    fdm::gemm_f32_kernel<<<dim3(gemm::cdiv(D, fdm::SG_B), gemm::cdiv(T_rows, fdm::SG_B)),
                           fdm::SG_THREADS, 0, st>>>(
        static_cast<const float*>(a), la, static_cast<const float*>(wa), Ka,
        static_cast<const float*>(b), static_cast<const float*>(wb), Kb,
        static_cast<float*>(out), T_rows, D);
    return cudaGetLastError();
  }
  using bf = __nv_bfloat16;
  gemm::Params p{};
  const bool rows_vec = D % 8 == 0;
  p.r[0] = {static_cast<const bf*>(a), la, static_cast<const uint8_t*>(wa), Ka,
            a_hd % 8 == 0 && gemm::aligned16(a), rows_vec && gemm::aligned16(wa)};
  p.r[1] = {static_cast<const bf*>(b), gemm::XLayout{1, 1, Kb}, static_cast<const uint8_t*>(wb), Kb,
            Kb % 8 == 0 && gemm::aligned16(b), rows_vec && gemm::aligned16(wb)};
  p.chunk = chunk;
  p.out = out;
  p.T = T_rows;
  p.N = D;
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  return fdm::run_bf16(p, blocks, st);
}
