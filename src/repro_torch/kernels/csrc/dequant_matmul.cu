// Fused dequantize-and-matmul over weight-only-quantized weights.
//
// Replaces the Pallas kernel repro/kernels/wquant_matmul.py::dequant_matmul
// (:84; bodies _dq8_kernel and _dq4_kernel, pallas_call at :136).  Same
// contract: x (T, K) bf16 times dequant(q, scale) -> (T, N) in fp32 or
// bf16, summed in fp32, the bf16 weight never written to device memory.
//  * int8: q int8 (K, N) and one bf16 scale per column (N,).  The scale
//    commutes with the K sum, so it is applied once to the fp32 sum.
//  * int4: q uint8 (K/2, N), even k in the low nibble, and one bf16 scale per
//    group-long K segment and column (K/group, N): each group's fp32 sum is
//    multiplied by its scale and added to the total.
//
// Bound on the H100.  At decode widths (T = 4) each weight byte is read once
// and feeds 2T operations, far below the ~295 operations per byte at which
// the tensor cores would become the limit: bound by bytes, the packed
// weights and scales at 3.35 TB/s.  At prefill widths (T = 512) a byte feeds
// 1024 (int8) or 2048 (int4) operations: bound by operations.
//
// Design: the tensor-core GEMM of gemm_sm90.cuh with the weight on the M
// side, its A fragments converted from the raw bytes or nibbles in
// registers (exact in bf16: the scale is applied to fp32 sums, never to a
// weight), fed by cp.async stages, K split across blocks so that every
// call fills the 132 SMs, the splits merged in the same launch.
//  * T <= 64 (decode, verify, a short chunk): byte bound.  8 warps a
//    block over 512 columns, rows of 512 bytes (T <= 16; 4 warps over 128
//    past it), T padded to one n8 tile per 8 rows (8, 16, 32 or 64), 16 KB
//    of weight a stage, as many stages as fit two blocks an SM.
//    A weight costs a byte permute, an add and half a pack (int8) or about
//    two instructions (int4) to convert, where the CUDA-core version it
//    replaces spent ~10 on each.
//  * T > 64 (prefill): operations bound.  wgmma m64n128k16 with A, the
//    converted weight, from registers: two warpgroups of 64 columns by 128
//    tokens, 64 K rows a stage, the x tile in 8 x 16-byte core matrices.
//    int4 groups that are no whole number of stages take the T <= 64
//    instance in tiles of 64 tokens instead.
// The split plan comes from the caller (ops.dequant_split_plan): int4
// splits fall on group boundaries.  Two calls give the same bits.
#include <type_traits>

#include "gemm_sm90.cuh"

namespace {

using gemm::Cfg;
using gemm::Params;
using gemm::W_INT4;
using gemm::W_INT8;

// named dq_*, so that a profiler's kernel names carry "::dq_"
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB) dq_gemm(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];
  gemm::body<C>(p, smem);
}

// T <= 16: 8 warps of 64 columns (512-byte rows of int8 or packed int4 a
// stage), 32 (int8) or 64 (int4) K rows a stage; T <= 64: 4 warps of 32
// columns, 128 K rows; T > 64: wgmma, two warpgroups of 64 columns x 128
// tokens, 64 K rows a stage.
template <int MODE, int NT>
using Narrow = std::conditional_t<NT <= 2,
                                  Cfg<MODE, 8, 4, 1, NT, MODE == W_INT4 ? 64 : 32, NT == 1 ? 2 : 1>,
                                  Cfg<MODE, 4, 2, 1, NT, 128, 2>>;
template <int MODE>
using Wide = Cfg<MODE, 8, 1, 1, 16, 64, 1, true>;

template <class C>
cudaError_t go(Params p, int K, int bits, int blocks, cudaStream_t st) {
  p.stages_a = p.stages = gemm::cdiv(K, C::BK);
  p.unit = 1;  // int4: a split is a whole number of groups and of stages
  if (bits == 4) {
    int a = p.group, b = C::BK;
    while (b) {
      const int t = a % b;
      a = b;
      b = t;
    }
    p.unit = p.group / a;  // lcm(group, BK) / BK
  }
  return gemm::launch<C>(dq_gemm<C>, p, blocks, st);
}

template <int MODE>
cudaError_t run(const Params& p, int K, int bits, int blocks, cudaStream_t st) {
  if (p.T <= 8) return go<Narrow<MODE, 1>>(p, K, bits, blocks, st);
  if (p.T <= 16) return go<Narrow<MODE, 2>>(p, K, bits, blocks, st);
  if (p.T <= 32) return go<Narrow<MODE, 4>>(p, K, bits, blocks, st);
  // wgmma takes int4 groups of whole stages (64 K rows); other groups take
  // the narrow instance's T tiles of 64
  if (p.T <= 64 || (bits == 4 && p.group % Wide<MODE>::BK))
    return go<Narrow<MODE, 8>>(p, K, bits, blocks, st);
  return go<Wide<MODE>>(p, K, bits, blocks, st);
}

}  // namespace

// x (T, K) bf16, q and scale as above, out (T, N) fp32 or bf16; `blocks`
// blocks share the work (ops.dequant_split_plan), and with more than one
// an fp32 workspace of blocks * 2 * BN * BM and zeroed int32 counters,
// one per output tile.  One launch.
extern "C" int dequant_matmul(const void* x, const void* q, const void* scale, void* out,
                              int out_dtype, void* work, void* counters, int blocks, int T,
                              int K, int N, int bits, int group, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || (bits != 8 && bits != 4) ||
      (bits == 4 && (group < 2 || group % 2 || K % group)) ||
      (out_dtype != DTYPE_F32 && out_dtype != DTYPE_BF16))
    return ERR_BAD_ARGS;
  Params p{};
  p.r[0].x = static_cast<const __nv_bfloat16*>(x);
  p.r[0].lx = {1, 1, K};
  p.r[0].w = static_cast<const uint8_t*>(q);
  p.r[0].K = K;
  p.r[0].x_vec = K % 8 == 0 && gemm::aligned16(x);
  p.r[0].w_vec = N % 16 == 0 && gemm::aligned16(q);
  p.scale = static_cast<const __nv_bfloat16*>(scale);
  p.group = bits == 4 ? group : 0;
  p.out = out;
  p.out_f32 = out_dtype == DTYPE_F32;
  p.T = T;
  p.N = N;
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 4 ? run<W_INT4>(p, K, bits, blocks, st) : run<W_INT8>(p, K, bits, blocks, st);
}
