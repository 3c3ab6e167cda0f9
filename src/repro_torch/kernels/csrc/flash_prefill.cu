// Causal GQA flash attention for prompt prefill.
//
// Replaces the Pallas kernel repro/kernels/prefill_attention.py::flash_prefill
// (body _prefill_kernel / _flash_update).  Same contract: q (b, hq, Sq, hd),
// k/v (b, hkv, Sk, hd), q_pos (b, Sq) int32; query row i attends key j iff
// j <= q_pos[b, i] (and j < Sk) and, with window > 0, j > q_pos[b, i] -
// window (the sliding window of local_attn layers, which the JAX package
// computes in jnp: repro/models/attention.py::_prefill_attention); rows
// with q_pos = -1 emit exact zeros;
// fp32 running (m, l, acc) on bf16 or fp32 inputs; normalized output in the
// input type.
//
// head_dim 64, 128 or 256.
//
// Bound on the H100: at prompt lengths of a few hundred tokens the work is
// ~4*hd FLOPs per (query, key) pair against one read of q/k/v, so the card
// is bound by operations (recurrentgemma-9b's 4 x 2304-token windowed
// prefill: 171.8 GFLOP, 0.174 ms at the bf16 tensor-core peak), and fp32
// FMA on the CUDA cores peaks at 67 TFLOP/s, 15x short of the tensor cores'
// 989.  So the bf16 instances run both products on the tensor cores
// (mma.sync m16n8k16, bf16 operands staged by two-stage cp.async copies,
// fp32 accumulators; the body in flash_prefill.cuh); the fp32 instances
// keep the CUDA-core body, whose products stay in fp32.  At head_dim 256 a
// bf16 block stages 187,904 bytes of shared memory, and two warps share
// each 16 query rows, each holding half of their 16 x 256 fp32 outputs.
//
// K/V are a stripe of n_cache rows: batch row b reads row rows[b] (or row b
// when rows is null), so a chunk of admitted slots attends their stripes in
// the shared slot cache; Sk is the stripe's length.
//
// The body (flash_prefill.cuh) is shared with the paged and the verify
// kernels; its design is described there.
#include "flash_prefill.cuh"

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* rows, int n_cache, const void* q_pos,
                             void* out, int b, int hq, int hkv, int sq, int sk,
                             int hd, int dtype, float scale, int window, void* stream) {
  prefill::Args a{q, k, v, nullptr, 0, 0, 0, static_cast<const int*>(rows), n_cache,
                  q_pos, out, nullptr, 0, b, hq, hkv, sq, sk, scale, window,
                  static_cast<cudaStream_t>(stream)};
  return prefill::dispatch<false, false>(a, hd, dtype);
}
