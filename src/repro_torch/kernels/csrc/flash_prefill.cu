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
// The body (flash_prefill.cuh) is shared with the paged kernel; its design
// is described there.
#include "flash_prefill.cuh"

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* q_pos, void* out, int b, int hq,
                             int hkv, int sq, int sk, int hd, int dtype,
                             float scale, void* stream) {
  return prefill::dispatch<false>(q, k, v, nullptr, 0, 0, 0, q_pos, out, b, hq, hkv, sq, sk,
                                  hd, dtype, scale, stream);
}
