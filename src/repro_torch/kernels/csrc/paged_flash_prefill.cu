// Causal GQA flash attention over a paged KV cache, for admission with a
// cached prefix.
//
// Replaces the Pallas kernel
// repro/kernels/prefill_attention.py::paged_flash_prefill (its pallas_call
// at :267 over _prefill_kernel / _flash_update).  Same contract: q
// (b, hq, Sq, hd); K/V block pools (nb, hkv, bs, hd); a block table bt
// (b, nbps) int32 mapping each slot's view block to a pool block; q_pos
// (b, Sq) int32, the view position of each query.  Query row i attends view
// index j iff j <= q_pos[b, i] (and j < nbps * bs, the KV limit); rows
// with q_pos = -1 emit exact zeros; fp32 running (m, l, acc); normalized
// output in q's type.  Table entries outside [0, nb) read the null block 0.
// head_dim 64, 128 or 256.
//
// Bound on the H100: a suffix of Sq tokens after a prefix of P attends
// ~Sq * (P + Sq / 2) (query, key) pairs at ~4 * hd FLOPs each, against one
// read of the view's K/V per q tile; at Sq = 64 after P = 64..128 the card
// is bound by operations at the bf16 tensor-core peak.  Narrow suffixes
// (Sq = 1 when a prefix covers all but one token) fill one 64-row tile
// with Sq * g rows.
//
// The body (flash_prefill.cuh, PAGED = true) is shared with the dense
// kernel: bf16 on the tensor cores, fp32 on the CUDA cores; KV tiles (64
// keys in bf16, 32 in fp32) are gathered through the table, and tiles past
// a q tile's largest q_pos are skipped.
#include "flash_prefill.cuh"

extern "C" int paged_flash_prefill(const void* q, const void* k_pool,
                                   const void* v_pool, const void* bt,
                                   const void* q_pos, void* out, int b, int hq,
                                   int hkv, int sq, int nb, int bs, int nbps,
                                   int hd, int dtype, float scale,
                                   void* stream) {
  if (nb <= 0 || bs <= 0 || nbps <= 0) return ERR_BAD_ARGS;
  prefill::Args a{q, k_pool, v_pool, static_cast<const int*>(bt), nb, bs, nbps, nullptr, 0,
                  q_pos, out, nullptr, 0, b, hq, hkv, sq, nbps * bs, scale, 0,
                  static_cast<cudaStream_t>(stream)};
  return prefill::dispatch<true, false>(a, hd, dtype);
}
