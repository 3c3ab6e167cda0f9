// Causal GQA attention of a narrow query chunk over dense slot stripes:
// the speculative-decode verify step.
//
// Replaces the Pallas kernel repro/kernels/prefill_attention.py::flash_verify
// (:179, reaching its pallas_call at :152 through flash_prefill).  Same
// contract: q (b, hq, Sq, hd) with Sq = spec_k + 1 <= 8; K/V a stripe of
// n_cache rows (n_cache, hkv, Sk, hd) of which batch row b reads row
// rows[b] (rows null: row b); q_pos (b, Sq) int32; query row i attends
// view index j iff j <= q_pos[b, i] (and j < Sk); rows with q_pos = -1
// emit exact zeros; fp32 running (m, l, acc) on bf16 or fp32 inputs;
// normalized output in q's type.  head_dim 64, 128 or 256 (gptj-parallel:
// 16 MHA heads of 256, g 1).
//
// Bound on the H100: bytes.  A verify step reads each row's K/V stripe up
// to its frontier once (2 * hkv * frontier * hd elements per row) for
// ~4 * hd FLOPs per (query row, head, key): at Sq * g = 40 rows per KV head
// that is ~40 FLOPs a byte, below the ~295 the card needs to be bound by
// operations.
//
// Design.  On the TPU this is flash_prefill's body with one q tile rounded
// up to 8 rows and 512-wide KV blocks.  Carried over as it is, the b * hkv
// blocks (16 at yi-9b's 4 slots) would each walk a whole stripe and leave
// most of the 132 SMs idle, the fault of a first decode kernel.  So the
// KV axis is split: the shared body (flash_prefill.cuh, SPLIT = true) runs
// as b * hkv * splits blocks, each over one chunk of whole 64-key tiles for
// all Sq * g rows of its (slot, KV head) -- at yi-9b 40 rows in one 64-row
// tile -- and writes unnormalized fp32 partials; a chunk past the tile's
// largest q_pos exits before any load.  A second launch (merge_partials)
// combines the splits by log-sum-exp and normalizes.  bf16 products on the
// tensor cores, fp32 on the CUDA cores, as the prefill body.
#include "flash_prefill.cuh"

// fp32 floats of the partials workspace a launch at these shapes needs.
extern "C" int flash_verify_workspace(int b, int hq, int hkv, int sq, int sk, int hd) {
  if (b <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk <= 0) return ERR_BAD_ARGS;
  int splits = 1;
  prefill::split_chunk(b, hq, hkv, sq, sk, &splits);
  return prefill::partials_floats(splits, b, hq, sq, hd);
}

extern "C" int flash_verify(const void* q, const void* k, const void* v,
                            const void* rows, int n_cache, const void* q_pos,
                            void* out, void* work, int work_floats, int b,
                            int hq, int hkv, int sq, int sk, int hd, int dtype,
                            float scale, void* stream) {
  prefill::Args a{q, k, v, nullptr, 0, 0, 0, static_cast<const int*>(rows), n_cache,
                  q_pos, out, static_cast<float*>(work), work_floats, b, hq, hkv, sq, sk,
                  scale, 0, static_cast<cudaStream_t>(stream)};
  return prefill::dispatch<false, true>(a, hd, dtype);
}
