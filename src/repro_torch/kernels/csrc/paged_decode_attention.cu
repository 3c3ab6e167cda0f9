// Single-token GQA attention over a paged KV cache, returning flash partials.
//
// Replaces the Pallas kernel
// repro/kernels/decode_attention.py::paged_decode_attention_partial (body
// _paged_decode_kernel).  Same contract: q (b, hq, 1, hd); K/V block pools
// (nb, hkv, bs, hd); a block table bt (b, nbps) int32 mapping each slot's
// view block to a pool block; a per-slot mask valid (b, nbps * bs) over the
// view (view index == absolute position).  Returns the UNNORMALIZED fp32
// partials m (b, hq, 1), l (b, hq, 1), acc (b, hq, 1, hd); a row with no
// valid key gives m = -inf, l = 0, acc = 0.  Table entries outside [0, nb)
// read the null block 0 (they are never valid).  head_dim 64, 128 or 256
// (at 256 the body halves its warps, as the dense kernel does).
//
// Bound on the H100: bytes.  The work is one read of the valid blocks' K
// and V against ~4 * hd FLOPs per (query head, key), ~8 FLOPs a byte at
// g = 8; tiles with no valid key are skipped before their loads, so a slot
// costs the bytes of the blocks it holds, not of its whole view.
//
// The body (decode_attention.cuh, PAGED = true) is shared with the dense
// kernel: the same tiles, staging and online softmax, with each row's
// address read through the table, and the same split of the view across
// blocks with the merge in the launch (b * hkv blocks alone, 16 at b = 4
// on yi-9b, would leave most of the 132 SMs idle).  A split whose tiles
// are all dead writes an empty partial without loading K or V.
#include "decode_attention.cuh"

// k_scale, v_scale: null for bf16 / fp32 pools; for int8 pools (q bf16) the
// bf16 scale pools (nb, hkv, bs).  chunk, splits, work, counters: as
// decode_attention (decode_attention.cu), over the view of nbps * bs keys.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* k_scale,
                                      const void* v_scale, const void* bt,
                                      const void* valid, void* m, void* l,
                                      void* acc, void* work, int work_floats, void* counters,
                                      int n_counters, int chunk, int splits, int b, int hq,
                                      int hkv, int nb, int bs, int nbps, int hd, int dtype,
                                      float scale, void* stream) {
  if (nb <= 0 || bs <= 0 || nbps <= 0) return ERR_BAD_ARGS;
  const int S = nbps * bs;
  decode::Args a{q, k_pool, v_pool, k_scale, v_scale, static_cast<const int*>(bt), nb, bs,
                 nbps, valid, S, m, l,
                 acc, static_cast<float*>(work), work_floats, static_cast<int*>(counters),
                 n_counters, chunk, splits, b, hq, hkv, S, scale,
                 static_cast<cudaStream_t>(stream)};
  return decode::dispatch<true>(a, hd, dtype);
}
