// Single-token GQA attention over the KV cache, returning flash partials.
//
// Replaces the Pallas kernel
// repro/kernels/decode_attention.py::decode_attention_partial (body
// _decode_kernel).  Same contract: q (b, hq, 1, hd), k/v (b, hkv, S, hd),
// a validity mask over the cache of shape (S,) or (b, S); returns the
// UNNORMALIZED fp32 partials m (b, hq, 1), l (b, hq, 1), acc (b, hq, 1, hd)
// so callers can merge them across a sequence-sharded cache.  A row with no
// valid key returns m = -inf, l = 0, acc = 0.  head_dim 64, 128 or 256; a
// sliding-window ring (local_attn) is read through the same mask, which the
// caller builds with the window term, so the contract is unchanged.
//
// Bound on the H100: one read of K and V (2 * b * hkv * S * hd elements)
// against ~4 * hd FLOPs per (query head, key): at g = 8 that is ~8 FLOPs a
// byte, at recurrentgemma's g = 16 ~16, far below the ~295 the card needs
// to be bound by operations, so the kernel is bound by bytes.  What
// matters is spreading the cache read over many memory requests in flight
// on every SM.  One block on each (batch, KV head, group of 8 heads) would
// be 8 blocks on 132 SMs at recurrentgemma-9b's b 4, hkv 1, g 16, each
// walking 16 tiles of its 2048-entry ring in turn.  So the KV axis is split
// across blocks (flash-decoding): the caller's plan (ops.decode_split_plan)
// picks chunk and splits so that the grid holds about one block an SM, and
// the block that finishes last merges the splits in the same launch.
//
// An int8 cache (``ParallelConfig.kv_quant``) is read as it is stored, int8
// values and a bf16 scale per (row, KV head, key): (hd + 2) / (2 hd) of a
// bf16 cache's bytes.  The JAX package dequantizes the whole cache in jnp
// and runs the Pallas kernel on the copy; here the body dequantizes in
// registers, with the copy's bytes, so the result is the bf16 instance's on
// that copy, bit for bit.
//
// The body (decode_attention.cuh) is shared with the paged kernel; its
// design is described there.
#include "decode_attention.cuh"

// k_scale, v_scale: null for a bf16 / fp32 cache; for an int8 cache (k, v
// int8, q bf16) its bf16 scales (b, hkv, S).
// valid_per_row: 0 for a shared (S,) mask, 1 for a per-row (b, S) mask.
// chunk, splits: the split plan (keys per split, a whole number of 32-key
// tiles; splits covering S with none empty); work: the partials workspace
// of work_floats fp32 and counters: n_counters int32 arrival counters, both
// used only when splits > 1 (the counters zero before the launch, and left
// zero after it).
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* valid, int valid_per_row,
                                void* m, void* l, void* acc, void* work, int work_floats,
                                void* counters, int n_counters, int chunk, int splits,
                                int b, int hq, int hkv, int S, int hd, int dtype, float scale,
                                void* stream) {
  decode::Args a{q, k, v, k_scale, v_scale, nullptr, 0, 0, 0, valid, valid_per_row ? S : 0,
                 m, l, acc,
                 static_cast<float*>(work), work_floats, static_cast<int*>(counters),
                 n_counters, chunk, splits, b, hq, hkv, S, scale,
                 static_cast<cudaStream_t>(stream)};
  return decode::dispatch<false>(a, hd, dtype);
}
