// Quantize a layer's fresh K and V to int8 and write them, with their bf16
// scales, into the int8 KV cache: one launch for both sides.
//
// Replaces no Pallas kernel.  The JAX package quantizes with jnp
// (``_quantize_kv``, attention.py) and scatters values and scales with
// four ``.at[].set`` writes; a port of that in plain PyTorch costs about
// eight launches a side a layer, on a decode step that the host's launch
// rate already bounds.  So this kernel does the quantizer and the writes in
// one launch.  Its arithmetic is the JAX package's as it runs (jitted, XLA
// folds the division by 127 into a product with the fp32 constant 1/127):
//
//   amax = max |x| over hd (fp32);  scale = max(amax, 1e-6) * (1/127)
//   q = clamp(rint(x / scale), -127, 127)   (IEEE division, half to even)
//   stored scale = bf16(scale)
//
// and, where the caller asks for it, the dequantized fresh values
// bf16(fp32(q) * fp32(bf16(scale))) that a prefill attends (the JAX
// package's ``_dequantize_kv`` of the fresh K/V).
//
// Layout.  k, v (b, h, s, hd) bf16 by strides (a layer's K and V come out of
// RoPE and a view as transposes; no copy is made for them); the caches (n,
// h, m, hd) int8 and scales (n, h, m) bf16, contiguous.  Token t = bi * s +
// j (row-major over (row, position)) goes to cache row dst_row[t], index
// dst_idx[t]; dst_row[t] < 0 drops it.  That one form serves every layout
// of the port: the wave cache's slice at wave_pos, a ring's indices, a
// slot cache's (slot, view index) pairs and a pool's (block, offset) pairs.
// Two tokens may name one destination only in the null block, which is
// never read as valid.
//
// Bound on the H100: bytes.  A (token, head, side) row reads hd bf16 and
// writes hd int8 and one bf16 scale (plus hd bf16 dequantized), against ~5
// operations a value.  One warp takes one row: hd / 32 values a lane in one
// load, a warp max, one store a lane.
#include "common.cuh"

namespace kvq {

constexpr int WARPS = 8;  // rows (token, head, side) per block

template <int N>
struct Bits;  // N bf16 values in one load: N * 2 bytes
template <>
struct Bits<2> { using T = unsigned int; using Q = unsigned short; };
template <>
struct Bits<4> { using T = uint2; using Q = unsigned int; };
template <>
struct Bits<8> { using T = uint4; using Q = uint2; };

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
       long long sb_k, long long sh_k, long long ss_k, long long sb_v, long long sh_v,
       long long ss_v, int8_t* __restrict__ kc, int8_t* __restrict__ vc,
       __nv_bfloat16* __restrict__ ks, __nv_bfloat16* __restrict__ vs,
       const int* __restrict__ dst_row, const int* __restrict__ dst_idx,
       __nv_bfloat16* __restrict__ kd, __nv_bfloat16* __restrict__ vd, long long rows, int h,
       int s, int m) {
  constexpr int EPL = HD / 32;  // values a lane
  using V = typename Bits<EPL>::T;
  using Q = typename Bits<EPL>::Q;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);  // (side, token, head)
  if (r >= 2 * rows) return;
  const bool is_v = r >= rows;
  const long long rr = is_v ? r - rows : r;
  const int hh = (int)(rr % h);
  const long long tok = rr / h;
  const int bi = (int)(tok / s), j = (int)(tok % s);
  const __nv_bfloat16* src = is_v ? v + bi * sb_v + hh * sh_v + j * ss_v
                                  : k + bi * sb_k + hh * sh_k + j * ss_k;
  __align__(16) __nv_bfloat16 x[EPL];
  *reinterpret_cast<V*>(x) = *reinterpret_cast<const V*>(src + lane * EPL);
  float f[EPL], amax = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    f[i] = __bfloat162float(x[i]);
    amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = warp_max(amax);
  const float scale = fmaxf(amax, 1e-6f) * (1.0f / 127.0f);
  const __nv_bfloat16 sb = __float2bfloat16_rn(scale);
  const float sf = __bfloat162float(sb);
  __align__(8) int8_t q[EPL];
  __align__(16) __nv_bfloat16 d[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const float y = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
    q[i] = (int8_t)y;
    d[i] = __float2bfloat16_rn((float)q[i] * sf);  // from the int8 value: -0 stores as +0
  }
  const int row = dst_row[tok];
  if (row >= 0) {
    const size_t at = ((size_t)row * h + hh) * m + dst_idx[tok];
    *reinterpret_cast<Q*>((is_v ? vc : kc) + at * HD + lane * EPL) = *reinterpret_cast<const Q*>(q);
    if (lane == 0) (is_v ? vs : ks)[at] = sb;
  }
  __nv_bfloat16* deq = is_v ? vd : kd;
  if (deq != nullptr)
    *reinterpret_cast<V*>(deq + (((size_t)bi * h + hh) * s + j) * HD +
                          lane * EPL) = *reinterpret_cast<const V*>(d);
}

template <int HD>
int launch(const void* k, const void* v, const long long* st, void* kc, void* vc, void* ks,
           void* vs, const int* dst_row, const int* dst_idx, void* kd, void* vd, int b, int h,
           int s, int m, cudaStream_t stream) {
  const long long rows = (long long)b * s * h;
  const long long blocks = (2 * rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return ERR_BAD_ARGS;
  kernel<HD><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), st[0], st[1],
      st[2], st[3], st[4], st[5], static_cast<int8_t*>(kc), static_cast<int8_t*>(vc),
      static_cast<__nv_bfloat16*>(ks), static_cast<__nv_bfloat16*>(vs), dst_row, dst_idx,
      static_cast<__nv_bfloat16*>(kd), static_cast<__nv_bfloat16*>(vd), rows, h, s, m);
  return cudaGetLastError();
}

}  // namespace kvq

// k, v: bf16 (b, h, s, hd) with element strides (sb, sh, ss) each, the last
// dim contiguous, 16-byte aligned rows.  k_cache, v_cache: int8 (n, h, m,
// hd); k_scale, v_scale: bf16 (n, h, m).  dst_row, dst_idx: int32 (b * s,).
// k_deq, v_deq: null, or bf16 (b, h, s, hd) contiguous for the dequantized
// fresh values.  head_dim 64, 128 or 256.
extern "C" int kv_quant_write(const void* k, const void* v, long long sb_k, long long sh_k,
                              long long ss_k, long long sb_v, long long sh_v, long long ss_v,
                              void* k_cache, void* v_cache, void* k_scale, void* v_scale,
                              const void* dst_row, const void* dst_idx, void* k_deq, void* v_deq,
                              int b, int h, int s, int hd, int n, int m, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || n <= 0 || m <= 0 || (k_deq == nullptr) != (v_deq == nullptr))
    return ERR_BAD_ARGS;
  const long long st[6] = {sb_k, sh_k, ss_k, sb_v, sh_v, ss_v};
  const int* rows = static_cast<const int*>(dst_row);
  const int* idx = static_cast<const int*>(dst_idx);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return kvq::launch<64>(k, v, st, k_cache, v_cache, k_scale, v_scale, rows, idx, k_deq, v_deq,
                           b, h, s, m, cs);
  if (hd == 128)
    return kvq::launch<128>(k, v, st, k_cache, v_cache, k_scale, v_scale, rows, idx, k_deq,
                            v_deq, b, h, s, m, cs);
  if (hd == 256)
    return kvq::launch<256>(k, v, st, k_cache, v_cache, k_scale, v_scale, rows, idx, k_deq,
                            v_deq, b, h, s, m, cs);
  return ERR_BAD_ARGS;
}
