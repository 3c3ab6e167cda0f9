// Row-wise top-k with ties to the lowest index, in one launch.
//
// Replaces the Pallas kernel repro/kernels/topk_shard.py::topk (body
// _topk_kernel).  Same contract: x (rows, n) -> the k largest values of each
// row, largest first, as fp32 values and int32 indices; among equal values
// the lowest index comes first (greedy sampling is idx[:, 0], so the tie
// order decides tokens).  NaN ranks above +inf, as the Pallas kernel's
// argmax and the plain version's sort rank it, NaNs among themselves by
// index: a row of NaN gives 0..k-1.  -0 and +0 are equal values.
//
// Bound on the H100: one read of the logits (rows * n * 4 bytes for fp32)
// and about one comparison per element, so the kernel is bound by bytes.
//
// Design.  Each element has a 64-bit key, larger = better: the value's
// order-preserving 32-bit key (NaN above everything, -0 = +0) above the
// complement of its index.  Keys are unique, so "the k best" is a set
// whatever order the elements are visited in, and the kernel's result does
// not depend on how the row is cut.  The row is cut into chunks
// (ops.topk_chunk_plan: rows * chunks >= the SMs, at most MAX_CHUNK
// elements a chunk), one block a chunk, each reading its chunk once into
// registers (every load in flight before the first is used):
//   * k = 1: the largest key, by one block-wide max;
//   * k > 1: a radix select narrows the keys 8 bits at a time (a histogram
//     of the digit among the keys that share the bits above it, a warp's
//     keys counted at once where they share one digit) until the keys at
//     or above the k-th largest key's prefix are at most max(k, RANK_MIN)
//     (ranking costs the square of their count); those go to shared
//     memory, where each key's rank is the number of keys above it, and
//     the k of rank < k are the chunk's k best, in order.
// A chunk's k best go to the workspace; the block makes them visible and
// adds one to its row's arrival counter, and the row's last block to
// arrive selects the k best of the row's candidates the same way (held in
// registers where they fit, MAX_MERGE, else read through L2 at each
// digit), writes values re-read from x (the input's own bits: NaN
// payloads, -0) and indices, and sets the counter back to 0.  A row of one
// chunk writes its result directly.  Empty slots (a chunk shorter than k)
// have the key 0, which loses to every element, -inf and NaN included.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 256;
constexpr int EPT = 16;                     // keys a thread holds
constexpr int MAX_CHUNK = EPT * THREADS;    // elements a block takes
constexpr int MAX_MERGE = EPT * THREADS;    // candidates the merge holds in registers
constexpr int RANK_MIN = 128;               // keys ranked without narrowing them first
constexpr int BINS = 256;                   // 8-bit digits

typedef unsigned long long u64;

__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0xFFFFFFFFu;
  const uint32_t u = v == 0.f ? 0u : __float_as_uint(v);   // -0 ties +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 full_key(uint32_t key, int i) {
  return (u64)key << 32 | (uint32_t)~(uint32_t)i;
}

__device__ __forceinline__ int index_of(u64 key) { return (int)~(uint32_t)key; }

struct Smem {
  int hist[BINS];
  u64 sel[MAX_K];   // the keys ranked: at most max(k, RANK_MIN) <= MAX_K
  u64 red[WARPS];
  u64 prefix;
  int k_rem, stop, count, last;
};

__device__ __forceinline__ u64 block_max(u64 v, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  if (lane == 0) sm.red[warp] = v;
  __syncthreads();
  v = sm.red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = sm.red[w] > v ? sm.red[w] : v;
  return v;
}

// Narrows the m keys to the at most max(k, RANK_MIN) that hold the k
// largest, into sm.sel[0..sm.count).  Key i = (r * E + e) * THREADS + tid
// is key_at(i, e) (E unrolled, so a key source in registers stays there).
template <int E, class KeyAt>
__device__ __forceinline__ void select_k(const KeyAt& key_at, int m, int k, Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int rounds = (m + E * THREADS - 1) / (E * THREADS);
  u64 prefix = 0;
  int sh = 64;
  if (tid == 0) sm.count = 0;
  for (int i = tid; i < BINS; i += THREADS) sm.hist[i] = 0;
  __syncthreads();
  const int cap = max(k, RANK_MIN);
  if (m > cap) {
    int k_rem = k;
    while (true) {
      sh -= 8;
      for (int r = 0; r < rounds; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((r * E + e) * THREADS >= m) break;   // the same for every thread
          const int i = (r * E + e) * THREADS + tid;
          int d = BINS;   // no bin: past the end or outside the prefix
          if (i < m) {
            const u64 kk = key_at(i, e);
            if (sh == 56 || (kk >> (sh + 8)) == (prefix >> (sh + 8))) d = (int)(kk >> sh & 0xFF);
          }
          // a warp whose counted keys share one digit adds them once (the
          // first digit of most rows); else each key on its own (past the
          // first digit few keys share the prefix, and they spread)
          const unsigned act = __ballot_sync(0xffffffffu, d != BINS);
          if (act) {
            const int first = __ffs(act) - 1;
            const int d0 = __shfl_sync(0xffffffffu, d, first);
            if (__all_sync(0xffffffffu, d == d0 || d == BINS)) {
              if (lane == first) atomicAdd(&sm.hist[d0], __popc(act));
            } else if (d != BINS) {
              atomicAdd(&sm.hist[d], 1);
            }
          }
        }
      }
      __syncthreads();
      if (tid < 32) {   // lane l owns bins 8l..8l+7; find the bin of the k_rem-th largest
        int own = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) own += sm.hist[8 * lane + q];
        int incl = own;   // the bins of lanes >= l
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_down_sync(0xffffffffu, incl, o);
          if (lane + o < 32) incl += t;
        }
        const int above = incl - own;
        if (above < k_rem && k_rem <= incl) {
          int acc = above, d = 8 * lane + 7;
          while (acc + sm.hist[d] < k_rem) acc += sm.hist[d--];
          sm.prefix = prefix | (u64)d << sh;
          sm.k_rem = k_rem - acc;
          // the keys kept: k - k_rem above this digit's bin, and the bin
          sm.stop = k - (k_rem - acc) + sm.hist[d] <= cap;
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 8; ++q) sm.hist[8 * lane + q] = 0;   // for the next digit
      }
      __syncthreads();
      prefix = sm.prefix;
      k_rem = sm.k_rem;
      if (sm.stop || sh == 0) break;   // at sh == 0 the keys kept are k
    }
  }
  // the keys whose top 64 - sh bits are at or above the prefix's
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((r * E + e) * THREADS >= m) break;
      const int i = (r * E + e) * THREADS + tid;
      if (i < m) {
        const u64 kk = key_at(i, e);
        if (sh == 64 || (kk >> sh) >= (prefix >> sh)) sm.sel[atomicAdd(&sm.count, 1)] = kk;
      }
    }
  }
  __syncthreads();
}

// emit(r, key) for the keys of sm.sel of rank r < k, rank = the number of
// keys above (keys are unique but for empty slots, which rank below k)
template <class Emit>
__device__ __forceinline__ void emit_ranked(int k, Smem& sm, const Emit& emit) {
  const int ns = sm.count;
  for (int i = threadIdx.x; i < ns; i += THREADS) {
    const u64 me = sm.sel[i];
    int r = 0;
#pragma unroll 8
    for (int j = 0; j < ns; ++j) r += sm.sel[j] > me;
    if (r < k) emit(r, me);
  }
}

// grid (n_chunks, rows); work: rows * n_chunks * k keys, counters: rows
// (both unused when n_chunks == 1)
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_kernel(const T* __restrict__ x, int n, int k, int chunk, float* __restrict__ vals,
            int* __restrict__ idx, u64* __restrict__ work, int* __restrict__ counters) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, row = blockIdx.y, n_chunks = gridDim.x;
  const int lo = blockIdx.x * chunk, m = min(n, lo + chunk) - lo;
  const T* xr = x + (size_t)row * n;
  float* vr = vals + (size_t)row * k;
  int* ir = idx + (size_t)row * k;
  auto put = [&](int r, u64 key) {   // one of the row's results, its value re-read from x
    vr[r] = to_float(xr[index_of(key)]);
    ir[r] = index_of(key);
  };

  // the chunk's values, every load issued before the first is used
  float v[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = e * THREADS + tid;
    v[e] = i < m ? to_float(xr[lo + i]) : 0.f;
  }
  u64* out = work + ((size_t)row * n_chunks + blockIdx.x) * k;
  if (k == 1) {
    u64 best = 0;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int i = e * THREADS + tid;
      const u64 kk = i < m ? full_key(order_key(v[e]), lo + i) : 0ull;
      best = kk > best ? kk : best;
    }
    best = block_max(best, sm);
    if (n_chunks == 1) {
      if (tid == 0) put(0, best);
      return;
    }
    if (tid == 0) {   // the one writer makes its key visible, then arrives
      out[0] = best;
      __threadfence();
      sm.last = atomicAdd(counters + row, 1) == n_chunks - 1;
    }
    __syncthreads();
    if (!sm.last || tid >= 32) return;
    __threadfence();
    // one warp merges: the largest of the row's n_chunks keys
    const u64* cand = work + (size_t)row * n_chunks;   // written by other blocks: read via L2
    best = 0;
    for (int i = tid; i < n_chunks; i += 32) {
      const u64 kk = __ldcg(cand + i);
      best = kk > best ? kk : best;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const u64 u = __shfl_xor_sync(0xffffffffu, best, o);
      best = u > best ? u : best;
    }
    if (tid == 0) {
      put(0, best);
      counters[row] = 0;
    }
    return;
  }

  select_k<EPT>([&](int i, int e) { return full_key(order_key(v[e]), lo + i); }, m, k, sm);
  if (n_chunks == 1) {
    emit_ranked(k, sm, put);
    return;
  }
  emit_ranked(k, sm, [&](int r, u64 key) { out[r] = key; });
  for (int j = m + tid; j < k; j += THREADS) out[j] = 0;   // a chunk shorter than k

  // arrival: the row's last block merges its candidates
  __threadfence();   // this block's candidates are visible before its arrival
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(counters + row, 1) == n_chunks - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const u64* cand = work + (size_t)row * n_chunks * k;   // written by other blocks: read via L2
  const int mc = n_chunks * k;
  if (mc <= MAX_MERGE) {   // in registers, every load in flight at once
    u64 c[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      c[e] = e * THREADS + tid < mc ? __ldcg(cand + e * THREADS + tid) : 0ull;
    select_k<EPT>([&](int, int e) { return c[e]; }, mc, k, sm);
    emit_ranked(k, sm, put);
  } else {
    select_k<4>([&](int i, int) { return __ldcg(cand + i); }, mc, k, sm);
    emit_ranked(k, sm, put);
  }
  if (tid == 0) counters[row] = 0;
}

}  // namespace

// chunk: elements a block takes (ops.topk_chunk_plan); work: rows *
// ceil(n / chunk) * k 64-bit keys and counters: rows int32 arrival counters
// at zero, both needed only when a row has more than one chunk.
extern "C" int topk(const void* x, int dtype, int rows, int n, int k, int chunk, void* vals,
                    void* idx, void* work, void* counters, void* stream) {
  const int n_chunks = chunk > 0 ? (n + chunk - 1) / chunk : 0;
  if (rows <= 0 || rows > 65535 || k <= 0 || k > n || k > MAX_K || chunk <= 0 ||
      chunk > MAX_CHUNK || (n_chunks > 1 && (work == nullptr || counters == nullptr)) ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return ERR_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_chunks, rows);
  if (dtype == DTYPE_BF16)
    topk_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, k, chunk, static_cast<float*>(vals),
        static_cast<int*>(idx), static_cast<u64*>(work), static_cast<int*>(counters));
  else
    topk_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), n, k, chunk, static_cast<float*>(vals),
        static_cast<int*>(idx), static_cast<u64*>(work), static_cast<int*>(counters));
  return cudaGetLastError();
}
