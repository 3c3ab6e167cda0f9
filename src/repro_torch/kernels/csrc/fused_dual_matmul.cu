// Dual-matmul accumulate epilogue of a parallel-residual layer.
//
// Replaces the Pallas kernel repro/kernels/fused_residual.py::fused_dual_matmul
// (body _fused_kernel, pallas_call at :74).  Same contract: out (T, D) =
// a (T, Ka) @ wa (Ka, D) + b (T, Kb) @ wb (Kb, D), both products summed in
// the same fp32 registers and the tile written once, in a's type (bf16 or
// fp32).  In the layer, a @ wa is the attention out-projection partial and
// b @ wb the FFN down-projection partial (paper sections 2.2 and 2.3): their
// sum is the one buffer that a tensor-parallel all-reduce would read.  Any
// T, Ka, Kb and D: ragged tiles are masked in the kernel, and rows whose
// 16-byte chunks are not aligned (a 33-wide bf16 row) are read element by
// element, never through a padded copy.
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
// Design.  Pallas walks K along a sequential grid axis and carries the
// sum in VMEM scratch; here one block owns one output tile and loops over
// both K ranges itself, a's then b's, into the same accumulators.  No
// split of K across blocks, so one launch and no workspace, and two calls
// give the same bits.
//  * GEMV (T <= 8).  A block owns 32 output columns for all T rows (TT = 4
//    or 8 sums per column), so D = 4096 gives 128 blocks, about one per SM.
//    Its 512 threads split K: a row of the weight is read by 4 (bf16) or 8
//    (fp32) neighbouring threads with one 16-byte load each, and the block
//    walks 512 (bf16) or 256 (fp32) rows at a time, 4 per thread.  The next
//    chunk's weight loads are issued before the current chunk is used, so
//    32 KB a block stay in flight.  The chunk's rows of a and b are staged
//    as fp32 in shared memory and read as broadcasts.  The threads' partial
//    sums meet by shuffles within a warp and in shared memory across
//    warps, in a fixed order.
//  * GEMM (T > 8), bf16.  64 x 128 output tiles (64 x 64 for T <= 64, so
//    that a verify step's T = 20 still gives 64 blocks at D = 4096), 8
//    warps of 32 columns, on the tensor cores: mma.sync m16n8k16 with fp32
//    accumulators, fragments read from shared memory by ldmatrix (the
//    weight's with .trans, as it is stored K-major).  32 K rows a step;
//    the global loads of the next 8 steps (4 at T > 64) are in flight in
//    registers while a step's products run.  wgmma and TMA are later work.
//  * GEMM (T > 8), fp32.  The same tiling of the work at 64 x 64 on the
//    CUDA cores in fp32 FMA, 4 x 4 sums a thread: fp32 serves the JAX
//    package's kernel sweep, not the model.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

// named, so that a profiler's kernel names carry "fdm::"
namespace fdm {

// a's layout: (n, h, s, hd) heads read as the (n * s, h * hd) matrix
struct ALayout {
  int s, h, hd;
};

__device__ __forceinline__ size_t a_row(const ALayout& L, int t) {
  return (size_t)(t / L.s) * L.h * L.s * L.hd + (size_t)(t % L.s) * L.hd;
}

__device__ __forceinline__ size_t a_col(const ALayout& L, int k) {
  return (size_t)(k / L.hd) * L.s * L.hd + k % L.hd;
}

template <typename T>
using Bits = typename std::conditional<sizeof(T) == 2, unsigned short, unsigned int>::type;

// 16 bytes of T: VN elements of a row starting at p, `valid` of them inside
// the matrix; one vector load when `vec` (the address is 16-byte aligned)
// and all are inside, else element loads and zeros past the edge.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int valid, bool vec) {
  constexpr int VN = 16 / sizeof(T);
  if (vec && valid >= VN) return *reinterpret_cast<const uint4*>(p);
  union {
    uint4 u;
    Bits<T> e[VN];
  } r;
  const Bits<T>* q = reinterpret_cast<const Bits<T>*>(p);
#pragma unroll
  for (int j = 0; j < VN; ++j) r.e[j] = j < valid ? q[j] : Bits<T>(0);
  return r.u;
}

template <typename T>
__device__ __forceinline__ void widen(const uint4& r, float* out);

template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& r, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <>
__device__ __forceinline__ void widen<float>(const uint4& r, float* out) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

// The K ranges of both products as one sequence of chunks of `kt` rows:
// a's ceil(Ka / kt), then b's.
struct Chunks {
  int ka, kb, kt, na;
  __device__ __forceinline__ Chunks(int ka_, int kb_, int kt_)
      : ka(ka_), kb(kb_), kt(kt_), na((ka_ + kt_ - 1) / kt_) {}
  __device__ __forceinline__ int count() const { return na + (kb + kt - 1) / kt; }
  // chunk c -> (second product?, first K row, rows in the chunk)
  __device__ __forceinline__ void at(int c, bool& second, int& k0, int& kn) const {
    second = c >= na;
    k0 = (second ? c - na : c) * kt;
    kn = min(kt, (second ? kb : ka) - k0);
  }
};

// --------------------------------------------------------------------------
// GEMV: T <= TT
// --------------------------------------------------------------------------

constexpr int GV_THREADS = 512;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_CB = 32;  // output columns per block
constexpr int GV_U = 4;    // weight rows per thread per chunk

template <typename T, int TT>
__global__ void __launch_bounds__(GV_THREADS, 1)
gemv_kernel(const T* __restrict__ a, ALayout la, const T* __restrict__ wa, int Ka,
            const T* __restrict__ b, const T* __restrict__ wb, int Kb, T* __restrict__ out,
            int T_rows, int D, bool wa_vec, bool wb_vec) {
  constexpr int VN = 16 / sizeof(T);         // columns per 16-byte load
  constexpr int TPR = GV_CB / VN;            // threads per weight row
  constexpr int RS = GV_THREADS / TPR;       // weight rows in flight per step
  constexpr int KT = RS * GV_U;              // K rows per chunk
  constexpr int SM = KT * TT > GV_WARPS * GV_CB * TT ? KT * TT : GV_WARPS * GV_CB * TT;
  __shared__ __align__(16) float sm[SM];     // xs [KT][TT], then the warps' sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = tid / TPR, cg = tid % TPR;
  const int c0 = blockIdx.x * GV_CB + cg * VN;
  const int valid = D - c0;  // this thread's columns inside the matrix
  const Chunks ch(Ka, Kb, KT);
  const int n_chunks = ch.count();

  float acc[TT][VN];
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[t][j] = 0.f;

  auto load_w = [&](int c, uint4 (&r)[GV_U]) {
    bool second;
    int k0, kn;
    ch.at(c, second, k0, kn);
    const T* w = second ? wb : wa;
    const bool vec = second ? wb_vec : wa_vec;
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int kk = rs + u * RS;
      r[u] = (kk < kn && valid > 0) ? load_chunk(w + (size_t)(k0 + kk) * D + c0, valid, vec)
                                    : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 cur[GV_U], nxt[GV_U];
  load_w(0, cur);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_w(c + 1, nxt);  // in flight while this chunk is used
    bool second;
    int k0, kn;
    ch.at(c, second, k0, kn);
    __syncthreads();  // the previous chunk's rows of x are consumed
    for (int i = tid; i < TT * KT; i += GV_THREADS) {
      const int t = i / KT, kk = i % KT;
      float x = 0.f;
      if (t < T_rows && kk < kn) {
        const int k = k0 + kk;
        x = second ? to_float(b[(size_t)t * Kb + k]) : to_float(a[a_row(la, t) + a_col(la, k)]);
      }
      sm[kk * TT + t] = x;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < GV_U; ++u) {
      const int kk = rs + u * RS;
      float wf[VN], xv[TT];
      widen<T>(cur[u], wf);
#pragma unroll
      for (int t = 0; t < TT; t += 4) {
        const float4 v = *reinterpret_cast<const float4*>(sm + kk * TT + t);
        xv[t] = v.x;
        xv[t + 1] = v.y;
        xv[t + 2] = v.z;
        xv[t + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int j = 0; j < VN; ++j) acc[t][j] = fmaf(xv[t], wf[j], acc[t][j]);
    }
#pragma unroll
    for (int u = 0; u < GV_U; ++u) cur[u] = nxt[u];
  }

  // the row slots of a warp differ in lane by multiples of TPR
#pragma unroll
  for (int t = 0; t < TT; ++t)
#pragma unroll
    for (int j = 0; j < VN; ++j)
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1) acc[t][j] += __shfl_xor_sync(0xffffffffu, acc[t][j], o);
  __syncthreads();
  if (lane < TPR) {  // lane == cg
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int j = 0; j < VN; ++j) sm[((warp * TPR + lane) * TT + t) * VN + j] = acc[t][j];
  }
  __syncthreads();
  for (int i = tid; i < TT * GV_CB; i += GV_THREADS) {
    const int t = i / GV_CB, cc = i % GV_CB, col = blockIdx.x * GV_CB + cc;
    if (t >= T_rows || col >= D) continue;
    float s = 0.f;
    for (int w = 0; w < GV_WARPS; ++w) s += sm[((w * TPR + cc / VN) * TT + t) * VN + cc % VN];
    store_as(out + (size_t)t * D + col, s);
  }
}

// --------------------------------------------------------------------------
// GEMM on the tensor cores: bf16, T > 8
// --------------------------------------------------------------------------

constexpr int MM_BM = 64, MM_BK = 32, MM_THREADS = 256;
constexpr int MM_AS = MM_BK + 8;  // A's row stride in shared memory, in bf16 (16-byte
                                  // multiples, rows off the same banks)

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BN output columns a block (128, or 64 for T <= 64 so that a narrow T
// still gives D / 64 blocks); 8 warps of 32 columns over WARPS_M rows of
// warps.  The global loads of STAGES K steps are in flight at once, in
// registers, so a step does not wait for a round trip to device memory: 8
// at BN 64, where a narrow T leaves the weight's bytes the only cost, 4 at
// BN 128, whose accumulators need the registers.
template <int BN, int STAGES>
__global__ void __launch_bounds__(MM_THREADS)
gemm_mma_kernel(const __nv_bfloat16* __restrict__ a, ALayout la,
                const __nv_bfloat16* __restrict__ wa, int Ka,
                const __nv_bfloat16* __restrict__ b, const __nv_bfloat16* __restrict__ wb,
                int Kb, __nv_bfloat16* __restrict__ out, int T_rows, int D, bool a_vec,
                bool b_vec, bool wa_vec, bool wb_vec) {
  constexpr int WARPS_N = BN / 32, WARPS_M = MM_THREADS / 32 / WARPS_N;
  constexpr int MI = MM_BM / WARPS_M / 16;  // m16 tiles a warp
  constexpr int WS = BN + 8;                // the weight tile's row stride, in bf16
  constexpr int CPR = BN / 8;               // 16-byte chunks in a row of the weight tile
  constexpr int WCH = MM_BK * CPR / MM_THREADS;  // weight chunks a thread loads a step
  __shared__ __align__(16) __nv_bfloat16 As[MM_BM * MM_AS];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Ws[MM_BK * WS];     // [k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * BN;
  const int wm = (warp / WARPS_N) * MI * 16, wn = (warp % WARPS_N) * 32;
  const Chunks ch(Ka, Kb, MM_BK);
  const int n_chunks = ch.count();
  // a's tile (64 rows x 32 K): one 8-wide chunk a thread
  const int am = tid / 4, ak = (tid % 4) * 8;

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int c, uint4& ra, uint4 (&rw)[WCH]) {
    bool second;
    int k0, kn;
    ch.at(c, second, k0, kn);
    const int t = m0 + am, k = k0 + ak;
    const int av = t < T_rows ? min(8, kn - ak) : 0;
    if (av <= 0) {
      ra = make_uint4(0, 0, 0, 0);
    } else if (second) {
      ra = load_chunk(b + (size_t)t * Kb + k, av, b_vec);
    } else if (a_vec && av == 8) {  // 8 columns inside one head
      ra = *reinterpret_cast<const uint4*>(a + a_row(la, t) + a_col(la, k));
    } else {
      union {
        uint4 u;
        unsigned short e[8];
      } r;
      const unsigned short* ab = reinterpret_cast<const unsigned short*>(a) + a_row(la, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) r.e[j] = j < av ? ab[a_col(la, k + j)] : 0;
      ra = r.u;
    }
    const __nv_bfloat16* w = second ? wb : wa;
    const bool wvec = second ? wb_vec : wa_vec;
#pragma unroll
    for (int h = 0; h < WCH; ++h) {
      const int i = tid + h * MM_THREADS, kk = i / CPR, n = n0 + (i % CPR) * 8;
      rw[h] = kk < kn && n < D ? load_chunk(w + (size_t)(k0 + kk) * D + n, D - n, wvec)
                               : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 ra[STAGES], rw[STAGES][WCH];
#pragma unroll
  for (int j = 0; j < STAGES; ++j)
    if (j < n_chunks) load(j, ra[j], rw[j]);
  for (int c0 = 0; c0 < n_chunks; c0 += STAGES) {
#pragma unroll
    for (int j = 0; j < STAGES; ++j) {  // register slot j holds step c0 + j
      const int c = c0 + j;
      if (c >= n_chunks) break;
      __syncthreads();  // the previous step's tiles are consumed
      *reinterpret_cast<uint4*>(&As[am * MM_AS + ak]) = ra[j];
#pragma unroll
      for (int h = 0; h < WCH; ++h) {
        const int i = tid + h * MM_THREADS;
        *reinterpret_cast<uint4*>(&Ws[(i / CPR) * WS + (i % CPR) * 8]) = rw[j][h];
      }
      __syncthreads();
      if (c + STAGES < n_chunks) load(c + STAGES, ra[j], rw[j]);
#pragma unroll
      for (int kk = 0; kk < MM_BK; kk += 16) {
        uint32_t af[MI][4], bq[2][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(af[mi], &As[(wm + mi * 16 + lane % 16) * MM_AS + kk + (lane / 16) * 8]);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)  // two n8 tiles each: k 0-7 and 8-15 of each
          ldmatrix_x4_trans(bq[nj], &Ws[(kk + lane % 8 + ((lane / 8) % 2) * 8) * WS + wn +
                                        nj * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(acc[mi][ni], af[mi], bq[ni / 2][(ni % 2) * 2], bq[ni / 2][(ni % 2) * 2 + 1]);
      }
    }
  }

  // c0, c1: row lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: row + 8
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + lane / 4 + (e / 2) * 8;
        const int col = n0 + wn + ni * 8 + (lane % 4) * 2 + e % 2;
        if (row < T_rows && col < D) store_as(out + (size_t)row * D + col, acc[mi][ni][e]);
      }
}

// --------------------------------------------------------------------------
// GEMM on the CUDA cores: fp32, T > 8
// --------------------------------------------------------------------------

constexpr int SG_B = 64, SG_BK = 16, SG_THREADS = 256;

__global__ void __launch_bounds__(SG_THREADS)
gemm_f32_kernel(const float* __restrict__ a, ALayout la, const float* __restrict__ wa, int Ka,
                const float* __restrict__ b, const float* __restrict__ wb, int Kb,
                float* __restrict__ out, int T_rows, int D) {
  __shared__ float As[SG_BK][SG_B + 4];  // [k][m]
  __shared__ float Ws[SG_BK][SG_B + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SG_B, n0 = blockIdx.x * SG_B;
  const Chunks ch(Ka, Kb, SG_BK);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < ch.count(); ++c) {
    bool second;
    int k0, kn;
    ch.at(c, second, k0, kn);
    const float* w = second ? wb : wa;
    __syncthreads();
    for (int i = tid; i < SG_B * SG_BK; i += SG_THREADS) {
      const int m = i / SG_BK, kk = i % SG_BK, t = m0 + m, k = k0 + kk;
      As[kk][m] = t < T_rows && kk < kn
                      ? (second ? b[(size_t)t * Kb + k] : a[a_row(la, t) + a_col(la, k)])
                      : 0.f;
      const int kw = i / SG_B, n = i % SG_B;
      Ws[kw][n] = kw < kn && n0 + n < D ? w[(size_t)(k0 + kw) * D + n0 + n] : 0.f;
    }
    __syncthreads();
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

int cdiv(long x, long y) { return static_cast<int>((x + y - 1) / y); }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int TT>
cudaError_t launch_gemv(const T* a, ALayout la, const T* wa, int Ka, const T* b, const T* wb,
                        int Kb, T* out, int T_rows, int D, cudaStream_t st) {
  constexpr int VN = 16 / sizeof(T);
  const bool rows_vec = D % VN == 0;
  gemv_kernel<T, TT><<<cdiv(D, GV_CB), GV_THREADS, 0, st>>>(
      a, la, wa, Ka, b, wb, Kb, out, T_rows, D, rows_vec && aligned16(wa),
      rows_vec && aligned16(wb));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const T* a, ALayout la, const T* wa, int Ka, const T* b, const T* wb, int Kb,
                T* out, int T_rows, int D, cudaStream_t st) {
  if (T_rows <= 4) return launch_gemv<T, 4>(a, la, wa, Ka, b, wb, Kb, out, T_rows, D, st);
  if (T_rows <= 8) return launch_gemv<T, 8>(a, la, wa, Ka, b, wb, Kb, out, T_rows, D, st);
  if constexpr (sizeof(T) == 2) {
    const bool rows_vec = D % 8 == 0, a_vec = la.hd % 8 == 0 && aligned16(a);
    const bool b_vec = Kb % 8 == 0 && aligned16(b);
    const bool wa_vec = rows_vec && aligned16(wa), wb_vec = rows_vec && aligned16(wb);
    if (T_rows <= MM_BM)
      gemm_mma_kernel<64, 8><<<dim3(cdiv(D, 64), 1), MM_THREADS, 0, st>>>(
          a, la, wa, Ka, b, wb, Kb, out, T_rows, D, a_vec, b_vec, wa_vec, wb_vec);
    else
      gemm_mma_kernel<128, 4><<<dim3(cdiv(D, 128), cdiv(T_rows, MM_BM)), MM_THREADS, 0, st>>>(
          a, la, wa, Ka, b, wb, Kb, out, T_rows, D, a_vec, b_vec, wa_vec, wb_vec);
  } else {
    gemm_f32_kernel<<<dim3(cdiv(D, SG_B), cdiv(T_rows, SG_B)), SG_THREADS, 0, st>>>(
        a, la, wa, Ka, b, wb, Kb, out, T_rows, D);
  }
  return cudaGetLastError();
}

}  // namespace fdm

// a: the heads (n, h, s, hd) read as the (n * s, h * hd) matrix (a plain
// (T, Ka) matrix: s = 1, h = 1, hd = Ka); wa (Ka, D), b (T, Kb), wb (Kb, D),
// out (T, D), all of one dtype.  One launch.
extern "C" int fused_dual_matmul(const void* a, int a_s, int a_h, int a_hd, const void* wa,
                                 const void* b, const void* wb, void* out, int T_rows,
                                 int Kb, int D, int dtype, void* stream) {
  using namespace fdm;
  if (T_rows <= 0 || Kb <= 0 || D <= 0 || a_s <= 0 || a_h <= 0 || a_hd <= 0 ||
      T_rows % a_s || (long)a_h * a_hd > 0x7fffffff || (long)T_rows > 65535L * MM_BM ||
      (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return ERR_BAD_ARGS;
  const ALayout la{a_s, a_h, a_hd};
  const int Ka = a_h * a_hd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return run<float>(static_cast<const float*>(a), la, static_cast<const float*>(wa), Ka,
                      static_cast<const float*>(b), static_cast<const float*>(wb), Kb,
                      static_cast<float*>(out), T_rows, D, st);
  using bf = __nv_bfloat16;
  return run<bf>(static_cast<const bf*>(a), la, static_cast<const bf*>(wa), Ka,
                 static_cast<const bf*>(b), static_cast<const bf*>(wb), Kb,
                 static_cast<bf*>(out), T_rows, D, st);
}
