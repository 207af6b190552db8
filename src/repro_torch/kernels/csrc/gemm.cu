// GEMM tile kernel for the ACK's GEMM mode:  C = acc + A * B  in fp32.
//
// Replaces: src/repro/kernels/gemm.py, `gemm` / `_gemm_kernel` (the Pallas
// output-stationary blocked matmul with a VMEM fp32 accumulator), reached
// through src/repro/kernels/ops.py `gemm` and src/repro/core/ack.py
// `ACK.gemm`.
//
// What bounds it on an H100: at the executor's tile shape (A = a [4096, 128]
// sub-fiber, B = a [128, 128] weight block) one call does 134 MFLOP and moves
// about 4.2 MB (A, B read once, C written once; 6.3 MB with acc), i.e. about
// 2 us at the CUDA-core fp32 rate (67 TFLOP/s) and 1.3 us at 3.35 TB/s, so
// the fp32 FMA rate bounds it.  Parity with the JAX reference needs IEEE
// fp32 (TF32 tensor cores keep ~3 decimal digits), so it runs on CUDA cores,
// and the rate of FMA and shared-load instructions is what it spends.
//
// Design: each CTA computes a BM x BN = 64 x 32 output tile with 128
// threads, each a 4 x 4 register micro-tile, so M = 4096 is 256 CTAs at
// N = 128 and 64 at N <= 32; 64 x 64 tiles (128 CTAs at N = 128) and
// 64 x 16 ones measured slower at every N from 8 to 128
// (kernel_variants.py).  A's and B's panels are staged into shared memory
// with cp.async in a ring of STAGES = 2 k-stages of BK = 32 (26 KB): the
// next stage arrives while one is computed, so loads overlap compute.
// Deeper rings (3 or 4 stages) measured no faster.
// Copies are 16 bytes where A / B rows are 16-byte aligned (ragged K or N
// edges read the bytes in range and zero-fill the rest through cp.async's
// src-size), else 4-byte cp.async with the same zero fill, so ragged and
// unaligned views go in without copies.  Both panels keep their global
// layout, A [BM][BK + 4] and B [BK][BN], row-major; per 4 k a thread
// reads four float4 of A (4 rows x 4 k, a transpose in registers) and four
// float4 of B, 8 16-byte shared loads for 64 FMAs.  The threads of a
// warp's 8-thread load phase share one micro-tile row, so their A reads
// are one broadcast and their B reads 128 contiguous bytes.  The 4-float
// A row pad keeps 16-byte alignment and puts rows 4 apart (two micro-tile
// rows of one warp) on different banks; without it the kernel measured
// slower (kernel_variants.py, "nopad").  Every output element is one fmaf
// chain over k = 0 .. K-1 from 0.0f (zero-filled k past K add exact
// zeros) with acc added last, so results do not depend on the tile shape
// or the launch geometry (a row slice of a call has the bits of the same
// rows of the whole call).  The epilogue reads acc and writes C as float4
// where C and acc rows are 16-byte aligned.  A, B, acc and C take row
// strides (column stride 1); acc may be null and may alias C (each thread
// reads its acc elements before writing the same C elements).  The kernel
// launches on the caller's stream and allocates nothing.
//
// The file also holds `ell_densify_f32`, which feeds this kernel the dense
// [n1, n_src] adjacency block of a remapped ELL tile (a sparsity-remapped
// binary runs such an AGGREGATE step as dense @ h).  It replaces the XLA
// scatter-add of src/repro/core/ack.py `densify_tile` / `_gemm_agg_xla`,
// which has no Pallas kernel.  A graph may hold the same column twice in
// one row, and a scatter-add on the card sums such duplicates in no fixed
// order, so the block would change from call to call.  Here one warp owns
// row r and lane l owns the row's columns c with c % 32 == l.  The row is
// built in shared memory, DCOLS columns a pass: each lane zeroes its
// columns, the warp reads the row's slots 32 at a time (one coalesced load
// a lane) and broadcasts the non-zero ones in slot order with shuffles,
// the owning lane adds each to its column (lane l only touches bank l),
// and the lanes write the pass's columns out coalesced.  Every element is
// therefore 0.0f plus its slots in slot order, the sum a serial
// scatter-add makes, with no atomics; skipping the zero-valued slots (the
// pads, over 99% of a Flickr slice) changes no bit, as the loop says.  What
// bounds it is writing the block (64 MiB at n1 = n_src = 4096, 0.02 ms at
// 3.35 TB/s); a first design, one 256-thread CTA a row adding into global
// memory, took 16x that (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int STAGES = 2;
constexpr int AST = BK + 4;    // A panel row stride in shared memory
constexpr int THREADS = (BM / 4) * (BN / 4);
constexpr int SMEM_BYTES =
    STAGES * (BM * AST + BK * BN) * (int)sizeof(float);

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into shared memory: `bytes` (0..16) read from src, the rest
// zero-filled.
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage k-tile [k0, k0 + BK) of A (rows row0..) and B (columns col0..)
// into ring slot (as, bs).
template <bool VEC>
__device__ __forceinline__ void load_stage(
    float* as, float* bs, const float* __restrict__ A,
    const float* __restrict__ B, int M, int N, int K, long long lda,
    long long ldb, long long row0, long long col0, int k0, int tid) {
  constexpr int T = THREADS;
  constexpr int W = VEC ? 4 : 1;             // floats per copy
  constexpr int NA = BM * BK / W / T, NB = BK * BN / W / T;
  static_assert(NA * W * T == BM * BK && NB * W * T == BK * BN,
                "whole copies per thread");
  // Fully unrolled for 16-byte copies (4 + 2 a thread); the
  // 4-byte path makes 4x as many and unrolls by 4 to stay in registers.
#pragma unroll(VEC ? NA : 4)
  for (int it = 0; it < NA; ++it) {
    const int e = tid + it * T;
    const int m = e / (BK / W), kk = W * (e % (BK / W));
    const long long gm = row0 + m;
    const int gk = k0 + kk;
    const int bytes = (gm < M && gk < K) ? 4 * min(W, K - gk) : 0;
    const float* src = bytes ? A + gm * lda + gk : A;
    if (VEC) cp16(as + m * AST + kk, src, bytes);
    else cp4(as + m * AST + kk, src, bytes);
  }
#pragma unroll(VEC ? NB : 4)
  for (int it = 0; it < NB; ++it) {
    const int e = tid + it * T;
    const int kk = e / (BN / W), n = W * (e % (BN / W));
    const int gk = k0 + kk;
    const long long gn = col0 + n;
    const int bytes =
        (gk < K && gn < N) ? 4 * (int)min((long long)W, N - gn) : 0;
    const float* src = bytes ? B + (long long)gk * ldb + gn : B;
    if (VEC) cp16(bs + kk * BN + n, src, bytes);
    else cp4(bs + kk * BN + n, src, bytes);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* acc, float* C, int M, int N, int K,
                long long lda, long long ldb, long long ldacc, long long ldc,
                bool vec_out) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][AST]
  float* Bs = smem + STAGES * BM * AST;      // [STAGES][BK][BN]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / 4);             // micro-tile column
  const int ty = tid / (BN / 4);             // micro-tile row
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BN;
  const int kt_n = (K + BK - 1) / BK;

  float c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n)
      load_stage<VEC>(As + s * BM * AST, Bs + s * BK * BN, A, B, M, N,
                          K, lda, ldb, row0, col0, s * BK, tid);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<STAGES - 2>();     // stage kt has landed (this thread's part)
    __syncthreads();           // ... everyone's; slot kt - 1 is free
    const int nk = kt + STAGES - 1;
    if (nk < kt_n)
      load_stage<VEC>(As + (nk % STAGES) * BM * AST,
                          Bs + (nk % STAGES) * BK * BN, A, B, M, N, K, lda,
                          ldb, row0, col0, nk * BK, tid);
    cp_commit();
    const float* as = As + (kt % STAGES) * BM * AST + ty * 4 * AST;
    const float* bs = Bs + (kt % STAGES) * BK * BN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + i * AST + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[e] = *reinterpret_cast<const float4*>(bs + (kk + e) * BN);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bv[4] = {b[e].x, b[e].y, b[e].z, b[e].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = e == 0 ? a[i].x : e == 1 ? a[i].y
                           : e == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av, bv[j], c[i][j]);
        }
      }
    }
  }
  cp_wait<0>();

  const long long gn = col0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gm = row0 + ty * 4 + i;
    if (gm >= M) continue;
    if (vec_out && gn + 3 < N) {
      float4 base = acc ? *reinterpret_cast<const float4*>(
                              acc + gm * ldacc + gn)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(C + gm * ldc + gn) =
          make_float4(base.x + c[i][0], base.y + c[i][1], base.z + c[i][2],
                      base.w + c[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gn + j >= N) continue;
        const float base = acc ? acc[gm * ldacc + gn + j] : 0.0f;
        C[gm * ldc + gn + j] = base + c[i][j];
      }
    }
  }
}

constexpr int DW = 4;           // densify rows (warps) per CTA
constexpr int DCOLS = 2048;     // columns a warp builds per pass (8 KB)

__global__ void __launch_bounds__(DW * 32)
ell_densify_kernel(const int* __restrict__ cols,
                   const float* __restrict__ vals, float* D, int n1, int w,
                   int n_src, long long ldd) {
  __shared__ float acc_all[DW][DCOLS];
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * DW + (threadIdx.x >> 5);
  if (r >= n1) return;                 // whole warps; no block barrier
  float* acc = acc_all[threadIdx.x >> 5];
  float* row = D + r * ldd;
  const int* cr = cols + r * (long long)w;
  const float* vr = vals + r * (long long)w;
  for (int c0 = 0; c0 < n_src; c0 += DCOLS) {
    const int nc = min(DCOLS, n_src - c0);
    for (int c = lane; c < nc; c += 32) acc[c] = 0.0f;
    for (int k0 = 0; k0 < w; k0 += 32) {
      const int k = k0 + lane;
      const int my_c = k < w ? cr[k] - c0 : -1;
      const float my_v = k < w ? vr[k] : 0.0f;
      // A sum that starts at +0.0f is never -0.0f, so adding 0.0f of
      // either sign leaves it unchanged: zero-valued slots (the pads)
      // are skipped without changing a bit.
      unsigned todo = __ballot_sync(0xffffffffu, my_v != 0.0f &&
                                                     my_c >= 0 && my_c < nc);
      while (todo) {                   // the same mask in every lane
        const int q = __ffs(todo) - 1;
        todo &= todo - 1;
        const int c = __shfl_sync(0xffffffffu, my_c, q);
        const float v = __shfl_sync(0xffffffffu, my_v, q);
        if ((c & 31) == lane) acc[c] += v;
      }
    }
    for (int c = lane; c < nc; c += 32) row[c0 + c] = acc[c];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C = acc + A * B.  Returns cudaGetLastError() after the launch (0 when
// there is nothing to compute).
extern "C" int gemm_f32(const float* A, const float* B, const float* acc,
                        float* C, int M, int N, int K, long long lda,
                        long long ldb, long long ldacc, long long ldc,
                        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte staging: A and B rows start on 16-byte boundaries.
  const bool vec = aligned16(A) && aligned16(B) && lda % 4 == 0 &&
                   ldb % 4 == 0;
  const bool vec_out = aligned16(C) && ldc % 4 == 0 &&
                       (acc == nullptr || (aligned16(acc) && ldacc % 4 == 0));
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (vec)
    gemm_f32_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(
        A, B, acc, C, M, N, K, lda, ldb, ldacc, ldc, vec_out);
  else
    gemm_f32_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(
        A, B, acc, C, M, N, K, lda, ldb, ldacc, ldc, vec_out);
  return (int)cudaGetLastError();
}

// D[r, :] = the sum over slots k of vals[r, k] at column cols[r, k], for
// an [n1, w] ELL tile (cols, vals contiguous) into D [n1, n_src] with row
// stride ldd; columns outside [0, n_src) are dropped.  Returns
// cudaGetLastError() after the launch (0 when there is nothing to do).
extern "C" int ell_densify_f32(const int* cols, const float* vals, float* D,
                               int n1, int w, int n_src, long long ldd,
                               void* stream) {
  if (n1 <= 0 || n_src <= 0) return 0;
  ell_densify_kernel<<<(n1 + DW - 1) / DW, DW * 32, 0,
                       (cudaStream_t)stream>>>(cols, vals, D, n1, w, n_src,
                                               ldd);
  return (int)cudaGetLastError();
}
