// GEMM tile kernel for the ACK's GEMM mode:  C = acc + A * B  in fp32.
//
// Replaces: src/repro/kernels/gemm.py, `gemm` / `_gemm_kernel` (the Pallas
// output-stationary blocked matmul with a VMEM fp32 accumulator), reached
// through src/repro/kernels/ops.py `gemm` and src/repro/core/ack.py
// `ACK.gemm`.
//
// What bounds it on an H100: at the executor's tile shape (A = a [4096, 128]
// sub-fiber, B = a [128, 128] weight block) one call does 134 MFLOP and moves
// about 6.3 MB (A, B, acc read once, C written once), i.e. about 2 us at the
// CUDA-core fp32 rate (67 TFLOP/s) and about 2 us at 3.35 TB/s.  So it sits
// on the ridge, and at this size the launch itself (a few us) dominates.
//
// Design: parity with the JAX reference needs IEEE fp32 (no TF32 tensor
// cores, which keep only ~3 decimal digits), so this is a CUDA-core kernel:
// a 64x64 output tile per block, 256 threads each owning a 4x4 register
// micro-tile, K stepped through shared memory in tiles of 16 in increasing
// order.  Every output element accumulates its K products in one fixed
// order starting from 0 and adds `acc` last, so the result is deterministic
// and does not depend on the launch geometry.  Ragged edges (M, N, K not
// multiples of the tile) are masked with zero fill.  A, B, acc and C take
// row strides, so the executor's strided tile views go in without copies;
// the column stride must be 1.  `acc` may be null (C = A * B) and may alias
// C (each thread reads its acc element before writing the same C element).
// The kernel launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* acc, float* C, int M, int N, int K,
                long long lda, long long ldb, long long ldacc,
                long long ldc) {
  // A is stored transposed in shared memory (k-major) so the inner loop
  // reads a column of A and a row of B; +1 pads away bank conflicts on
  // the transposing store.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);       // micro-tile column
  const int ty = tid / (BN / TN);       // micro-tile row
  const long long row0 = (long long)blockIdx.y * BM;
  const long long col0 = (long long)blockIdx.x * BN;

  float c[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile [BM, BK]: consecutive threads read consecutive k of one row.
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      const long long gm = row0 + m;
      const int gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? A[gm * lda + gk] : 0.0f;
    }
    // B tile [BK, BN]: consecutive threads read consecutive columns.
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk;
      const long long gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? B[(long long)gk * ldb + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = row0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long gn = col0 + tx * TN + j;
      if (gn >= N) continue;
      const float base = acc ? acc[gm * ldacc + gn] : 0.0f;
      C[gm * ldc + gn] = base + c[i][j];
    }
  }
}

}  // namespace

// C = acc + A * B.  Returns cudaGetLastError() after the launch (0 when
// there is nothing to compute).
extern "C" int gemm_f32(const float* A, const float* B, const float* acc,
                        float* C, int M, int N, int K, long long lda,
                        long long ldb, long long ldacc, long long ldc,
                        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      A, B, acc, C, M, N, K, lda, ldb, ldacc, ldc);
  return (int)cudaGetLastError();
}
