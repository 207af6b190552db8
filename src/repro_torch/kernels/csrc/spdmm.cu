// Blocked-ELL SpDMM tile kernel for the ACK's SpDMM mode (SUM / MEAN):
//
//   out[r, f] = acc[r, f] + sum_{k = 0 .. w-1} vals[r, k] * h[cols[r, k], f]
//
// Replaces: src/repro/kernels/spdmm.py, `spdmm` / `_spdmm_kernel` (the
// Pallas kernel that holds a whole (n_src, bf) source tile in VMEM and walks
// the ELL width serially), reached through src/repro/kernels/ops.py `spdmm`
// and src/repro/core/ack.py `ACK.spdmm`.
//
// What bounds it on an H100: memory.  The kernel computes every padded ELL
// slot (2 flops per slot and feature) but has to read the [n1, w] cols and
// vals once and gather one h row per slot; at the executor's tile shape
// (n1 = 4096, w up to the 512 width cap, f = 128) the gathers are 512-byte
// rows of a 2 MB source tile, which stays resident in the 50 MB L2, so the
// device-memory bytes are cols + vals + h + acc + out.  On power-law graphs
// most slots are padding (cols 0, vals 0), which is work this kernel does
// and the bound (counted from the true edges) does not.
//
// Design: the TPU kernel's VMEM-resident source tile (up to 16384 x 128 fp32
// = 8 MB) does not fit Hopper's 227 KB of shared memory, so rows are
// gathered from global memory through L2 instead.  Threads run over the
// feature axis (blockDim.x features, blockDim.y rows per block), so one
// gathered row h[cols[r, k], :] is read coalesced, and cols / vals are the
// same address for all threads of a row (a broadcast).  Each output element
// walks k = 0 .. w-1 in order with an fp32 register accumulator starting at
// 0 and adds acc last: no atomics, one fixed order, deterministic results.
// Pad slots are computed, not skipped, exactly as the Pallas kernel does
// (they contribute vals == 0).  h takes a row stride, so the executor's
// strided [n1, n2] sub-fiber view goes in without a copy; cols and vals are
// contiguous [n1, w].  acc may be null and may alias out.  The kernel
// launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
spdmm_f32_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                 const float* __restrict__ h, const float* acc, float* out,
                 int n1, int w, int f, long long ldh, long long ldacc,
                 long long ldo) {
  const int feat = blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n1 || feat >= f) return;
  const int* crow = cols + r * w;
  const float* vrow = vals + r * w;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < w; ++k) {
    s = fmaf(vrow[k], h[(long long)crow[k] * ldh + feat], s);
  }
  const float base = acc ? acc[r * ldacc + feat] : 0.0f;
  out[r * ldo + feat] = base + s;
}

}  // namespace

// out = acc + ELL(cols, vals) * h.  Returns cudaGetLastError() after the
// launch (0 when there is nothing to compute).
extern "C" int spdmm_f32(const int* cols, const float* vals, const float* h,
                         const float* acc, float* out, int n1, int w, int f,
                         long long ldh, long long ldacc, long long ldo,
                         void* stream) {
  if (n1 <= 0 || f <= 0) return 0;
  // Features per block: f rounded up to a whole warp, at most 128.
  int bx = ((f < 128 ? f : 128) + 31) / 32 * 32;
  int by = THREADS / bx;
  dim3 block(bx, by);
  dim3 grid((f + bx - 1) / bx, (n1 + by - 1) / by);
  spdmm_f32_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cols, vals, h, acc, out, n1, w, f, ldh, ldacc, ldo);
  return (int)cudaGetLastError();
}
