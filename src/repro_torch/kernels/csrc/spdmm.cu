// Blocked-ELL SpDMM tile kernel for the ACK's SpDMM mode (SUM / MEAN):
//
//   out[r, f] = acc[r, f] + sum_{k < len(r)} vals[r, k] * h[cols[r, k], f]
//
// with len(r) = row_len[r] (clamped to [0, w]), or w when row_len is null.
//
// Replaces: src/repro/kernels/spdmm.py, `spdmm` / `_spdmm_kernel` (the
// Pallas kernel that holds a whole (n_src, bf) source tile in VMEM and walks
// the ELL width serially), reached through src/repro/kernels/ops.py `spdmm`
// and src/repro/core/ack.py `ACK.spdmm`.
//
// What bounds it on an H100: memory.  Per live slot it reads cols and vals
// (8 bytes) and gathers one h row (4 f bytes); per row it reads row_len and
// acc and writes out.  At the executor's tile shape (n1 = 4096, w up to the
// 512 width cap, f = 128) the gathers are 512-byte rows of a 2 MB source
// tile, which stays resident in the 50 MB L2, so the device-memory bytes
// are the live slots' cols + vals, h, acc and out, and the gathers are L2
// traffic (live slots x 4 f bytes).  2 flops per live slot and feature are
// far below the fp32 rate.
//
// Design: the TPU kernel's VMEM-resident source tile (up to 16384 x 128 fp32
// = 8 MB) does not fit Hopper's 227 KB of shared memory, so rows are
// gathered from global memory through L2 instead.  On power-law graphs most
// ELL slots are padding (99.8% on the Flickr program), so the walk stops at
// the row's live length: row_len[r] is 1 + the last live slot of row r (0
// for a row with no edge), staged once per program by the executor.  It is
// a last-live index, not a count: pads between live slots are walked and
// add vals == 0.  One warp per destination row, eight rows per block.  The
// warp loads the row's cols / vals 32 slots at a time, one coalesced access
// each, and broadcasts each slot with __shfl_sync; lane l owns features
// 4l .. 4l + 3 of each 128-feature chunk (one float4 when h, acc and out
// rows are 16-byte aligned, else four scalars at l + 32 i), so one gathered
// row is one coalesced 512-byte read, and sixteen row gathers are in flight
// before their products are summed (a chunk's last slots four, then one,
// at a time).  Each output element sums its slots
// k = 0 .. len-1 in order from 0.0f with fmaf and adds acc last: no
// atomics, one fixed order, deterministic results, and for finite inputs
// the same bits as a walk over all w slots (the skipped slots add exact
// zeros).  h takes a row stride, so the executor's strided [n1, n2]
// sub-fiber view goes in without a copy; cols and vals are contiguous
// [n1, w].  acc may be null and may alias out.  The kernel launches on the
// caller's stream and allocates nothing.
//
// h may also be bf16 (JAX's sweeps run the Pallas kernel on a bf16 source
// tile, which it widens to fp32): `spdmm_bf16` runs the same body on it,
// each gathered element widened to fp32 as it is read, with the scalar
// lane layout (lane l reads features l + 32 i, a 64-byte access a warp),
// so the sums and out (fp32) are those of the fp32 kernel on h widened.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int INFLIGHT = 16;   // row gathers issued before summing
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC (fp32 only): lane l's four features 4l .. 4l + 3 as one float4;
// else features l, l + 32, l + 64, l + 96 of the chunk.
template <bool VEC, typename T>
__device__ __forceinline__ float4 gather(const T* row, int fc, int lane,
                                         int f) {
  if constexpr (VEC) {
    const int c = fc + 4 * lane;
    if (c < f) return *reinterpret_cast<const float4*>(row + c);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 x;
  x.x = fc + lane < f ? widen(row[fc + lane]) : 0.0f;
  x.y = fc + lane + 32 < f ? widen(row[fc + lane + 32]) : 0.0f;
  x.z = fc + lane + 64 < f ? widen(row[fc + lane + 64]) : 0.0f;
  x.w = fc + lane + 96 < f ? widen(row[fc + lane + 96]) : 0.0f;
  return x;
}

__device__ __forceinline__ void fma4(float4& s, float v, const float4& x) {
  s.x = fmaf(v, x.x, s.x);
  s.y = fmaf(v, x.y, s.y);
  s.z = fmaf(v, x.z, s.z);
  s.w = fmaf(v, x.w, s.w);
}

// Slots j .. j + U - 1 of the warp's 32-slot chunk (column and value in
// lane j + u of my_c / my_v): U row gathers issued, then summed in order.
template <bool VEC, int U, typename T>
__device__ __forceinline__ void gather_sum(float4& s, const T* h,
                                           long long ldh, int my_c,
                                           float my_v, int j, int fc,
                                           int lane, int f) {
  float4 x[U];
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = __shfl_sync(FULL, my_c, j + u);
    v[u] = __shfl_sync(FULL, my_v, j + u);
    x[u] = gather<VEC, T>(h + (long long)c * ldh, fc, lane, f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) fma4(s, v[u], x[u]);
}

template <bool VEC, typename T = float>
__global__ void __launch_bounds__(WARPS * 32)
spdmm_f32_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                 const T* __restrict__ h, const float* acc, float* out,
                 const int* __restrict__ row_len, int n1, int w, int f,
                 long long ldh, long long ldacc, long long ldo) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n1) return;  // the whole warp leaves together
  int len = w;
  if (row_len) len = max(0, min(row_len[r], w));
  const int* crow = cols + r * w;
  const float* vrow = vals + r * w;

  for (int fc = 0; fc < f; fc += 128) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int kb = 0; kb < len; kb += 32) {
      const int n = min(32, len - kb);
      const int my_c = lane < n ? crow[kb + lane] : 0;
      const float my_v = lane < n ? vrow[kb + lane] : 0.0f;
      int j = 0;
      for (; j + INFLIGHT <= n; j += INFLIGHT) gather_sum<VEC, INFLIGHT, T>(
          s, h, ldh, my_c, my_v, j, fc, lane, f);
      for (; j + 4 <= n; j += 4) gather_sum<VEC, 4, T>(
          s, h, ldh, my_c, my_v, j, fc, lane, f);
      for (; j < n; ++j) gather_sum<VEC, 1, T>(
          s, h, ldh, my_c, my_v, j, fc, lane, f);
    }
    if (VEC && fc + 4 * lane < f) {
      const int c = fc + 4 * lane;
      float4 base = acc ? *reinterpret_cast<const float4*>(acc + r * ldacc + c)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(out + r * ldo + c) =
          make_float4(base.x + s.x, base.y + s.y, base.z + s.z,
                      base.w + s.w);
    } else if (!VEC) {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = fc + lane + 32 * j;
        if (c < f) {
          const float base = acc ? acc[r * ldacc + c] : 0.0f;
          out[r * ldo + c] = base + sv[j];
        }
      }
    }
  }
}

}  // namespace

// out = acc + ELL(cols, vals) * h over each row's first row_len[r] slots
// (all w slots when row_len is null).  Returns cudaGetLastError() after the
// launch (0 when there is nothing to compute).
extern "C" int spdmm_f32(const int* cols, const float* vals, const float* h,
                         const float* acc, float* out, const int* row_len,
                         int n1, int w, int f, long long ldh, long long ldacc,
                         long long ldo, void* stream) {
  if (n1 <= 0 || f <= 0) return 0;
  // float4 rows: f, the row strides and the base addresses all a multiple
  // of four floats.
  const bool vec = (f % 4 == 0) && (ldh % 4 == 0) && (ldo % 4 == 0) &&
                   (acc == nullptr || ldacc % 4 == 0) &&
                   ((reinterpret_cast<uintptr_t>(h) |
                     reinterpret_cast<uintptr_t>(out) |
                     reinterpret_cast<uintptr_t>(acc)) & 15) == 0;
  dim3 grid((n1 + WARPS - 1) / WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    spdmm_f32_kernel<true><<<grid, WARPS * 32, 0, s>>>(
        cols, vals, h, acc, out, row_len, n1, w, f, ldh, ldacc, ldo);
  else
    spdmm_f32_kernel<false><<<grid, WARPS * 32, 0, s>>>(
        cols, vals, h, acc, out, row_len, n1, w, f, ldh, ldacc, ldo);
  return (int)cudaGetLastError();
}

// spdmm_f32 with a bf16 h (widened as it is gathered); out and acc fp32.
extern "C" int spdmm_bf16(const int* cols, const float* vals,
                          const __nv_bfloat16* h, const float* acc,
                          float* out, const int* row_len, int n1, int w,
                          int f, long long ldh, long long ldacc,
                          long long ldo, void* stream) {
  if (n1 <= 0 || f <= 0) return 0;
  dim3 grid((n1 + WARPS - 1) / WARPS);
  spdmm_f32_kernel<false, __nv_bfloat16>
      <<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
          cols, vals, h, acc, out, row_len, n1, w, f, ldh, ldacc, ldo);
  return (int)cudaGetLastError();
}
