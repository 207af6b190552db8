// Blocked-ELL SDDMM tile kernel for the ACK's SDDMM mode (dot scores):
//
//   out[r, k] = acc[r, k] + (mask[r, k] ? <h_dst[r, :], h_src[cols[r, k], :]>
//                                        : 0)
//
// Replaces: src/repro/kernels/sddmm.py, `sddmm` / `_sddmm_kernel` (the
// Pallas kernel that holds a whole (n_src, bf) source tile in VMEM and
// accumulates partial inner products over feature fibres in a (bm, w)
// scratch), reached through src/repro/kernels/ops.py `sddmm` and
// src/repro/core/ack.py `ACK.sddmm`, whose masking and accumulation this
// kernel folds in: it is the ACK's whole dot-mode SDDMM step.  With
// mask == null and acc == null it is the Pallas kernel's own function, in
// which pad slots score the gathered row cols[r, k] (0 for a pad slot).
//
// What bounds it on an H100: memory.  Per slot it reads mask (1 byte) and
// acc and writes out (4 + 4 bytes); per live slot it reads the column (4
// bytes; a masked slot's output is acc whatever its column holds) and
// gathers one source row (4 f bytes, L2-resident at the executor's tile
// shape: the source tile is n1 x 128 fp32 = 2 MB); 2 f flops per live slot
// are far below the fp32 rate.  At the executor's tile shape (n1 = 4096,
// w up to the 512 width cap, f = 128) on power-law graphs most slots are
// padding, so device memory sees the per-slot stream (20 MB on the widest
// Flickr slice, 24 MB with h_dst and the source rows once) and L2 the
// gathers (130 MB there); hub rows (all 512 slots live) are the longest
// chains of work.
//
// Design: the unit of work is a span of SPAN = 32 J = 64 slots of one
// row, one warp each, four warps a block, so a 512-slot hub row is spread
// over eight warps and no warp scores more than 64 slots (with one warp
// per row, four slots a round, a hub row was 128 dependent rounds).  Lane
// l streams slots l + 32 j (j < J: J independent coalesced loads of mask
// and acc in flight per lane), a ballot per j gives the span's live set,
// and the live slots' columns are compacted into a per-warp list in shared
// memory in slot order (rank = live slots before it, from popc of the
// ballots); the column is read only for live slots.  The list is scored
// four slots a round, one per 8-lane group: lane l of a group holds
// features 4 (l + 8 i) .. + 3 (i < 4) of each 128-feature chunk as one
// float4 (16-byte gathers, 128 contiguous bytes per group and i; scalars
// when f, a row stride or a base is not a multiple of four floats), and a
// slot's sum needs 3 xor-shuffle steps within its group where one warp
// per slot needed 5.  Fewer, fatter warps (two or four slots a group per
// round, 128- or 256-slot spans, 8- or 16-warp blocks) measured slower:
// occupancy, not gathers per warp, keeps the L2 busy.  Each slot's sum is
// taken in one fixed order (per lane: i, then the float4's components,
// then the 128-feature chunks; then the 4, 2, 1 shuffle tree), with no
// atomics, so results are
// deterministic, independent of the span and block sizes, and the same on
// the float4 and scalar paths.  Group leaders write scores to a per-warp
// list; lane l adds its slots' scores to acc and writes out (acc + 0 for
// a masked slot, which gathers nothing).  The row's h_dst fibre (first 128
// features) is held in registers; a span with no live slot reads neither
// cols nor h_dst.  h_dst and h_src take row strides (the executor's
// strided [n1, n2] sub-fibre views go in without a copy); cols, mask, acc
// and out are contiguous [n1, w].  acc may be null and may alias out.  A
// live slot whose column lies outside [0, n_src) gathers row 0 and scores
// NaN, so a malformed tile cannot read past h_src (checking the columns on
// the host would cost a device round trip per launch).  The kernel
// launches on the caller's stream and allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int J = 2;            // slots per lane
constexpr int SPAN = 32 * J;    // slots per warp
constexpr unsigned FULL = 0xffffffffu;

// Features c .. c + 3 of `row` (zeros from f on).  VEC: f and the row
// start are multiples of four floats, so a quad is all in or all out.
template <bool VEC>
__device__ __forceinline__ float4 quad(const float* row, int c, int f) {
  if (VEC) {
    if (c < f) return *reinterpret_cast<const float4*>(row + c);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float4 x;
  x.x = c < f ? row[c] : 0.0f;
  x.y = c + 1 < f ? row[c + 1] : 0.0f;
  x.z = c + 2 < f ? row[c + 2] : 0.0f;
  x.w = c + 3 < f ? row[c + 3] : 0.0f;
  return x;
}

__device__ __forceinline__ float dot4(float p, const float4& a,
                                      const float4& b) {
  p = fmaf(a.x, b.x, p);
  p = fmaf(a.y, b.y, p);
  p = fmaf(a.z, b.z, p);
  return fmaf(a.w, b.w, p);
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
sddmm_f32_kernel(const float* __restrict__ hd, const float* __restrict__ hs,
                 const int* __restrict__ cols,
                 const unsigned char* __restrict__ mask, const float* acc,
                 float* out, int n1, int w, int f, int n_src,
                 long long ldd, long long lds) {
  __shared__ int list_c[WARPS][SPAN];     // live slots' columns, slot order
  __shared__ float list_s[WARPS][SPAN];   // their scores
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int spans = (w + SPAN - 1) / SPAN;
  const long long gw = (long long)blockIdx.x * WARPS + wid;
  if (gw >= (long long)n1 * spans) return;  // the whole warp leaves
  const long long r = gw / spans;
  const long long o = r * w + (gw - r * spans) * SPAN + lane;  // slot j = 0
  const int k = (int)(gw - r * spans) * SPAN + lane;

  bool live[J];
  float val[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool in = k + 32 * j < w;
    live[j] = in && (mask ? mask[o + 32 * j] != 0 : true);
    val[j] = (acc && in) ? acc[o + 32 * j] : 0.0f;
  }
  int rank[J], n_live = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const unsigned word = __ballot_sync(FULL, live[j]);
    rank[j] = n_live + __popc(word & below);
    n_live += __popc(word);
  }

  if (n_live) {   // warp-uniform
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (live[j]) list_c[wid][rank[j]] = cols[o + 32 * j];
    __syncwarp();
    const int g = lane >> 3, l = lane & 7;
    const float* drow = hd + r * ldd;
    float4 d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = quad<VEC>(drow, 4 * (l + 8 * i), f);
    for (int b0 = 0; b0 < n_live; b0 += 4) {
      // Slot b0 + g of the list goes to group g; an index past the list
      // gathers row 0 and is discarded.
      const int idx = b0 + g;
      const int c = idx < n_live ? list_c[wid][idx] : 0;
      const bool bad = (unsigned)c >= (unsigned)n_src;
      const float* srow = hs + (long long)(bad ? 0 : c) * lds;
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = quad<VEC>(srow, 4 * (l + 8 * i), f);
      float p = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p = dot4(p, d[i], x[i]);
      for (int fc = 128; fc < f; fc += 128) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c4 = fc + 4 * (l + 8 * i);
          p = dot4(p, quad<VEC>(drow, c4, f), quad<VEC>(srow, c4, f));
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) p += __shfl_xor_sync(FULL, p, off);
      if (l == 0 && idx < n_live)
        list_s[wid][idx] = bad ? __int_as_float(0x7fc00000) : p;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (live[j]) val[j] += list_s[wid][rank[j]];
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (k + 32 * j < w) out[o + 32 * j] = live[j] ? val[j] : val[j] + 0.0f;
  }
}

}  // namespace

// out = acc + where(mask, SDDMM(h_dst, h_src, cols), 0).  mask (bool, one
// byte per slot) and acc may be null; h_src has n_src >= 1 rows.  Returns
// cudaGetLastError() after the launch (0 when there is nothing to compute).
extern "C" int sddmm_f32(const float* h_dst, const float* h_src,
                         const int* cols, const unsigned char* mask,
                         const float* acc, float* out, int n1, int w, int f,
                         int n_src, long long ldd, long long lds,
                         void* stream) {
  if (n1 <= 0 || w <= 0) return 0;
  // float4 rows: f, the row strides and the base addresses all a multiple
  // of four floats.
  const bool vec = f % 4 == 0 && ldd % 4 == 0 && lds % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(h_dst) |
                     reinterpret_cast<uintptr_t>(h_src)) & 15) == 0;
  const long long warps = (long long)n1 * ((w + SPAN - 1) / SPAN);
  dim3 grid((unsigned)((warps + WARPS - 1) / WARPS));
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    sddmm_f32_kernel<true><<<grid, WARPS * 32, 0, s>>>(
        h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  else
    sddmm_f32_kernel<false><<<grid, WARPS * 32, 0, s>>>(
        h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  return (int)cudaGetLastError();
}
