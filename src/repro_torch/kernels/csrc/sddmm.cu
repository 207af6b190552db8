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
//
// h_dst / h_src may also be bf16 (the Pallas kernel widens any float
// operand to fp32) and out bf16 (its `out_dtype`): `sddmm_bf16` and
// `sddmm_bf16_out` run the same body and round each fp32 result, acc
// included, once as it is stored.  A bf16 quad is one 8-byte load of four
// features, widened in registers, where f and both row strides are
// multiples of four and both bases of 8 bytes (`vec_ok`); else four 2-byte
// loads, each behind its bound check (the scalar route, which took 1.45x
// the fp32 body's time on the widest Flickr slice while gathering half its
// bytes, on an H100 80GB HBM3 at 700 W; PERF.md).  Either way a lane holds
// the same features and sums them in the same order, so on fp32 operands
// widened from bf16 the bits are `sddmm_f32`'s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int J = 2;            // slots per lane
constexpr int SPAN = 32 * J;    // slots per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four bf16 (two 32-bit words, the lower feature in the lower half)
// widened to fp32: a bf16 is the upper half of its fp32 value.
__device__ __forceinline__ float4 widen4(unsigned a, unsigned b) {
  return make_float4(__uint_as_float(a << 16),
                     __uint_as_float(a & 0xffff0000u),
                     __uint_as_float(b << 16),
                     __uint_as_float(b & 0xffff0000u));
}

// Features c .. c + 3 of `row` (zeros from f on).  VEC: f and the row
// start are multiples of four elements, so a quad is all in or all out,
// and it is one load: a float4 of fp32, 8 bytes of bf16 widened.
template <bool VEC, typename T>
__device__ __forceinline__ float4 quad(const T* row, int c, int f) {
  if constexpr (VEC) {
    if (c >= f) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (sizeof(T) == 4) {
      return *reinterpret_cast<const float4*>(row + c);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(row + c);
      return widen4(u.x, u.y);
    }
  }
  float4 x;
  x.x = c < f ? widen(row[c]) : 0.0f;
  x.y = c + 1 < f ? widen(row[c + 1]) : 0.0f;
  x.z = c + 2 < f ? widen(row[c + 2]) : 0.0f;
  x.w = c + 3 < f ? widen(row[c + 3]) : 0.0f;
  return x;
}

// Lane l's features of a row's first 128: quads l + 8 i.
template <bool VEC, typename T>
__device__ __forceinline__ void lane_quads(const T* row, int l, int f,
                                           float4 (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = quad<VEC, T>(row, 4 * (l + 8 * i), f);
}

__device__ __forceinline__ float dot4(float p, const float4& a,
                                      const float4& b) {
  p = fmaf(a.x, b.x, p);
  p = fmaf(a.y, b.y, p);
  p = fmaf(a.z, b.z, p);
  return fmaf(a.w, b.w, p);
}

template <bool VEC, typename T = float, typename OutT = float>
__global__ void __launch_bounds__(WARPS * 32)
sddmm_f32_kernel(const T* __restrict__ hd, const T* __restrict__ hs,
                 const int* __restrict__ cols,
                 const unsigned char* __restrict__ mask, const float* acc,
                 OutT* out, int n1, int w, int f, int n_src,
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
    const T* drow = hd + r * ldd;
    float4 d[4];
    lane_quads<VEC, T>(drow, l, f, d);
    for (int b0 = 0; b0 < n_live; b0 += 4) {
      // Slot b0 + g of the list goes to group g; an index past the list
      // gathers row 0 and is discarded.
      const int idx = b0 + g;
      const int c = idx < n_live ? list_c[wid][idx] : 0;
      const bool bad = (unsigned)c >= (unsigned)n_src;
      const T* srow = hs + (long long)(bad ? 0 : c) * lds;
      float4 x[4];
      lane_quads<VEC, T>(srow, l, f, x);
      float p = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) p = dot4(p, d[i], x[i]);
      for (int fc = 128; fc < f; fc += 128) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c4 = fc + 4 * (l + 8 * i);
          p = dot4(p, quad<VEC, T>(drow, c4, f), quad<VEC, T>(srow, c4, f));
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
    if (k + 32 * j < w) put(out + o + 32 * j, live[j] ? val[j] : val[j] + 0.0f);
  }
}

// The vector route (`quad`'s VEC) for T operands: f and both row strides
// a multiple of Q elements and both bases of Q * sizeof(T) bytes (16 for a
// float4 of fp32, 8 for four bf16).
template <typename T, int Q = 4>
inline bool vec_ok(const void* hd, const void* hs, int f, long long ldd,
                   long long lds) {
  return f % Q == 0 && ldd % Q == 0 && lds % Q == 0 &&
         (reinterpret_cast<uintptr_t>(hd) |
          reinterpret_cast<uintptr_t>(hs)) % (Q * sizeof(T)) == 0;
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
  const long long warps = (long long)n1 * ((w + SPAN - 1) / SPAN);
  dim3 grid((unsigned)((warps + WARPS - 1) / WARPS));
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_ok<float>(h_dst, h_src, f, ldd, lds))
    sddmm_f32_kernel<true><<<grid, WARPS * 32, 0, s>>>(
        h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  else
    sddmm_f32_kernel<false><<<grid, WARPS * 32, 0, s>>>(
        h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  return (int)cudaGetLastError();
}

// sddmm_f32 with bf16 h_dst / h_src (widened as they are read); out and
// acc fp32.
extern "C" int sddmm_bf16(const __nv_bfloat16* h_dst,
                          const __nv_bfloat16* h_src, const int* cols,
                          const unsigned char* mask, const float* acc,
                          float* out, int n1, int w, int f, int n_src,
                          long long ldd, long long lds, void* stream) {
  if (n1 <= 0 || w <= 0) return 0;
  const long long warps = (long long)n1 * ((w + SPAN - 1) / SPAN);
  dim3 grid((unsigned)((warps + WARPS - 1) / WARPS));
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_ok<__nv_bfloat16>(h_dst, h_src, f, ldd, lds))
    sddmm_f32_kernel<true, __nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  else
    sddmm_f32_kernel<false, __nv_bfloat16><<<grid, WARPS * 32, 0, s>>>(
        h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  return (int)cudaGetLastError();
}

// sddmm_f32 with a bf16 out (each score rounded once from its fp32 value
// plus acc; acc stays fp32) and h_dst / h_src fp32 (in_bf16 0) or bf16
// (1).
extern "C" int sddmm_bf16_out(const void* h_dst, const void* h_src,
                              const int* cols, const unsigned char* mask,
                              const float* acc, __nv_bfloat16* out,
                              int in_bf16, int n1, int w, int f, int n_src,
                              long long ldd, long long lds, void* stream) {
  if (n1 <= 0 || w <= 0) return 0;
  using bf = __nv_bfloat16;
  const bool vec = in_bf16 ? vec_ok<bf>(h_dst, h_src, f, ldd, lds)
                           : vec_ok<float>(h_dst, h_src, f, ldd, lds);
  const long long warps = (long long)n1 * ((w + SPAN - 1) / SPAN);
  dim3 grid((unsigned)((warps + WARPS - 1) / WARPS));
  cudaStream_t s = (cudaStream_t)stream;
  const float *df = static_cast<const float*>(h_dst),
              *sf = static_cast<const float*>(h_src);
  const bf *db = static_cast<const bf*>(h_dst),
           *sb = static_cast<const bf*>(h_src);
  if (in_bf16 && vec)
    sddmm_f32_kernel<true, bf, bf><<<grid, WARPS * 32, 0, s>>>(
        db, sb, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  else if (in_bf16)
    sddmm_f32_kernel<false, bf, bf><<<grid, WARPS * 32, 0, s>>>(
        db, sb, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  else if (vec)
    sddmm_f32_kernel<true, float, bf><<<grid, WARPS * 32, 0, s>>>(
        df, sf, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  else
    sddmm_f32_kernel<false, float, bf><<<grid, WARPS * 32, 0, s>>>(
        df, sf, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  return (int)cudaGetLastError();
}
