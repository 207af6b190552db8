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
// What bounds it on an H100: memory.  Per slot it reads cols (4 bytes) and
// mask (1 byte), reads acc and writes out (4 + 4 bytes), and per live slot it
// gathers one source row (4 f bytes, L2-resident at the executor's tile
// shape: the source tile is n1 x 128 fp32 = 2 MB); 2 f flops per live slot
// are far below the fp32 rate.  At the executor's tile shape (n1 = 4096,
// w up to the 512 width cap, f = 128) on power-law graphs most slots are
// padding, so the per-slot bytes dominate.
//
// Design: one warp per destination row, eight rows per block.  The row's
// h_dst fibre (the first 128 features) is held in registers, four values a
// lane.  The warp walks the row's slots 32 at a time: each lane loads one
// slot's column and mask (one coalesced access each), __ballot_sync turns the
// masks into a bit set of live slots, and only live slots are scored, so a
// masked slot costs no gather (its result is acc + 0 whatever the gathered
// row holds).  Live slots are scored four at a time so four row gathers are
// in flight at once; each gathered row is one coalesced read (lane l reads
// features l, l + 32, l + 64, l + 96 of each 128-float chunk, looping over
// chunks for f > 128), and each slot's partial sums are reduced by a fixed
// xor-shuffle tree.  Every slot's sum is taken in one fixed order, with no
// atomics, so results are deterministic.  The 32 results of a chunk are
// written by the 32 lanes in one coalesced store.  h_dst and h_src take row
// strides (the executor's strided [n1, n2] sub-fibre views go in without a
// copy); cols, mask, acc and out are contiguous [n1, w].  acc may be null
// and may alias out.  A live slot whose column lies outside [0, n_src)
// gathers nothing and scores NaN, so a malformed tile cannot read past
// h_src (checking the columns on the host would cost a device round trip
// per launch).  The kernel launches on the caller's stream and allocates
// nothing.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
sddmm_f32_kernel(const float* __restrict__ hd, const float* __restrict__ hs,
                 const int* __restrict__ cols,
                 const unsigned char* __restrict__ mask, const float* acc,
                 float* out, int n1, int w, int f, int n_src,
                 long long ldd, long long lds) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n1) return;  // the whole warp leaves together
  const float* drow = hd + r * ldd;
  float d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = lane + 32 * i;
    d[i] = j < f ? drow[j] : 0.0f;
  }
  const int* crow = cols + r * w;
  const unsigned char* mrow = mask ? mask + r * w : nullptr;
  for (int kb = 0; kb < w; kb += 32) {
    const int k = kb + lane;
    int my_c = 0;
    bool my_live = false;
    if (k < w) {
      my_c = crow[k];
      my_live = mrow ? mrow[k] != 0 : true;
    }
    unsigned live = __ballot_sync(FULL, my_live);
    float res = 0.0f;
    while (live) {
      // Up to UNROLL live slots of this chunk, lowest first; -1 is none.
      int us[UNROLL];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        if (live) {
          us[q] = __ffs(live) - 1;
          live &= live - 1;
        } else {
          us[q] = -1;
        }
      }
      float s[UNROLL];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        // An empty entry gathers row 0 (always present) and is discarded,
        // so every load is unconditional and the four gathers overlap.  An
        // out-of-range column (the same in every lane) gathers row 0 too
        // and scores NaN.
        const int c = __shfl_sync(FULL, my_c, us[q] < 0 ? 0 : us[q]);
        const bool bad = us[q] >= 0 && (unsigned)c >= (unsigned)n_src;
        const float* srow = hs + (long long)(us[q] < 0 || bad ? 0 : c) * lds;
        float p = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = lane + 32 * i;
          if (j < f) p = fmaf(d[i], srow[j], p);
        }
        for (int f0 = 128; f0 < f; f0 += 128) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = f0 + lane + 32 * i;
            if (j < f) p = fmaf(drow[j], srow[j], p);
          }
        }
        s[q] = bad ? __int_as_float(0x7fc00000) : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) s[q] += __shfl_xor_sync(FULL, s[q], off);
      }
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        if (lane == us[q]) res = s[q];
      }
    }
    if (k < w) {
      const long long o = r * w + k;
      const float base = acc ? acc[o] : 0.0f;
      out[o] = base + (my_live ? res : 0.0f);
    }
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
  dim3 block(WARPS * 32);
  dim3 grid((n1 + WARPS - 1) / WARPS);
  sddmm_f32_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      h_dst, h_src, cols, mask, acc, out, n1, w, f, n_src, ldd, lds);
  return (int)cudaGetLastError();
}
