// Blocked-ELL SpDMM kernel for the ACK's SpDMM mode (SUM / MEAN), over a
// list of steps that add into one output tile:
//
//   out[r, f] = (((acc[r, f] + S_1[r, f]) + S_2[r, f]) + ...)
//   S_t[r, f] = sum_{k < len_t(r)} vals_t[r, k] * h[row_off_t + cols_t[r, k], f]
//
// with len_t(r) = row_len_t[r] (clamped to [0, w_t]), or w_t when step t has
// no row_len.  One step with row_off 0 is the single-tile SpDMM of
// `spdmm_f32` / `spdmm_bf16` / `spdmm_bf16_out`; `spdmm_steps` runs a whole
// list (a run of one output tile's aggregate steps) in one launch.
//
// Replaces: src/repro/kernels/spdmm.py, `spdmm` / `_spdmm_kernel` (the
// Pallas kernel that holds a whole (n_src, bf) source tile in VMEM and walks
// the ELL width serially), reached through src/repro/kernels/ops.py `spdmm`
// and src/repro/core/ack.py `ACK.spdmm`, once per tile step.
//
// What bounds it on an H100.  Per live slot it reads cols and vals (8
// bytes) and gathers one h row (4 f bytes); per row and step it reads
// row_len; per row it reads acc and writes out once.  At the executor's
// tile shape (n1 = 4096, w up to the 512 width cap, f = 128) the gathers
// are 512-byte rows of a 2 MB source block, which stays in the 50 MB L2,
// so the device-memory bytes are the walked slots' cols + vals, the
// row_len vectors, h, acc and out, and the gathers are L2 traffic (walked
// slots x 4 f bytes: 130 MB on Flickr's widest slice).  2 flops per slot
// and feature are far below the fp32 rate.  What the time went to is
// latency: a GNN layer's steps are many and small (Flickr's 711 slices a
// layer hold 1-5 live slots in most rows), so a launch per step paid a
// grid, a read of acc and a write of out (4 MB) for a few thousand
// gathers; and the graph's hub rows (Flickr's vertex 0 has 122,157
// in-edges) kept one warp, or one block, walking while the card idled.
//
// Design.  A block owns ROWS_LIST destination rows (ROWS_ONE in a
// one-step call) and one 128-feature chunk for the whole step list: it
// reads acc once and writes out once.  The TPU kernel's VMEM-resident
// source tile does not fit shared memory, so h rows are gathered from
// global memory through L2.  Work is cut into spans: SPAN consecutive
// slots of one row of one step, the last cut at the row's live length
// (row_len[r] is 1 + the last live slot of row r, 0 for a row with no
// edge, staged once per program; pads between live slots are walked and
// add vals == 0).  For ENTRIES / ROWS steps at a time the block reads
// every (step, row) length at once, a thread each, and numbers the spans
// in (step, row, span) order with a block-wide scan; the warps then take
// the spans ROUND at a time, in equal consecutive shares, so a row's spans
// run on different warps beside the short rows'.  A warp walks its share
// as one run of slots: lane l loads the column and value of the run's
// slot q0 + l (whatever span holds it), so a load serves up to 32 slots
// of short rows, and the warp broadcasts each by __shfl_sync; lane l owns
// features 4l .. 4l + 3 of the chunk (one float4 when h, acc and out rows
// are 16-byte aligned, else four scalars at l + 32 i), so one gathered row
// is one coalesced 512-byte read; INFLIGHT gathers are issued before
// their products are summed.  At each span's last slot its partial goes
// to shared memory (two buffers of ROUND partials, one barrier a round);
// then the warp of each row adds its partials in span order and, at each
// step's end, the step's sum into its running total (both kept in shared
// memory, so the walk has the registers).
//
// Hub rows.  A row that walks more slots over a whole list than the
// wrapper's threshold (found on the host when the list is staged) walks
// nothing in the main kernel: a hub pass, launched first, gives each of
// its (row, step) entries a warp anywhere on the card, which sums the
// entry's spans in order into scratch; the row's warp in the main kernel
// adds those step sums to acc in step order.
//
// The arithmetic is fixed by slot index alone: a span's partial is an
// fmaf chain from 0.0f in slot order, a step's row sum is 0.0f plus its
// spans' partials left to right, and the steps are added to acc (0.0f
// when acc is null) in list order.  No atomics, no order that depends on
// the grid, on which warp ran a span or on which rows are hubs: a rerun
// gives the same bits, so does a list split into one-step calls chained
// through acc, and a row of at most SPAN slots sums exactly as the
// one-warp-a-row walk did.  For finite inputs a walk over all w slots
// gives the same bits as the row_len walk (the slots past row_len add
// exact zeros).  h takes a row stride and each step a source-row offset,
// so the executor's strided [rows, n2] feature view goes in without a
// copy; cols and vals are contiguous [n1, w_t].  acc may be null and may
// alias out.  The kernels launch on the caller's stream and allocate
// nothing (the wrapper allocates the hub scratch); the step list and its
// hub entries are device tables (staged once with the tiles, so a
// CUDA-graph capture uploads nothing) or, for one step, a kernel argument.
//
// h may be bf16 (each gathered element widened to fp32 as it is read, with
// the scalar lane layout), and out may be bf16 (each fp32 result, acc
// included, rounded once as it is stored); the sums are those of the fp32
// kernel on h widened.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
// Destination rows a block (warp r sums row r): a step list's blocks hold
// 8; a one-step call's 4, so a block of hub rows splits its spans over
// twice the warps a row (the bits do not depend on it).
constexpr int ROWS_LIST = 8;
constexpr int ROWS_ONE = 4;
constexpr int SPAN = 64;         // slots a span (the unit of the sum order)
constexpr int ENTRIES = WARPS * 32;  // (step, row) pairs a block numbers
                                     // at once: a thread each
constexpr int ROUND = 32;        // span partials a round
constexpr int PER_WARP = ROUND / WARPS;   // most spans a warp walks a round
constexpr int INFLIGHT = 8;      // row gathers issued before summing
constexpr int MIN_BLOCKS = 4;    // blocks an SM (caps registers at 64)
constexpr int HUB_INFLIGHT = 16; // the hub pass's row gathers in flight
constexpr unsigned FULL = 0xffffffffu;

// One step of a list: the [n1, w] ELL tile (cols, vals, optional row_len)
// whose column c names row row_off + c of h.  The layout is the wrapper's
// int64 [n, 5] table (w in the low half of the fifth word).
struct Step {
  const int* cols;
  const float* vals;
  const int* row_len;
  long long row_off;
  int w;
  int pad_;
};
static_assert(sizeof(Step) == 40, "Step is five 8-byte words");

// A hub row's step t: its cols / vals from its first slot, its live
// length and its step's source-row offset (the wrapper's int64 [n, 4]
// table: len in the low half of the last word, the step in the high).
struct HubEntry {
  const int* cols;
  const float* vals;
  long long row_off;
  int len;
  int step;
};
static_assert(sizeof(HubEntry) == 32, "HubEntry is four 8-byte words");

// A list's hub rows (rows that walk more slots over the whole list than
// the wrapper's threshold): their (row, step) entries, row by row in step
// order; of_row[r] is row r's hub index (-1: not a hub), off[i] its first
// entry; scratch [n, f] takes each entry's step sum.
struct Hubs {
  const HubEntry* entries;
  int n;
  const int* of_row;
  const int* off;
  float* scratch;
};

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

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// Four consecutive outputs (16-byte aligned fp32, 8-byte aligned bf16).
__device__ __forceinline__ void put4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x.x, x.y),
                         __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<uint2*>(h);
}

__device__ __forceinline__ void fma4(float4& s, float v, const float4& x) {
  s.x = fmaf(v, x.x, s.x);
  s.y = fmaf(v, x.y, s.y);
  s.z = fmaf(v, x.z, s.z);
  s.w = fmaf(v, x.w, s.w);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A span partial in shared memory, in the lane layout of `gather`.
template <bool VEC>
__device__ __forceinline__ void st_part(float* row, int lane,
                                        const float4& x) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(row + 4 * lane) = x;
  } else {
    row[lane] = x.x;
    row[lane + 32] = x.y;
    row[lane + 64] = x.z;
    row[lane + 96] = x.w;
  }
}

template <bool VEC>
__device__ __forceinline__ float4 ld_part(const float* row, int lane) {
  if constexpr (VEC) return *reinterpret_cast<const float4*>(row + 4 * lane);
  return make_float4(row[lane], row[lane + 32], row[lane + 64],
                     row[lane + 96]);
}

// The walk of a warp's slots: my_row / my_v in lane l hold slot q0 + l's
// h row and value.  Slots j .. j + U - 1 are gathered (U loads issued),
// then summed into s in slot order; where a slot ends the warp's current
// item (q == next_end), s is that item's partial: stored to buf[cur],
// then s restarts from 0.0f and next_end moves to the next item's end
// (lane cur of `ends`).
template <bool VEC, int U, typename T>
__device__ __forceinline__ void walk(float4& s, int& cur, int& next_end,
                                     int ends, float (*buf)[128],
                                     const T* h, long long ldh, int my_row,
                                     float my_v, int q0, int j, int fc,
                                     int lane, int f) {
  float4 x[U];
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = __shfl_sync(FULL, my_row, j + u);
    v[u] = __shfl_sync(FULL, my_v, j + u);
    x[u] = gather<VEC, T>(h + (long long)r * ldh, fc, lane, f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    fma4(s, v[u], x[u]);
    if (q0 + j + u + 1 == next_end) {          // warp-uniform
      st_part<VEC>(buf[cur], lane, s);
      s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ++cur;
      next_end = __shfl_sync(FULL, ends, cur & 31);
    }
  }
}

// A 128-feature chunk of one row, in the lane layout of `gather`.
template <bool VEC>
__device__ __forceinline__ float4 load_row(const float* p, int fc, int lane,
                                           int f) {
  return gather<VEC, float>(p, fc, lane, f);
}

template <bool VEC, typename OutT>
__device__ __forceinline__ void store_row(OutT* p, int fc, int lane, int f,
                                          const float4& x) {
  if constexpr (VEC) {
    const int c = fc + 4 * lane;
    if (c < f) put4(p + c, x);
  } else {
    const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = fc + lane + 32 * j;
      if (c < f) put(p + c, xv[j]);
    }
  }
}

// The hub pass: warp w of block (x, y) takes hub entry WARPS x + w, walks
// its spans in order (each an fmaf chain from 0.0f; the step sum 0.0f plus
// them left to right, as the main kernel's combine adds them) and stores
// the step sum to scratch, features 128 y .. 128 y + 127.
template <bool VEC, int U, typename T>
__device__ __forceinline__ void hub_walk(float4& s, float4& step_sum,
                                         const T* h, long long ldh,
                                         int my_row, float my_v, int q0,
                                         int j, int len, int fc, int lane,
                                         int f) {
  float4 x[U];
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = __shfl_sync(FULL, my_row, j + u);
    v[u] = __shfl_sync(FULL, my_v, j + u);
    x[u] = gather<VEC, T>(h + (long long)r * ldh, fc, lane, f);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    fma4(s, v[u], x[u]);
    const int q = q0 + j + u + 1;
    if (q % SPAN == 0 || q == len) {           // a span's last slot
      step_sum = add4(step_sum, s);
      s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <bool VEC, typename T>
__global__ void __launch_bounds__(WARPS * 32)
spdmm_hub_kernel(Hubs hubs, const T* __restrict__ h, long long ldh, int f) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= hubs.n) return;             // the whole warp leaves together
  const int fc = blockIdx.y * 128;
  const HubEntry he = hubs.entries[e];
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f), step_sum = s;
  for (int q0 = 0; q0 < he.len; q0 += 32) {
    const int n = min(32, he.len - q0);
    int my_row = 0;
    float my_v = 0.0f;
    if (lane < n) {
      my_row = (int)he.row_off + he.cols[q0 + lane];
      my_v = he.vals[q0 + lane];
    }
    int j = 0;
    for (; j + HUB_INFLIGHT <= n; j += HUB_INFLIGHT)
      hub_walk<VEC, HUB_INFLIGHT, T>(s, step_sum, h, ldh, my_row, my_v, q0,
                                     j, he.len, fc, lane, f);
    for (; j + 4 <= n; j += 4)
      hub_walk<VEC, 4, T>(s, step_sum, h, ldh, my_row, my_v, q0, j, he.len,
                          fc, lane, f);
    for (; j < n; ++j)
      hub_walk<VEC, 1, T>(s, step_sum, h, ldh, my_row, my_v, q0, j, he.len,
                          fc, lane, f);
  }
  store_row<VEC>(hubs.scratch + (long long)e * f, fc, lane, f, step_sum);
}

// Block (x, y): rows ROWS x .. ROWS x + ROWS - 1, features 128 y ..
// 128 y + 127, over steps table[0 .. n_steps - 1] (or `one` when table is
// null).
template <int ROWS, bool VEC, typename T, typename OutT>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
spdmm_steps_kernel(const Step* __restrict__ table, const Step one,
                   int n_steps, const T* __restrict__ h, long long ldh,
                   const float* acc, long long ldacc, OutT* out,
                   long long ldo, int n1, int f, Hubs hubs) {
  static_assert(ROWS <= WARPS && ENTRIES % ROWS == 0, "rows a block");
  constexpr int CHUNK = ENTRIES / ROWS;  // steps a block numbers at once
  __shared__ int hub_of[ROWS];         // each row's hub index, or -1
  __shared__ Step desc[CHUNK];
  __shared__ int lens[ENTRIES];
  __shared__ int off[ENTRIES + 1];     // first span of each (step, row)
  __shared__ int wsum[WARPS];
  __shared__ __align__(16) float part[2][ROUND][128];
  __shared__ __align__(16) float total_of[ROWS][128];  // acc + steps so far
  __shared__ __align__(16) float step_of[ROWS][128];   // the step's spans

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int fc = blockIdx.y * 128;
  const int rw = min(warp, ROWS - 1);  // warp < ROWS sums row r0 + warp
  const long long row = r0 + rw;
  if (tid < ROWS)
    hub_of[tid] = hubs.n && r0 + tid < n1 ? hubs.of_row[r0 + tid] : -1;
  __syncthreads();
  const bool sums = warp < ROWS && row < n1;
  const int hub = sums ? hub_of[rw] : -1;
  // A hub row's step sums come from the hub pass: it walks no span here.
  const bool mine = sums && hub < 0;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // Each lane keeps its own elements of its warp's rows (no barrier).
  if (warp < ROWS) {
    st_part<VEC>(total_of[rw], lane, sums && acc ? load_row<VEC>(
        acc + row * ldacc, fc, lane, f) : zero);
    st_part<VEC>(step_of[rw], lane, zero);
  }
  int parity = 0;

  for (int c0 = 0; c0 < n_steps; c0 += CHUNK) {
    const int nc = min(CHUNK, n_steps - c0);
    __syncthreads();                   // the last chunk's reads are done
    {
      // Entry tid: step c0 + tid / ROWS, row r0 + tid % ROWS.
      const int t = tid / ROWS, r = tid % ROWS;
      int len = 0;
      if (t < nc) {
        const Step st = table ? table[c0 + t] : one;
        if (r == 0) desc[t] = st;
        if (r0 + r < n1 && hub_of[r] < 0)
          len = st.row_len ? max(0, min(st.row_len[r0 + r], st.w)) : st.w;
      }
      lens[tid] = len;
      const int spans = (len + SPAN - 1) / SPAN;
      int incl = spans;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      int base = 0;
      for (int i = 0; i < warp; ++i) base += wsum[i];
      off[tid] = base + incl - spans;
      if (tid == ENTRIES - 1) off[ENTRIES] = base + incl;
    }
    __syncthreads();
    const int total = off[ENTRIES];
    int ct = 0;                        // this row's next step to finish
    for (int b = 0; b < total; b += ROUND, parity ^= 1) {
      const int end = min(b + ROUND, total);
      float(*buf)[128] = part[parity];
      // The round's items go to the warps in equal consecutive shares
      // (at most PER_WARP each), each share walked as one run of slots.
      // Lane u of the warp resolves its item u: entry, first slot and
      // length; `ends` (inclusive scan of the lengths) is where each
      // item's slots end in the run.
      const int share = (end - b + WARPS - 1) / WARPS;
      const int i0 = b + warp * share;
      int it_e = 0, it_k0 = 0, it_n = 0;
      if (lane < share && i0 + lane < end) {
        const int i = i0 + lane;
        int lo = 0, hi = ENTRIES;      // off[lo] <= i < off[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (off[mid] <= i) lo = mid; else hi = mid;
        }
        it_e = lo;
        it_k0 = (i - off[lo]) * SPAN;
        it_n = min(it_k0 + SPAN, lens[lo]) - it_k0;
      }
      int ends = it_n;
#pragma unroll
      for (int d = 1; d < PER_WARP; d <<= 1) {
        const int v = __shfl_up_sync(FULL, ends, d);
        if (lane >= d) ends += v;
      }
      const int run = __shfl_sync(FULL, ends, PER_WARP - 1);
      int cur = 0, next_end = __shfl_sync(FULL, ends, 0);
      float4 sum = zero;
      for (int q0 = 0; q0 < run; q0 += 32) {
        // Lane l loads slot q0 + l of the run: item j, its slot k.
        const int q = q0 + lane;
        int j = 0;
#pragma unroll
        for (int u = 0; u < PER_WARP; ++u)
          j += __shfl_sync(FULL, ends, u) <= q;
        j = min(j, PER_WARP - 1);
        const int e = __shfl_sync(FULL, it_e, j);
        const int k = __shfl_sync(FULL, it_k0, j) + q -
                      (__shfl_sync(FULL, ends, j) -
                       __shfl_sync(FULL, it_n, j));
        int my_row = 0;
        float my_v = 0.0f;
        if (q < run) {
          const Step& st = desc[e / ROWS];
          const long long at = (r0 + e % ROWS) * st.w + k;
          my_row = (int)st.row_off + st.cols[at];
          my_v = st.vals[at];
        }
        const int n = min(32, run - q0);
        int jj = 0;
        for (; jj + INFLIGHT <= n; jj += INFLIGHT)
          walk<VEC, INFLIGHT, T>(sum, cur, next_end, ends, buf + i0 - b, h,
                                 ldh, my_row, my_v, q0, jj, fc, lane, f);
        for (; jj + 4 <= n; jj += 4)
          walk<VEC, 4, T>(sum, cur, next_end, ends, buf + i0 - b, h, ldh,
                          my_row, my_v, q0, jj, fc, lane, f);
        for (; jj < n; ++jj)
          walk<VEC, 1, T>(sum, cur, next_end, ends, buf + i0 - b, h, ldh,
                          my_row, my_v, q0, jj, fc, lane, f);
      }
      __syncthreads();
      if (mine) {
        // The row's partials of this round, in span order; at a step's
        // last span, the step's sum goes into the row's total.
        float4 x = ld_part<VEC>(total_of[rw], lane);
        float4 srow = ld_part<VEC>(step_of[rw], lane);
        for (; ct < nc; ++ct) {
          const int e = ct * ROWS + rw, lo = off[e], hi = off[e + 1];
          for (int i = max(lo, b); i < min(hi, end); ++i)
            srow = add4(srow, ld_part<VEC>(buf[i - b], lane));
          if (hi > end) break;         // the step goes on next round
          x = add4(x, srow);
          srow = zero;
        }
        st_part<VEC>(total_of[rw], lane, x);
        st_part<VEC>(step_of[rw], lane, srow);
      }
    }
    if (mine) {                        // steps with no span past the last
      float4 x = ld_part<VEC>(total_of[rw], lane);     // round (srow 0)
      for (; ct < nc; ++ct) x = add4(x, zero);
      st_part<VEC>(total_of[rw], lane, x);
    }
  }
  if (mine)
    store_row<VEC>(out + row * ldo, fc, lane, f,
                   ld_part<VEC>(total_of[rw], lane));
  if (hub >= 0) {
    // acc, then each step's sum in step order.  A step this row has no
    // slot in adds 0.0f, which changes nothing past the first add (a sum
    // is never -0), so one add of 0.0f stands for all of them.
    float4 x = ld_part<VEC>(total_of[rw], lane);
    if (n_steps > 0) x = add4(x, zero);
    const int lo = hubs.off[hub], hi = hubs.off[hub + 1];
    int i = lo;
    for (; i + 8 <= hi; i += 8) {      // eight rows in flight
      float4 y[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        y[u] = load_row<VEC>(hubs.scratch + (long long)(i + u) * f, fc,
                             lane, f);
#pragma unroll
      for (int u = 0; u < 8; ++u) x = add4(x, y[u]);
    }
    for (; i < hi; ++i)
      x = add4(x, load_row<VEC>(hubs.scratch + (long long)i * f, fc, lane,
                                f));
    store_row<VEC>(out + row * ldo, fc, lane, f, x);
  }
}

template <int ROWS, bool VEC, typename T, typename OutT>
int launch(const Step* table, Step one, int n_steps, const void* h,
           long long ldh, const float* acc, long long ldacc, void* out,
           long long ldo, int n1, int f, const Hubs& hubs, cudaStream_t s) {
  if (hubs.n > 0) {
    dim3 hgrid((hubs.n + WARPS - 1) / WARPS, (f + 127) / 128);
    spdmm_hub_kernel<VEC, T><<<hgrid, WARPS * 32, 0, s>>>(
        hubs, static_cast<const T*>(h), ldh, f);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  dim3 grid((n1 + ROWS - 1) / ROWS, (f + 127) / 128);
  spdmm_steps_kernel<ROWS, VEC, T, OutT><<<grid, WARPS * 32, 0, s>>>(
      table, one, n_steps, static_cast<const T*>(h), ldh, acc, ldacc,
      static_cast<OutT*>(out), ldo, n1, f, hubs);
  return (int)cudaGetLastError();
}

// The step list (device table, or `one` when table is null) on h fp32 /
// bf16 (h_bf16) into out fp32 / bf16 (out_bf16).  float4 rows when h is
// fp32 and f, the row strides and the base addresses are multiples of
// four elements (16 bytes; out 8 bytes when bf16).
int run(const Step* table, Step one, int n_steps, const void* h, int h_bf16,
        const float* acc, void* out, int out_bf16, int n1, int f,
        long long ldh, long long ldacc, long long ldo, void* stream,
        const Hubs& hubs = Hubs{}) {
  if (n1 <= 0 || f <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t hp = reinterpret_cast<uintptr_t>(h);
  const uintptr_t ap = reinterpret_cast<uintptr_t>(acc);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const bool vec = !h_bf16 && f % 4 == 0 && ldh % 4 == 0 && ldo % 4 == 0 &&
                   (acc == nullptr || ldacc % 4 == 0) &&
                   ((hp | ap | reinterpret_cast<uintptr_t>(hubs.scratch)) &
                    15) == 0 && (op & (out_bf16 ? 7 : 15)) == 0;
#define SPDMM_LAUNCH(V, T, O)                                               \
  (table ? launch<ROWS_LIST, V, T, O>(table, one, n_steps, h, ldh, acc,       \
                                      ldacc, out, ldo, n1, f, hubs, s)        \
         : launch<ROWS_ONE, V, T, O>(table, one, n_steps, h, ldh, acc, ldacc, \
                                     out, ldo, n1, f, hubs, s))
  if (h_bf16)
    return out_bf16 ? SPDMM_LAUNCH(false, __nv_bfloat16, __nv_bfloat16)
                    : SPDMM_LAUNCH(false, __nv_bfloat16, float);
  if (out_bf16)
    return vec ? SPDMM_LAUNCH(true, float, __nv_bfloat16)
               : SPDMM_LAUNCH(false, float, __nv_bfloat16);
  return vec ? SPDMM_LAUNCH(true, float, float)
             : SPDMM_LAUNCH(false, float, float);
#undef SPDMM_LAUNCH
}

Step one_step(const int* cols, const float* vals, const int* row_len,
              int w) {
  Step s{};
  s.cols = cols;
  s.vals = vals;
  s.row_len = row_len;
  s.w = w;
  return s;
}

}  // namespace

// out = acc + ELL(cols, vals) * h over each row's first row_len[r] slots
// (all w slots when row_len is null): the step list of one step.  Returns
// cudaGetLastError() after the launch (0 when there is nothing to compute).
extern "C" int spdmm_f32(const int* cols, const float* vals, const float* h,
                         const float* acc, float* out, const int* row_len,
                         int n1, int w, int f, long long ldh, long long ldacc,
                         long long ldo, void* stream) {
  return run(nullptr, one_step(cols, vals, row_len, w), 1, h, 0, acc, out, 0,
             n1, f, ldh, ldacc, ldo, stream);
}

// spdmm_f32 with a bf16 h (widened as it is gathered); out and acc fp32.
extern "C" int spdmm_bf16(const int* cols, const float* vals,
                          const __nv_bfloat16* h, const float* acc,
                          float* out, const int* row_len, int n1, int w,
                          int f, long long ldh, long long ldacc,
                          long long ldo, void* stream) {
  return run(nullptr, one_step(cols, vals, row_len, w), 1, h, 1, acc, out, 0,
             n1, f, ldh, ldacc, ldo, stream);
}

// spdmm_f32 with a bf16 out (each output rounded once from its fp32 sum
// plus acc) and h fp32 (h_bf16 0) or bf16 (1).
extern "C" int spdmm_bf16_out(const int* cols, const float* vals,
                              const void* h, const float* acc,
                              __nv_bfloat16* out, const int* row_len,
                              int h_bf16, int n1, int w, int f,
                              long long ldh, long long ldacc, long long ldo,
                              void* stream) {
  return run(nullptr, one_step(cols, vals, row_len, w), 1, h, h_bf16, acc,
             out, 1, n1, f, ldh, ldacc, ldo, stream);
}

// The step list `steps` (a device table of n_steps Step entries) added to
// acc (null: zero) in list order, on h fp32 / bf16 (h_bf16) into out fp32 /
// bf16 (out_bf16) [n1, f].  With n_hub > 0 the list's hub rows (hub_of_row,
// hub_off, the n_hub entries of `hub`) take their step sums from a hub
// pass into scratch [n_hub, f], launched first on the same stream.
extern "C" int spdmm_steps(const void* steps, int n_steps, const void* h,
                           int h_bf16, const float* acc, void* out,
                           int out_bf16, int n1, int f, long long ldh,
                           long long ldacc, long long ldo, const void* hub,
                           int n_hub, const int* hub_of_row,
                           const int* hub_off, float* scratch,
                           void* stream) {
  const Hubs hubs{static_cast<const HubEntry*>(hub), n_hub, hub_of_row,
                  hub_off, scratch};
  return run(static_cast<const Step*>(steps), Step{}, n_steps, h, h_bf16,
             acc, out, out_bf16, n1, f, ldh, ldacc, ldo, stream, hubs);
}
