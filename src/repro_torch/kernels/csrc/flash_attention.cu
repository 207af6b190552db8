// Flash attention forward for the LM prefill and train paths:
//
//   out[bh] = softmax(q[bh] . k[bh / G]^T * scale [+ mask]) . v[bh / G]
//
// per row block of q, with the online max/sum recurrence and fp32 running
// max, sum and accumulator.  The causal mask is the Pallas kernel's index
// mask qpos >= kpos, both counted from 0; a sliding window W >= 1 (causal
// only) also masks keys with qpos - kpos >= W, JAX's `_mask_bias`
// (src/repro/models/attention.py), which gemma3's local layers apply.  G
// query heads share one KV head (grouped-query attention; G = 1 is one KV
// head per query head).  q and k have head dim d; v and out have their own
// width dv <= d (dv = d is the Pallas kernel's contract; deepseek-v3's MLA
// has d = 192, dv = 128).
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` /
// `_flash_kernel` (the Pallas kernel: grid (B*H, Tq/bq), the whole [Tk, d]
// K and V of one head in VMEM, a loop over KV blocks with fp32 m / l / acc
// scratch, causal skip of KV blocks strictly after the query block; any
// head dim).  On the port's path it is reached through
// src/repro_torch/kernels/ops.py `flash_attention` from
// src/repro_torch/models/attention.py `attention` (causal self-attention
// with default positions, windowed or not: every layer of
// DecoderLM.forward, in prefill and in the train step's forward) and
// src/repro_torch/models/mla.py `mla_attention`.
//
// What bounds it on an H100: operations.  At qwen3-0.6b's prefill shape
// (B=4, T=2048: BH = 64 query heads over 32 KV heads, d = 128, bf16,
// causal) the call needs 4 * BH * d * T(T+1)/2 = 68.8 GFLOP of products
// (0.069 ms at the 989 TFLOP/s bf16 tensor-core rate) and moves q and out
// (67 MB) and k and v (34 MB): 0.030 ms at 3.35 TB/s.  At gemma3-12b's
// (BH = 64 over 32, d = 240) it needs 128.9 GFLOP causal (0.130 ms) and
// 96.7 GFLOP with the local layers' window of 1024 (0.098 ms: a row sees
// at most 1024 keys), against 189 MB moved (0.056 ms).  With dv < d a
// kept pair costs 2 (d + dv) flops.  Past d = 256: 137.5 GFLOP at d = 512
// (BH = 32, T = 2048, causal; 0.139 ms) and 584.4 GFLOP at the absorbed-MLA
// shape (BH = 128 over one KV head, d = 576, dv = 512; 0.591 ms), where a
// 64-row CTA does 64 flops per byte of K and V it reads through L2; 275.0
// GFLOP at d = dv = 1,024 (0.278 ms).  In fp32 the products run on CUDA
// cores (67 TFLOP/s): 1.03 ms at qwen3's shape, 2.05 ms at d = 512, 4.10
// ms at d = 1,024, where a CUDA-core FMA wants at most about a byte of
// shared memory read (an SM reads 128 bytes and issues 128 fp32 FMAs a
// clock).
//
// Design.  Hopper runs blocks in parallel, so the Pallas grid's sequential
// KV walk becomes a loop inside one CTA per (bh, query tile), with the
// running statistics in registers; K and V are staged through shared
// memory one key tile at a time (the Pallas kernel keeps the whole [Tk, d]
// head in VMEM, which would not fit in 227 KB at T = 2048).  Query tiles
// are issued heaviest first (the last causal tiles walk the most keys).
// Ragged edges are masked in the kernel: rows past Tq are computed on
// zeros and not stored, keys past Tk score nothing, columns past d (q, k)
// and dv (v) are zero in shared memory, so any Tq, Tk >= 1 work.  The walk
// over KV tiles is bounded on both sides: tiles strictly after the query
// tile are skipped under causal masking, as in the Pallas kernel, and
// under a window W tiles wholly before key q0 - W + 1 (q0 the tile's first
// row) are skipped too; their keys are masked for every row, so skipping
// them is exact.  The mask itself is applied only on tiles that hold a
// masked key: the causal diagonal, the window's lower edge, the ragged end
// of Tk.  A window needs Tq <= Tk, so every row sees at least its own key
// and no row is empty.  Every sum runs in one fixed order with no atomics,
// so results are deterministic.  Seven bodies by `flash_body`'s code; codes
// 3 and 4 are one kernel at two sets of instantiations:
//  * bf16 inputs, d <= 256 (code 3 up to d = 128, 4 past it):
//    warp-specialised.  What bounds it on an H100 is the tensor cores and,
//    beside them, the softmax: a 128 x 128 tile of scores takes 16,384
//    exponentials, 1,024 clocks of an SM's 16 SFU lanes, as long as its
//    two products take on the tensor cores at d = 64 (half as long at d =
//    128), and the max, sums and packing besides.  A warpgroup that runs
//    a tile in series leaves the tensor cores idle through its softmax,
//    so the design keeps other warpgroups' products running meanwhile.
//    Consumer warpgroups own 64 query rows each: two (128 rows a CTA, so
//    K and V are read once per 128 rows), or three at DQK = 64, where a
//    thread's O, S and P fit the 160 registers three leave it and a third
//    warpgroup covers the longer softmax against the shorter products.  A
//    producer warpgroup, whose one elected thread issues TMA (the
//    hardware writes the 128-byte swizzle and zero-fills past Tq, Tk, d
//    and dv), fills Q once and a K ring and a V ring of two slots each.
//    The producer lowers its registers with `setmaxnreg` (to 40 of 168,
//    24 of 128 at three) and the consumers raise theirs (232, 160), so a
//    consumer thread holds O (dv-wide: up to 128 fp32), S (up to 64) and
//    P without spilling; the roles part in one if / else that never
//    rejoins, as `setmaxnreg` needs.  The consumers take turns at the
//    tensor cores on named barriers (ping-pong): a turn issues this
//    tile's Q.K^T and the last tile's P.V as two wgmma groups, then hands
//    over, and the softmax runs while the other warpgroups' products do
//    (ptxas waits for the warpgroup's own P.V before its softmax: see
//    ws_consume).  A K slot is released when its Q.K^T has completed, a V
//    slot when its P.V has.  Q, K and V lie in shared memory as 64-column
//    panels of 128-byte rows whose 16-byte chunks are XORed by row % 8
//    (wgmma's 128-byte swizzle).  S = Q.K^T is wgmma m64n{BK}k16 with both
//    operands from shared memory (K-major); its fp32 accumulators are, per
//    warp, the m16n8k16 A fragments of P.V, so P is rounded to bf16 in
//    registers (as the JAX kernel rounds it) and O = O * alpha + P.V is
//    wgmma m64n{DV}k16 with A from registers and V read in its natural
//    [keys, dv] layout through the transpose bit (MN-major).  Max, sum and
//    rescaling run in fp32, the max on the raw scores with the scale
//    folded into the exponent's fma.  Instantiations by DQK, the first of
//    64, 128, 192 and 256 to hold d (Q.K^T runs DQK / 16 k-steps; the
//    columns past d are zero and add exact zeros), and DV (DQK, but 128
//    for dv <= 128 past d = 128; V panels past dv are zeroed once), with
//    128-key tiles where two slots of K and of V fit beside Q (DQK 64 /
//    128: Q 24 / 32 KB and 64 / 128 KB of ring, 88 / 160 KB; DQK 192 / DV
//    128: Q 48 KB, a K slot 48, a V slot 32; 208 KB) and 64-key tiles
//    elsewhere.  CTAs take the query heads in groups of 8, each group's
//    query tiles heaviest first, so the CTAs on the card at once share the
//    K and V of a few heads through L2; where the K and V of all heads take
//    at most 16 MB, heads run fastest over all of them instead (query
//    tiles heaviest first over the grid: a causal grid's tail is
//    shorter).  Tensors TMA cannot take (d or dv not a multiple of 8, a
//    base not 16-byte aligned) are staged by the producer warpgroup's four
//    warps with plain loads into the same layout.
//  * fp32 inputs, d <= 256: CUDA cores, IEEE fp32 throughout (no TF32;
//    the fp32 parities hold it to 2e-5).  What bounds a CUDA-core body is
//    the shared memory a lane reads per FMA (an LDS.128 hands 16 bytes to
//    each of 32 lanes, four 128-byte wavefronts) and the issue slots the
//    loads take from the FMAs, so the design is register tiles.  Eight
//    warps; a warp owns 16 query rows (8 past d = 128), a CTA 128 (64);
//    lane (rg, cg) of a warp (2 x 16) owns 8 rows (4), 4 keys of a 64-key
//    tile (2 of 32) and 8 of O's columns a 64-column chunk: a step of
//    Q.K^T reads 8 float4 of Q and 4 of K for 128 FMAs (1.5 bytes an
//    FMA), one of P.V 8 float4 of P and 8 of V for 256 (1 byte).  K and V
//    have a ring of two slots each, filled by cp.async (16-byte copies;
//    4-byte ones, into the same layout, where d or dv is not a multiple
//    of 4 or a base is off 16 bytes: the staged route, the same bits) one
//    tile ahead of the math, behind one CTA barrier a tile.  P stays in
//    its warp (a __syncwarp); a warp skips a tile whose keys are all
//    masked for its rows.  Q stays in shared memory: 226 KB in all at
//    DQK = DV = 128 (Q 64 KB, two 33 KB K slots, two 32 KB V slots, P 32
//    KB), 201 KB at 256.  Instantiations (DQK, DV): (32, 32), (64, 64),
//    (128, 128), (256, 128), (256, 256).
//  * fp32 inputs past d = 256: one pass, O split by columns (code 7).  Up
//    to d = 576 with dv <= 512 a CTA owns 64 query rows and its 256
//    threads two halves; each half forms S over its 32 columns of every
//    64-column K piece, the
//    partial S tiles are swapped through shared memory and summed (both
//    halves then hold the same bits, m and l), and each half holds half
//    of O's 64-column chunks (8 rows x 16 columns a lane: 128 fp32 at dv
//    = 512; S 8 x 4).  Q (64 x 576, 145 KB) stays in shared memory; K
//    pieces (64 keys x 64 columns) and V pieces (8 keys x 512 columns)
//    stream through one ring of two slots by cp.async, the staged route
//    as above, one CTA barrier a piece.  Each S tile is formed once.
//    Past that reach, a cluster (below) whose ranks stream Q's pieces
//    with K's (Q is not resident), so a rank's slice of d may be any width.
//  * bf16 inputs past d = 256 (the Pallas kernel takes any d;
//    DeepSeek-V3's absorbed MLA has d = 576, dv = 512): one pass, O split
//    by columns (code 5).  Up to d = 576 with dv <= 512 a CTA owns 64
//    query rows; two consumer warpgroups each hold half of O's columns in
//    registers (64 x 256 fp32
//    at dv = 512: 128 a thread), a producer warpgroup fills Q once and
//    two-slot K and V rings of 32 keys by TMA (setmaxnreg 40 / 232, heads
//    in groups of 8, the staged route, as above).  Each warpgroup runs
//    Q.K^T over half of d; the two partial S tiles are exchanged through
//    shared memory behind named barriers and summed, so both hold the same
//    S and run the same recurrence, then each runs P.V for its half of O.
//    Instantiations (DQK, DV, MODE): (512, 256, 0), (512, 512, 0), (576,
//    512, 0); in clusters (512, 256 / 512, 1) and (512, 512, 2).
//  * past one CTA's reach (d > 576 or dv > 512), both single-pass bodies
//    run in thread-block clusters: what bounds them is still the
//    products, but neither a CTA's shared memory (Q 64 x d) nor its
//    registers (O 64 x dv) hold a query tile past that reach.  C =
//    ceil(d / 512) CTAs (at most 8, the portable cluster size) share a
//    (head, 64-row query tile): rank r owns the r-th run of q / k's
//    64-column panels and of v / out's (at most 512 columns each), forms
//    partial S over its slice of d in its two halves as above and sums
//    them (S_r), then reads the other ranks' S_r from their shared memory
//    (mapa / ld.shared::cluster): each half of the CTA sums half of the
//    tile's elements over the ranks in one fixed order, rank 0 first, and
//    the halves swap, so every CTA holds the same S, m and l bit for bit,
//    and each runs P.V and stores only its slice of O.  So S = Q.K^T is
//    formed once and K and V cross L2 once (the d-sliced bodies this
//    replaces formed S ceil(dv / 128) times).  The S_r sit in a ring of
//    two slots a CTA; once the CTA has written one, C threads arrive
//    (release, cluster scope) on the slot's "written" mbarrier in every
//    CTA, readers wait (acquire) on their own CTA's, and once the CTA has
//    read, C threads arrive on every CTA's "read" mbarrier, which a
//    writer waits on before it reuses the slot: CTAs drift by up to a
//    tile and nobody waits on a peer's P.V.  The launch sets the cluster
//    size at run time (cudaLaunchKernelEx); a cluster barrier follows the
//    barriers' set-up and ends each role, so no CTA leaves while a peer
//    may read its shared memory.  Past C = 8 (d > 4,096) a bf16 rank
//    streams its slice of Q.K^T in rounds of 8 panels, each round's Q and
//    K loaded together (MODE 2), and v / out past 4,096 columns run as
//    slabs of 4,096, one launch each (S formed once a slab).
// Every body writes out in fp32 or bf16 (`out_dtype`, the Pallas kernel's
// argument), rounding the fp32 result once at the store.
// The kernel launches on the caller's stream and allocates nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// The fewest query rows a CTA of any body holds: the entry's bound on Tq
// keeps the fp32 bodies' grid y (ceil(Tq / rows a CTA)) within 65,535.
constexpr int BQ = 64;
constexpr float NEG = -1e30f;    // initial running max (as the Pallas NEG)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// The first KV tile (of `bk` keys) a query tile starting at row q0 walks:
// under a window W, keys before q0 - W + 1 are masked for every row.
__device__ __forceinline__ int kv_tile_begin(int q0, int window, int bk) {
  return window > 0 ? max(0, q0 - window + 1) / bk : 0;
}

// One past the last KV tile (of `bk` keys) a query tile of `rows` rows
// from q0 walks: under causal masking, keys after its last row are masked
// for every row.
__device__ __forceinline__ int kv_tile_end(int q0, int rows, int bk, int tk,
                                           int causal) {
  const int end = causal ? min(tk, q0 + rows) : tk;
  return (end + bk - 1) / bk;
}

// The epilogue's store of one output element in the output's type.
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// Columns c and c + 1 of an output row of width w at dst (column c), as
// one 4- or 8-byte store where both lie in the row and w is even.
template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* dst, int c, int w, float x0,
                                           float x1) {
  if (c + 1 < w && (w & 1) == 0) {
    if constexpr (sizeof(OutT) == 2)
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    if (c < w) put(dst, x0);
    if (c + 1 < w) put(dst + 1, x1);
  }
}
// Columns c .. c + 3 (c < w) of an output row of width w at dst (column
// c): one 16- or 8-byte store where `vec` (w % 4 == 0 and a 16-byte base:
// the chunk is aligned), else element by element up to w.
template <typename OutT>
__device__ __forceinline__ void store4(OutT* dst, int c, int w, bool vec,
                                       float4 x) {
  if (vec) {
    if constexpr (sizeof(OutT) == 2) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = u;
    } else {
      *reinterpret_cast<float4*>(dst) = x;
    }
  } else {
    put(dst, x.x);
    if (c + 1 < w) put(dst + 1, x.y);
    if (c + 2 < w) put(dst + 2, x.z);
    if (c + 3 < w) put(dst + 3, x.w);
  }
}

// ------------------------------------------------------------------------ //
// fp32: CUDA cores, IEEE fp32, operands staged by cp.async.
// ------------------------------------------------------------------------ //
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------------ //
// mbarriers, and thread-block clusters: distributed shared memory and its
// barriers.
// ------------------------------------------------------------------------ //
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}
// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ int cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// The address in CTA `rank`'s shared memory of the variable at `local` in
// this CTA's (a shared::cluster address).
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
// x = the 4 floats at shared::cluster address `addr` (ADD: x += them),
// the load and the additions in one block, so that no scheduler hoists a
// run of loads ahead of their additions (registers are scarce where this
// runs).
template <bool ADD>
__device__ __forceinline__ void ld_peer4(float& x0, float& x1, float& x2,
                                         float& x3, uint32_t addr) {
  if constexpr (ADD)
    asm volatile(
        "{\n.reg .f32 a, b, c, d;\n"
        "ld.shared::cluster.v4.f32 {a, b, c, d}, [%4];\n"
        "add.f32 %0, %0, a;\nadd.f32 %1, %1, b;\n"
        "add.f32 %2, %2, c;\nadd.f32 %3, %3, d;\n}\n"
        : "+f"(x0), "+f"(x1), "+f"(x2), "+f"(x3) : "r"(addr) : "memory");
  else
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3)
                 : "r"(addr) : "memory");
}
// The same from this CTA's own shared memory (a shared::cta address).
template <bool ADD>
__device__ __forceinline__ void ld_own4(float& x0, float& x1, float& x2,
                                        float& x3, uint32_t addr) {
  if constexpr (ADD)
    asm volatile(
        "{\n.reg .f32 a, b, c, d;\n"
        "ld.shared.v4.f32 {a, b, c, d}, [%4];\n"
        "add.f32 %0, %0, a;\nadd.f32 %1, %1, b;\n"
        "add.f32 %2, %2, c;\nadd.f32 %3, %3, d;\n}\n"
        : "+f"(x0), "+f"(x1), "+f"(x2), "+f"(x3) : "r"(addr) : "memory");
  else
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3)
                 : "r"(addr) : "memory");
}
// One arrival on the barrier at shared::cluster address `addr` (in any CTA
// of the cluster), releasing this thread's earlier accesses (and those
// ordered before them, as a __syncwarp orders its warp's) at cluster scope.
__device__ __forceinline__ void mbar_arrive_peer(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
               "[%0];\n" ::"r"(addr) : "memory");
}
// mbar_wait, acquiring at cluster scope what the arrivals released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// Every non-exited thread of the cluster: arrive, then wait for the rest.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// Threads 0 .. C - 1 each arrive once on the barrier at `bar` (a slot's
// written or read barrier) of CTA `threadIdx.x` of the cluster.
__device__ __forceinline__ void cl_arrive_all(uint32_t bar, int nc) {
  if (threadIdx.x < nc) mbar_arrive_peer(peer_addr(bar, threadIdx.x));
}
// Half HF of a thread's S (its float4s N HF .. N HF + N - 1 of 2N)
// summed over the cluster in rank order, in place in `s`: each rank's S_r
// read at `at` (the slot, offset to this thread's float4; its float4 i
// lies 16 * 128 * i bytes on) in its shared memory, this CTA's with a
// plain shared load (`s` holds it until its turn only at rank 0).
template <int N, int HF>
__device__ __forceinline__ void cl_sum_half(float (&s)[8 * N], uint32_t at,
                                            int rank, int nc) {
  constexpr int F = 4 * N * HF;           // the half's first element
  for (int r = 0; r < nc; ++r) {
    if (r == rank) {
      if (r > 0) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          ld_own4<true>(s[F + 4 * i], s[F + 4 * i + 1], s[F + 4 * i + 2],
                        s[F + 4 * i + 3], at + 16 * 128 * (N * HF + i));
      }
    } else {
      const uint32_t base = peer_addr(at, r) + 16 * 128 * N * HF;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (r == 0)
          ld_peer4<false>(s[F + 4 * i], s[F + 4 * i + 1], s[F + 4 * i + 2],
                          s[F + 4 * i + 3], base + 16 * 128 * i);
        else
          ld_peer4<true>(s[F + 4 * i], s[F + 4 * i + 1], s[F + 4 * i + 2],
                         s[F + 4 * i + 3], base + 16 * 128 * i);
      }
    }
  }
}
// The clusters' gather of partial S, both bodies' (bf16 cl_exchange and
// fp32 f32_cl_exchange, which sum the CTA's S_r first and swap the halves
// after).  A CTA's S_r sit in a ring of slots (float4 [2N][128 threads]);
// the use `use` of slot `slot` waits until every CTA has read its last
// use (the slot's "read" barrier), this thread writes its half `hf` of
// S_r there (`pub`: its float4 0 in the slot), and once the CTA's NT
// threads have (CTA barrier BAR) threads 0 .. C - 1 arrive (release,
// cluster scope) on the slot's "written" barrier of every CTA; after this
// CTA's completes (acquire), half `hf` is summed over the ranks.  The
// caller arrives on every CTA's read barrier (cl_arrive_all) once the
// CTA's every thread has passed its sums.
template <int N, int BAR, int NT>
__device__ __forceinline__ void cl_gather(float (&s)[8 * N], float4* pub,
                                          uint32_t x_full, uint32_t x_empty,
                                          int slot, int use, int hf,
                                          int rank, int nc) {
  if (use > 0) mbar_wait_cluster(x_empty + 8 * slot, (use - 1) & 1);
#pragma unroll
  for (int i = 0; i < 2 * N; ++i)
    if (i / N == hf)
      pub[128 * i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                 s[4 * i + 3]);
  asm volatile("bar.sync %0, %1;\n" ::"n"(BAR), "n"(NT) : "memory");
  cl_arrive_all(x_full + 8 * slot, nc);
  mbar_wait_cluster(x_full + 8 * slot, use & 1);
  const uint32_t at = smem_u32(pub);
  if (hf == 0)
    cl_sum_half<N, 0>(s, at, rank, nc);
  else
    cl_sum_half<N, 1>(s, at, rank, nc);
}

// A CTA's share of a call spread over a cluster (bodies' MODE 1 and 2),
// or the whole call (MODE 0).  Rank r of C owns the r-th run of 64-column
// panels of q / k (whole panels, ceil(panels / C) a rank: at most 8, 512
// columns, as C = ceil(d / 512)) and of v / out (the same split of dv's
// panels).  Past C = 8 (d > 4,096) a rank's q / k run is whole rounds of 8
// panels (MODE 2: Q streams through shared memory a round at a time).
struct Slice {
  int rank, nc;     // this CTA's rank, the cluster's CTAs
  int qc0;          // the first column of q / k this rank reads
  int np_q;         // q / k panels loaded a round (zero past d)
  int rounds;       // rounds of Q.K^T a key tile (MODE 2), else 1
  int v0;           // the first column of v / out this rank owns
  int np_v;         // v panels loaded (zero past dv)
  int vend;         // one past the last column of out this rank stores
};

// The slice of rank `rank` of `nc` for q / k of width d and the columns
// [vs0, vs0 + dvs) of v / out.
template <int MODE>
__device__ __forceinline__ Slice make_slice(int rank, int nc, int d, int dv,
                                            int vs0, int dvs) {
  Slice s;
  s.rank = rank;
  s.nc = nc;
  const int pq = (d + 63) / 64;
  if constexpr (MODE == 0) {
    s.qc0 = 0;
    s.np_q = pq;
    s.rounds = 1;
    s.v0 = 0;
    s.np_v = (dv + 63) / 64;
    s.vend = dv;
    return s;
  }
  if constexpr (MODE == 2) {
    s.rounds = ((pq + 7) / 8 + nc - 1) / nc;
    s.qc0 = rank * s.rounds * 512;
    s.np_q = 8;
  } else {
    const int per = (pq + nc - 1) / nc;
    s.rounds = 1;
    s.qc0 = rank * per * 64;
    s.np_q = max(0, min(per, pq - rank * per));
  }
  const int per_v = ((dvs + 63) / 64 + nc - 1) / nc;
  s.v0 = vs0 + rank * per_v * 64;
  s.vend = min(s.v0 + per_v * 64, vs0 + dvs);
  s.np_v = s.vend > s.v0 ? (s.vend - s.v0 + 63) / 64 : 0;
  return s;
}


// Rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a [n_rows, w] fp32
// matrix into dst (row stride LD floats) by the CTA's NT threads, as
// copies in flight, zero past n_rows and w (src-size 0).  `vec`: 16-byte
// copies (w % 4 == 0 and a 16-byte base, so every chunk is aligned); else
// 4-byte ones, the staged route, into the same layout, so both routes
// hand the math the same values.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void f32_stage(float* dst, const float* src,
                                          int r0, int n_rows, int c0, int w,
                                          bool vec) {
  if (vec) {
    constexpr int CH = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < n_rows && gc < w;
      cp_async16(dst + r * LD + c, ok ? src + (long long)gr * w + gc : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += NT) {
      const int r = e / COLS, c = e % COLS;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < n_rows && gc < w;
      cp_async4(dst + r * LD + c, ok ? src + (long long)gr * w + gc : src,
                ok ? 4 : 0);
    }
  }
}

// d <= 256: warp w owns WR = 2 MR query rows; lane (rg, cg) of it (rg <
// 2, cg < 16) owns rows rg + 2 i (i < MR), S columns cg + 16 j (j < KJ)
// and O's float4 columns cg + 16 jj (jj < OJ).  A step of Q.K^T reads MR
// float4 of Q and KJ of K for 4 MR KJ FMAs, a step of P.V MR float4 of P
// and 4 OJ of V for 16 MR OJ: at d <= 128 (MR = 8, KJ = 4, OJ = 2) 1.5
// and 1 bytes of shared memory a lane an FMA.  K and V have a ring each.
constexpr int F32_WARPS = 8;       // warps a CTA
constexpr int F32_BK = 64;         // keys a K / V slot, d <= 128
constexpr int F32_BK_WIDE = 32;    // keys a K / V slot, 128 < d <= 256
constexpr int F32_SLOTS = 2;       // slots a ring

template <int DQK, int DV>
struct F32Smem {
  static constexpr int RG = 2, CG = 16;          // a warp's lane groups
  static constexpr int MR = DQK > 128 ? 4 : 8;   // query rows a lane
  static constexpr int WR = RG * MR;             // query rows a warp
  static constexpr int BQ = F32_WARPS * WR;      // query rows a CTA
  static constexpr int THREADS = 32 * F32_WARPS;
  static constexpr int BK = DQK > 128 ? F32_BK_WIDE : F32_BK;
  static constexpr int SLOTS = F32_SLOTS;
  static constexpr int DVP = DV < 4 * CG ? 4 * CG : DV;   // V as staged
  static constexpr int KJ = BK / CG;             // S columns a lane
  static constexpr int OJ = DVP / (4 * CG);      // O float4 columns a lane
  // A warp reads two rows of Q and of P at one column (a broadcast to
  // each half-warp) and runs of a V row, so those are unpadded (padding
  // them measured no faster, and at d = 128 it would not fit); it reads
  // 16 rows of K, 4 floats longer than DQK so that 8 rows begin in
  // distinct banks.
  static constexpr int LDQ = DQK, LDK = DQK + 4, LDV = DVP, LDP = BK;
  static constexpr int K_OFF = BQ * LDQ;                   // floats
  static constexpr int V_OFF = K_OFF + SLOTS * BK * LDK;
  static constexpr int P_OFF = V_OFF + SLOTS * BK * LDV;
  static constexpr int BYTES = 4 * (P_OFF + BQ * LDP);
  static_assert(KJ >= 1 && OJ >= 1, "a tile narrower than the lanes");
  static_assert(BYTES <= 232448, "over the 227 KB of shared memory");
};

// KV tile kt (K and V) into ring slot `slot`.
template <int DQK, int DV>
__device__ __forceinline__ void f32_stage_kv(float* k_s, float* v_s,
                                             int slot, const float* kb,
                                             const float* vb, int kt, int tk,
                                             int d, int dv, bool vec) {
  using L = F32Smem<DQK, DV>;
  f32_stage<L::BK, DQK, L::LDK, L::THREADS>(
      k_s + slot * L::BK * L::LDK, kb, kt * L::BK, tk, 0, d, vec);
  f32_stage<L::BK, L::DVP, L::LDV, L::THREADS>(
      v_s + slot * L::BK * L::LDV, vb, kt * L::BK, tk, 0, dv, vec);
}

template <int DQK, int DV, typename OutT>
__global__ void __launch_bounds__(F32Smem<DQK, DV>::THREADS, 1)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, OutT* __restrict__ out,
                 int tq, int tk, int d, int dv, int causal, int window,
                 int group, float scale, int vec_in, int vec_out) {
  using L = F32Smem<DQK, DV>;
  constexpr int RG = L::RG, CG = L::CG, MR = L::MR, WR = L::WR, KB = L::BK;
  constexpr int KJ = L::KJ, OJ = L::OJ, SL = L::SLOTS;
  extern __shared__ float4 f32_smem[];
  float* q_s = reinterpret_cast<float*>(f32_smem);   // [BQ][LDQ]
  float* k_s = q_s + L::K_OFF;                       // SL x [BK][LDK]
  float* v_s = q_s + L::V_OFF;                       // SL x [BK][LDV]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane / CG, cg = lane % CG;
  float* p_s = q_s + L::P_OFF + warp * WR * L::LDP;  // the warp's P
  const int q0 = (gridDim.y - 1 - blockIdx.y) * L::BQ;   // heaviest first
  const int wq0 = q0 + warp * WR;                    // the warp's first row
  const long long bh = blockIdx.x;
  const long long bkv = (int)blockIdx.x / group;     // grouped KV heads
  const float* kb = k + bkv * tk * d;
  const float* vb = v + bkv * tk * dv;
  const bool vec = vec_in != 0;
  const int kt0 = kv_tile_begin(q0, window, KB);
  const int n_kt = kv_tile_end(q0, L::BQ, KB, tk, causal);

  // Q rides in the first group of copies, with the first KV tiles.
  f32_stage<L::BQ, DQK, L::LDQ, L::THREADS>(q_s, q + bh * tq * d, q0, tq, 0,
                                            d, vec);
  constexpr int AHEAD = SL > 1 ? SL - 1 : 1;
  for (int t = 0; t < AHEAD; ++t) {
    if (kt0 + t < n_kt)
      f32_stage_kv<DQK, DV>(k_s, v_s, t, kb, vb, kt0 + t, tk, d, dv, vec);
    cp_async_commit();
  }

  float m[MR], l[MR], o[MR][4 * OJ];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * OJ; ++c) o[i][c] = 0.0f;
  }
  const float sl2 = LOG2E * scale;   // scores into the exp2 domain
  const int dq = (d + 3) & ~3;       // Q.K^T's depth: zero past d

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int it = kt - kt0, slot = it % SL;
    cp_async_wait<(SL > 1 ? SL - 2 : 0)>();
    __syncthreads();   // tile kt landed for every thread; tile kt - 1 read
    if constexpr (SL > 1) {
      if (kt + SL - 1 < n_kt)
        f32_stage_kv<DQK, DV>(k_s, v_s, (it + SL - 1) % SL, kb, vb,
                              kt + SL - 1, tk, d, dv, vec);
      cp_async_commit();
    }
    const int k0 = kt * KB;
    // A tile whose every key is masked for every row of the warp leaves
    // its m, l and O as they are: the warp skips it.
    if (!((causal && k0 > wq0 + WR - 1) ||
          (window > 0 && wq0 - (k0 + KB - 1) >= window))) {
      float s[MR][KJ];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
      const float* qr = q_s + (warp * WR + rg) * L::LDQ;
      const float* kr = k_s + slot * KB * L::LDK + cg * L::LDK;
#pragma unroll 2
      for (int c = 0; c < dq; c += 4) {
        float4 a[MR], b[KJ];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          a[i] = *reinterpret_cast<const float4*>(qr + RG * i * L::LDQ + c);
#pragma unroll
        for (int j = 0; j < KJ; ++j)
          b[j] = *reinterpret_cast<const float4*>(kr + CG * j * L::LDK + c);
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            float x = s[i][j];
            x = fmaf(a[i].x, b[j].x, x);
            x = fmaf(a[i].y, b[j].y, x);
            x = fmaf(a[i].z, b[j].z, x);
            x = fmaf(a[i].w, b[j].w, x);
            s[i][j] = x;
          }
      }
      // The mask, only on a tile that holds a key masked for some row of
      // the warp: the causal diagonal, the window's lower edge, the ragged
      // end of Tk.
      if ((causal && k0 + KB - 1 > wq0) || k0 + KB > tk ||
          (window > 0 && wq0 + WR - 1 - k0 >= window)) {
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const int qpos = wq0 + rg + RG * i;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const int kpos = k0 + cg + CG * j;
            if (kpos >= tk || (causal && kpos > qpos) ||
                (window > 0 && qpos - kpos >= window))
              s[i][j] = -INFINITY;
          }
        }
      }
      // The recurrence: the max on the raw scores over the CG lanes of a
      // row (a fixed xor tree), the scale folded into exp2's fma; l holds
      // this lane's part of the row sum.
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
        for (int off = CG / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float mn = fmaxf(m[i], mx * sl2);
        const float alpha = exp2f(m[i] - mn);   // 1 where the max held
        m[i] = mn;
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float p = exp2f(fmaf(s[i][j], sl2, -mn));   // masked: 0
          p_s[(rg + RG * i) * L::LDP + cg + CG * j] = p;
          rs += p;
        }
        l[i] = l[i] * alpha + rs;
#pragma unroll
        for (int c = 0; c < 4 * OJ; ++c) o[i][c] *= alpha;
      }
      __syncwarp();    // the warp's P rows written
      // O += P.V: a float4 of P (4 keys of a row) a row and, per key, a
      // float4 of V per column chunk.
      const float* pr = p_s + rg * L::LDP;
      const float* vr = v_s + slot * KB * L::LDV + 4 * cg;
#pragma unroll 2
      for (int kk = 0; kk < KB; kk += 4) {
        float4 pa[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          pa[i] = *reinterpret_cast<const float4*>(pr + RG * i * L::LDP + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vrow = vr + (kk + u) * L::LDV;
#pragma unroll
          for (int jj = 0; jj < OJ; ++jj) {
            const float4 b =
                *reinterpret_cast<const float4*>(vrow + 4 * CG * jj);
#pragma unroll
            for (int i = 0; i < MR; ++i) {
              const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                            : u == 2 ? pa[i].z : pa[i].w;
              o[i][4 * jj] = fmaf(p, b.x, o[i][4 * jj]);
              o[i][4 * jj + 1] = fmaf(p, b.y, o[i][4 * jj + 1]);
              o[i][4 * jj + 2] = fmaf(p, b.z, o[i][4 * jj + 2]);
              o[i][4 * jj + 3] = fmaf(p, b.w, o[i][4 * jj + 3]);
            }
          }
        }
      }
    }
    if constexpr (SL == 1) {   // one slot: the next tile loads after this
      __syncthreads();
      if (kt + 1 < n_kt)
        f32_stage_kv<DQK, DV>(k_s, v_s, 0, kb, vb, kt + 1, tk, d, dv, vec);
      cp_async_commit();
    }
  }

  // Row sums over the CG lanes of a row (a fixed xor tree), then 1 / l.
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int off = CG / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(FULL, l[i], off);
  OutT* ob = out + bh * tq * dv;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = wq0 + rg + RG * i;
    if (r >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < OJ; ++jj) {
      const int c = 4 * (cg + CG * jj);
      if (c < dv)
        store4(ob + (long long)r * dv + c, c, dv, vec_out != 0,
               make_float4(o[i][4 * jj] * inv, o[i][4 * jj + 1] * inv,
                           o[i][4 * jj + 2] * inv, o[i][4 * jj + 3] * inv));
    }
  }
}

// 256 < d <= 576 and dv <= 512: one pass, O split by columns.  A CTA owns
// 64 query rows; its two halves (warps 0-3 and 4-7) each form S over their
// half of every K piece (DC columns), swap the partials through shared
// memory and sum them, so both hold the same S, m and l; each accumulates
// half of O's 64-column chunks (2t + h for half h).  Lane (rg, cg) of a
// half (rg < 8, cg < 16) owns rows rg + 8 i (i < 8), S columns cg + 16 j
// (j < KJ) and, in its chunks, columns 4 cg .. 4 cg + 3: a step of Q.K^T
// reads 8 float4 of Q and 4 of K for 128 FMAs, one of P.V a float4 of V
// for 32.  Q stays in shared memory for the whole walk; K (in pieces of
// BK keys x DC columns) and V (in pieces of VK keys, 512 columns) stream
// through one ring of slots.
//
// Past one CTA's reach (d > 576 or dv > 512) the same CTA runs as rank r of
// a cluster of C = min(8, ceil(d / 512)) sharing a (head, query tile), as
// the bf16 body does: rank r's halves form partial S over the r-th slice
// of d's 64-column pieces and sum them (S_r), each half sums its rows of
// S_0 + ... + S_{C-1} in rank order, the peers' through distributed shared
// memory (a ring of F32SP_XSLOTS slots, each with its written / read
// barriers), the halves swap, and each CTA holds and stores its own slice
// of O (at most 512 columns).  Q is not
// resident there: each K piece's slot also holds the 64 x 64 Q piece it
// meets, so a slice may be any width (no rounds past C = 8).  dv past
// 4,096 runs as column slabs of 4,096, one launch each.
constexpr int F32SP_THREADS = 256;
constexpr int F32SP_BQ = 64;          // query rows a CTA
constexpr int F32SP_BK = 64;          // keys a tile
constexpr int F32SP_DC = 64;          // Q.K^T columns a K piece
constexpr int F32SP_VK = 8;           // keys a V piece
constexpr int F32SP_SLOTS = 2;        // slots of the ring of pieces
constexpr int F32SP_DQK = 576;        // the reach: d <= 576,
constexpr int F32SP_DV = 512;         //            dv <= 512
constexpr int F32SP_XSLOTS = 2;       // a cluster's partial-S slots a CTA

// CL: a rank of a cluster (Q streamed with K, partial slots and their
// barriers, P in a buffer of its own); else one CTA (Q resident, P in the
// half's partial buffer).
template <bool CL>
struct F32SpSmem {
  static constexpr int KJ = F32SP_BK / 16;    // S columns a lane
  static constexpr int LDK = F32SP_DC + 4;    // a K (or Q) piece row
  static constexpr int LDQ = CL ? LDK : F32SP_DQK + 4;   // a Q row (floats)
  static constexpr int LDV = F32SP_DV;        // a V piece row
  static constexpr int LDX = F32SP_BK + 4;    // a partial-S / P row
  static constexpr int XS = CL ? F32SP_XSLOTS : 0;      // cluster slots
  static constexpr int KQ = (CL ? 2 : 1) * F32SP_BK * LDK;   // K (+ Q)
  static constexpr int Q_PIECE = F32SP_BK * LDK;   // Q's offset in a slot
  static constexpr int SLOT = KQ > F32SP_VK * LDV ? KQ : F32SP_VK * LDV;
  // A half's partial S, [64][LDX] (in a cluster float4 [8][128
  // threads]), the halves' two; then a cluster's slots of the CTA's S_r.
  static constexpr int X_PART = CL ? 8 * 128 * 4 : F32SP_BQ * LDX;
  static constexpr int X_OFF = CL ? 0 : F32SP_BQ * LDQ;     // floats
  static constexpr int XC_OFF = X_OFF + 2 * X_PART;
  static constexpr int P_OFF = XC_OFF + XS * X_PART;
  static constexpr int RING_OFF = P_OFF + (CL ? F32SP_BQ * LDX : 0);
  static constexpr int BARS = RING_OFF + F32SP_SLOTS * SLOT;
  // Barriers (CL, 8 bytes each, from BARS): written X[XS], read X[XS].
  static constexpr int BYTES = 4 * BARS + (CL ? 16 * XS : 0);
  static_assert(F32SP_BK % F32SP_VK == 0 && F32SP_VK % 4 == 0, "pieces");
  static_assert(F32SP_BQ == F32SP_BK, "a Q piece fills a K piece's rows");
  static_assert(BYTES <= 232448, "over the 227 KB of shared memory");
};

// The cluster's exchange of tile step `step`, as the bf16 body's
// cl_exchange (below): the CTA's two halves' partials summed in shared
// memory (S_r; a lane's S as float4 [8][128 threads]: no bank conflict),
// then cl_gather on slot step % XS, half h summing rows 4 h .. 4 h + 3
// of a lane's 8 over the cluster; the halves swap their sums, and threads
// 0 .. C - 1 arrive on every CTA's "read" barrier of the slot.  Every
// thread of the cluster holding an element then holds the same bits of
// S = S_0 + ... + S_{C-1}.  `xl` holds the halves' two local buffers,
// `xc` the slots.
template <int XS>
__device__ __forceinline__ void f32_cl_exchange(
    float (&s)[8][F32SP_BK / 16], float* xl, float* xc, uint32_t x_full,
    uint32_t x_empty, int h, int tid, int rank, int nc, int step) {
  static_assert(F32SP_BK / 16 == 4, "a float4 a row of a lane's S");
  constexpr int X_PART = 8 * 128 * 4;     // floats: one S as float4s
  float4* mine = reinterpret_cast<float4*>(xl + h * X_PART) + tid;
  const float4* other =
      reinterpret_cast<const float4*>(xl + (1 - h) * X_PART) + tid;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    mine[128 * i] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  __syncthreads();   // both partials written
#pragma unroll
  for (int i = 0; i < 8; ++i)
    ld_own4<true>(s[i][0], s[i][1], s[i][2], s[i][3],
                  smem_u32(other + 128 * i));
  const int slot = step % XS, use = step / XS;
  // Its CTA barrier (all 256 threads) also orders every read of `other`
  // before the swap below overwrites it.
  cl_gather<4, 0, F32SP_THREADS>(
      reinterpret_cast<float (&)[32]>(s),
      reinterpret_cast<float4*>(xc + slot * X_PART) + tid, x_full, x_empty,
      slot, use, h, rank, nc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i / 4 == h)
      mine[128 * (i % 4)] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  __syncthreads();   // both halves' sums written, every peer read done
  cl_arrive_all(x_empty + 8 * slot, nc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i / 4 != h) {
      const float4 x = other[128 * (i % 4)];
      s[i][0] = x.x;
      s[i][1] = x.y;
      s[i][2] = x.z;
      s[i][3] = x.w;
    }
  }
}

template <typename OutT, bool CL>
__global__ void __launch_bounds__(F32SP_THREADS, 1)
flash_f32_sp_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, OutT* __restrict__ out,
                    int tq, int tk, int d, int dv, int causal, int window,
                    int group, float scale, int vec_in, int vec_out,
                    int vs0, int dvs) {
  using L = F32SpSmem<CL>;
  constexpr int KB = F32SP_BK, VK = F32SP_VK, SL = F32SP_SLOTS;
  constexpr int DC = F32SP_DC, HC = F32SP_DC / 2, KJ = L::KJ;
  constexpr int NVP = KB / VK;          // V pieces a tile
  constexpr int OT = F32SP_DV / 128;    // O chunks of 64 columns a half
  extern __shared__ float4 f32sp_smem[];
  float* q_s = reinterpret_cast<float*>(f32sp_smem);   // [64][LDQ]
  float* x_s = q_s + L::X_OFF;                         // the partials
  float* ring = q_s + L::RING_OFF;                     // SL x SLOT
  const uint32_t x_full = smem_u32(q_s + L::BARS);     // CL: XS each
  const uint32_t x_empty = x_full + 8 * L::XS;
  const int h = threadIdx.x >> 7;                      // the half
  const int rg = (threadIdx.x & 127) >> 4, cg = threadIdx.x & 15;
  float* x_mine = x_s + h * F32SP_BQ * L::LDX;
  const float* x_other = x_s + (1 - h) * F32SP_BQ * L::LDX;
  float* p_s = CL ? q_s + L::P_OFF : x_mine;           // P: [64][LDX]
  const int nc = CL ? cluster_nctarank() : 1;
  // The rank's slice; in a cluster worked out afresh where it is used
  // (the rank's special register read again), since no register is left
  // to keep it across the walk.
  auto slice = [&]() {
    return make_slice<CL ? 1 : 0>(CL ? cluster_ctarank() : 0,
                                  CL ? cluster_nctarank() : 1, d, dv, vs0,
                                  dvs);
  };
  const Slice sl = slice();
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F32SP_BQ;   // heaviest first
  const long long bh = (int)blockIdx.x / nc;
  const long long bkv = bh / group;
  const float* qb = q + bh * tq * d;
  const float* kb = k + bkv * tk * d;
  const float* vb = v + bkv * tk * dv;
  const bool vec = vec_in != 0;
  const int kt0 = kv_tile_begin(q0, window, KB);
  const int n_kt = kv_tile_end(q0, F32SP_BQ, KB, tk, causal);
  const int nkp = sl.np_q;              // K pieces a tile (of the slice)
  const int ppt = nkp + NVP;            // pieces a tile
  const int n_pc = (n_kt - kt0) * ppt;
  if constexpr (CL) {
    if (threadIdx.x == 0) {
      for (int b = 0; b < 2 * L::XS; ++b)   // one arrival a CTA
        mbar_init(x_full + 8 * b, nc);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster_sync();   // every CTA's barriers set before a peer arrives
  }

  // Piece pc of the walk (tile kt0 + pc / ppt: its K pieces, with their Q
  // pieces in a cluster, then its V pieces) into its slot; one group of
  // copies a piece, empty past the end.
  auto issue = [&](int pc) {
    if (pc < n_pc) {
      const int kt = kt0 + pc / ppt, st = pc % ppt;
      float* dst = ring + (pc % SL) * L::SLOT;
      // In a cluster no register is left to keep the copies' addresses
      // across the walk: the bases are made opaque here, so they are
      // worked out afresh each piece.
      const float *kp = kb, *qp = qb, *vp = vb;
      if constexpr (CL)
        asm volatile("" : "+l"(kp), "+l"(qp), "+l"(vp));
      const Slice sc = slice();
      if (st < nkp) {
        f32_stage<KB, DC, L::LDK, F32SP_THREADS>(dst, kp, kt * KB, tk,
                                                 sc.qc0 + st * DC, d, vec);
        if constexpr (CL)
          f32_stage<F32SP_BQ, DC, L::LDK, F32SP_THREADS>(
              dst + L::Q_PIECE, qp, q0, tq, sc.qc0 + st * DC, d, vec);
      } else {
        f32_stage<VK, F32SP_DV, L::LDV, F32SP_THREADS>(
            dst, vp, kt * KB + (st - nkp) * VK, tk, sc.v0, dv, vec);
      }
    }
    cp_async_commit();
  };
  if constexpr (!CL)
    f32_stage<F32SP_BQ, F32SP_DQK, L::LDQ, F32SP_THREADS>(
        q_s, qb, q0, tq, 0, d, vec);    // Q: in the first group
  constexpr int AHEAD = SL > 1 ? SL - 1 : 1;
  for (int t = 0; t < AHEAD; ++t) issue(t);

  float m[8], l[8], s[8][KJ], o[8][4 * OT];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * OT; ++c) o[i][c] = 0.0f;
  }
  const float sl2 = LOG2E * scale;   // scores into the exp2 domain

  for (int pc = 0; pc < n_pc; ++pc) {
    const int st = pc % ppt, k0 = (kt0 + pc / ppt) * KB;
    const float* sp = ring + (pc % SL) * L::SLOT;
    cp_async_wait<(SL > 1 ? SL - 2 : 0)>();
    __syncthreads();   // piece pc landed for every thread; pc - 1 read
    if constexpr (SL > 1) issue(pc + SL - 1);
    if (st < nkp) {
      if (st == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
      }
      if (slice().qc0 + st * DC + HC * h < d) {   // this half's: some
        const float* qr = CL ? sp + L::Q_PIECE + rg * L::LDQ + HC * h
                             : q_s + rg * L::LDQ + st * DC + HC * h;
        const float* kr = sp + cg * L::LDK + HC * h;
        if constexpr (CL) {
          // A cluster's exchange and slice leave fewer registers than one
          // CTA has: one step at a time, Q's rows in two batches of 4
          // (each S element's FMAs in the same order).
#pragma unroll 1
          for (int c = 0; c < HC; c += 4) {
            float4 b[KJ];
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              b[j] = *reinterpret_cast<const float4*>(kr + 16 * j * L::LDK +
                                                      c);
#pragma unroll
            for (int i0 = 0; i0 < 8; i0 += 4) {
              float4 a[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                a[i] = *reinterpret_cast<const float4*>(
                    qr + 8 * (i0 + i) * L::LDQ + c);
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < KJ; ++j) {
                  float x = s[i0 + i][j];
                  x = fmaf(a[i].x, b[j].x, x);
                  x = fmaf(a[i].y, b[j].y, x);
                  x = fmaf(a[i].z, b[j].z, x);
                  x = fmaf(a[i].w, b[j].w, x);
                  s[i0 + i][j] = x;
                }
            }
          }
        } else {
#pragma unroll 2
          for (int c = 0; c < HC; c += 4) {
            float4 a[8], b[KJ];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              a[i] = *reinterpret_cast<const float4*>(qr + 8 * i * L::LDQ +
                                                      c);
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              b[j] = *reinterpret_cast<const float4*>(kr + 16 * j * L::LDK +
                                                      c);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < KJ; ++j) {
                float x = s[i][j];
                x = fmaf(a[i].x, b[j].x, x);
                x = fmaf(a[i].y, b[j].y, x);
                x = fmaf(a[i].z, b[j].z, x);
                x = fmaf(a[i].w, b[j].w, x);
                s[i][j] = x;
              }
          }
        }
      }
      if (st == nkp - 1) {
        if constexpr (CL) {
          const Slice sx = slice();
          f32_cl_exchange<L::XS>(s, x_s, q_s + L::XC_OFF, x_full, x_empty,
                                 h, threadIdx.x & 127, sx.rank, sx.nc,
                                 pc / ppt);
        } else {
          // The halves' partial S swapped and summed: fp32 addition
          // commutes, so both halves hold the same bits.
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              x_mine[(rg + 8 * i) * L::LDX + cg + 16 * j] = s[i][j];
          __syncthreads();   // both partials written
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < KJ; ++j)
              s[i][j] += x_other[(rg + 8 * i) * L::LDX + cg + 16 * j];
          __syncthreads();   // both read: x_mine takes this half's P
        }
        if ((causal && k0 + KB - 1 > q0) || k0 + KB > tk ||
            (window > 0 && q0 + F32SP_BQ - 1 - k0 >= window)) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int qpos = q0 + rg + 8 * i;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
              const int kpos = k0 + cg + 16 * j;
              if (kpos >= tk || (causal && kpos > qpos) ||
                  (window > 0 && qpos - kpos >= window))
                s[i][j] = -INFINITY;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mx = s[i][0];
#pragma unroll
          for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
          const float mn = fmaxf(m[i], mx * sl2);
          const float alpha = exp2f(m[i] - mn);   // 1 where the max held
          m[i] = mn;
          float rs = 0.0f;
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            const float p = exp2f(fmaf(s[i][j], sl2, -mn));   // masked: 0
            // In a cluster the halves share one P: each writes half of it.
            if (!CL || i / 4 == h)
              p_s[(rg + 8 * i) * L::LDX + cg + 16 * j] = p;
            rs += p;
          }
          l[i] = l[i] * alpha + rs;
#pragma unroll
          for (int c = 0; c < 4 * OT; ++c) o[i][c] *= alpha;
        }
      }
    } else {
      // O += P[:, this piece's keys] . V, this half's chunks below dv.
      const float* pr = p_s + rg * L::LDX + (st - nkp) * VK;
      const Slice sv = slice();
      const int v_cols = sv.vend - sv.v0;     // this rank's columns of O
      const float* vr = sp + 4 * cg + 64 * h;
#pragma unroll
      for (int kk = 0; kk < VK; kk += 4) {
        float4 pa[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pa[i] = *reinterpret_cast<const float4*>(pr + 8 * i * L::LDX + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vrow = vr + (kk + u) * L::LDV;
#pragma unroll
          for (int t = 0; t < OT; ++t) {
            if (128 * t + 64 * h >= v_cols) continue;
            const float4 b = *reinterpret_cast<const float4*>(vrow + 128 * t);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                            : u == 2 ? pa[i].z : pa[i].w;
              o[i][4 * t] = fmaf(p, b.x, o[i][4 * t]);
              o[i][4 * t + 1] = fmaf(p, b.y, o[i][4 * t + 1]);
              o[i][4 * t + 2] = fmaf(p, b.z, o[i][4 * t + 2]);
              o[i][4 * t + 3] = fmaf(p, b.w, o[i][4 * t + 3]);
            }
          }
        }
      }
    }
    if constexpr (SL == 1) {   // one slot: the next piece loads after this
      __syncthreads();
      issue(pc + 1);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(FULL, l[i], off);
  OutT* ob = out + bh * tq * dv;
  const Slice so = slice();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + rg + 8 * i;
    if (r >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      const int c = so.v0 + 128 * t + 64 * h + 4 * cg;
      if (c < so.vend)
        store4(ob + (long long)r * dv + c, c, dv, vec_out != 0,
               make_float4(o[i][4 * t] * inv, o[i][4 * t + 1] * inv,
                           o[i][4 * t + 2] * inv, o[i][4 * t + 3] * inv));
    }
  }
  // No CTA leaves while a peer may still read its partial slots.
  if constexpr (CL) cluster_sync();
}

// ------------------------------------------------------------------------ //
// bf16: wgmma and TMA helpers of the tensor-core bodies.
// ------------------------------------------------------------------------ //

// Byte offset of the 16-byte chunk holding columns c .. c+7 of row r, in
// 64-column panels of `panel` bytes with the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int c, int panel) {
  return (c >> 6) * panel + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}
// Shared-memory writes of the generic proxy (st.shared) made visible to
// wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Every committed wgmma group but the last one has completed.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Registers that an in-flight wgmma writes: reads of them may not be moved
// above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// operand the stride byte offset (sbo) steps 8 rows and the leading byte
// offset is unused; for an MN-major operand lbo steps one 64-column panel
// along MN and sbo 8 rows along K.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

// D (+)= A.B for a 64 x 128 tile, depth 16: A and B from shared memory
// (both K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A.B for a 64 x 32 tile, depth 16: A and B from shared memory
// (both K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A.B for a 64 x 64 tile, depth 16: A and B from shared memory
// (both K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A.B for a 64 x 64 tile, depth 16: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (MN-major, 128-byte swizzle: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (+)= A.B for a 64 x 128 tile, depth 16: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (MN-major, 128-byte swizzle: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (+)= A.B for a 64 x 256 tile, depth 16: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (MN-major, 128-byte swizzle: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (+)= A.B for a 64 x 192 tile, depth 16: A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (MN-major, 128-byte swizzle: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int BQ_, int BK_>
__device__ __forceinline__ int wg_kv_tiles(int q0, int tk, int causal) {
  // Keys after the CTA's last query row are masked for every row.
  const int end = causal ? min(tk, q0 + BQ_) : tk;
  return (end + BK_ - 1) / BK_;
}

// ------------------------------------------------------------------------ //
// bf16, d <= 256: warp-specialised, two or three consumer warpgroups.
// ------------------------------------------------------------------------ //
// Registers a thread after the roles part (setmaxnreg) with two consumer
// warpgroups: the launch gives 168 to each of 384 threads; the producer
// warpgroup hands 128 of them back, the two consumer warpgroups take 64
// more: 40 x 128 + 232 x 256 = 168 x 384.
constexpr int WS_PRODUCER_REGS = 40;
constexpr int WS_CONSUMER_REGS = 232;
// Consumer warpgroups at DQK = 64: three (192 query rows a CTA), since a
// thread's O, S and P there fit the 160 registers three leave it.
constexpr int WS_NWG_DQK64 = 3;
// CTAs walk the query heads in groups of 8, a group's query tiles
// heaviest first and its heads fastest, so the CTAs of a wave share the K
// and V of a few heads through L2 (heads fastest over all BH would give
// each CTA of a wave a head of its own, re-read from device memory).  The
// warp-specialised body runs heads fastest over all BH (the query tiles
// heaviest first over the whole grid, which balances a causal grid's
// tail) where the K and V of all heads take at most a third of the 50 MB
// L2.
constexpr int WS_HEAD_GROUP = 8;
constexpr long long WS_ALL_HEADS_KV_BYTES = 16ll << 20;
constexpr int WS_CONSUMERS = 256;        // two consumer warpgroups
constexpr int WS_THREADS = WS_CONSUMERS + 128;

template <int DQK, int DV>
struct WsSmem {
  static_assert(DQK == 64 || DQK == 128 || DQK == 192 || DQK == 256,
                "DQK is 64, 128, 192 or 256");
  static_assert(DV == DQK || (DV == 128 && DQK > 128),
                "DV is DQK, or 128 past DQK = 128");
  static constexpr int NQ = DQK / 64;           // Q / K panels
  static constexpr int NV = DV / 64;            // V panels
  static constexpr int KS = DQK / 16;           // k-steps of Q.K^T
  // Consumer warpgroups of 64 query rows, and the launch's threads.
  static constexpr int NWG = DQK == 64 ? WS_NWG_DQK64 : 2;
  static constexpr int BQ = 64 * NWG;           // query rows a CTA
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;
  // setmaxnreg: the launch gives 65536 / THREADS registers a thread; the
  // producer keeps 40 of 168 at two consumer warpgroups, 24 of 128 at
  // three (24 x 128 + 160 x 384 = 64,512), the consumers the rest.
  static constexpr int PRODUCER_REGS = NWG == 2 ? WS_PRODUCER_REGS : 24;
  static constexpr int CONSUMER_REGS = NWG == 2 ? WS_CONSUMER_REGS : 160;
  // Keys per K / V slot: 128 where two slots of each fit beside Q.
  static constexpr int BK = DQK + DV <= 320 ? 128 : 64;
  static constexpr int SLOTS = 2;               // slots of the K and V rings
  static constexpr int Q_PANEL = BQ * 128;      // bytes: BQ rows of 128 B
  static constexpr int KV_PANEL = BK * 128;     // bytes: BK rows of 128 B
  static constexpr int K_SLOT = NQ * KV_PANEL;
  static constexpr int V_SLOT = NV * KV_PANEL;
  static constexpr int K_OFF = NQ * Q_PANEL;    // Q, the K slots, the V's
  static constexpr int V_OFF = K_OFF + SLOTS * K_SLOT;
  static constexpr int BARS = V_OFF + SLOTS * V_SLOT;
  // Barriers (8 bytes each, from BARS): full K[SLOTS], full V[SLOTS],
  // empty K[SLOTS], empty V[SLOTS], Q; + 1 KB to align the base to the
  // 1 KB swizzle period.
  static constexpr int FULL_K = 0, FULL_V = 8 * SLOTS;
  static constexpr int EMPTY_K = 16 * SLOTS, EMPTY_V = 24 * SLOTS;
  static constexpr int Q_BAR = 32 * SLOTS;
  static constexpr int BYTES = BARS + Q_BAR + 8 + 1024;
  static_assert(BYTES <= 232448, "227 KB of shared memory a block");
};

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// Named barriers 1 .. NWG (0 is __syncthreads'), each over 256 threads:
// consumer warpgroup w waits on barrier 1 + w, and the warpgroup before it
// in turn arrives on it.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WS_CONSUMERS) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WS_CONSUMERS)
               : "memory");
}

// Rows [r0, r0 + ROWS) x columns [c0, c0 + 64 np) of a [n_rows, w] bf16
// matrix, zero past n_rows and w, by the producer warpgroup's 128 threads
// (pt = 0 .. 127) with plain loads into 128-byte-swizzled panels of
// `panel` bytes: the layout TMA writes.
template <int ROWS>
__device__ __forceinline__ void ws_stage(uint8_t* dst,
                                         const __nv_bfloat16* src, int r0,
                                         int n_rows, int w, int np,
                                         int panel, int pt, int c0 = 0) {
  const int cpr = 8 * np;                       // 16-byte chunks a row
  for (int e = pt; e < ROWS * cpr; e += 128) {
    const int r = e / cpr, c = (e % cpr) * 8;
    const int gr = r0 + r;
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = (gr < n_rows && c0 + c + i < w)
                 ? src[(long long)gr * w + c0 + c + i]
                 : __float2bfloat16(0.0f);
    *reinterpret_cast<uint4*>(dst + swz(r, c, panel)) =
        *reinterpret_cast<uint4*>(h);
  }
}

// The producer warpgroup: Q once, then K and V of tiles kt0 .. n_kt - 1
// into their rings (tile step s in slot s % SLOTS).  With TMA one thread issues every copy (the
// hardware zero-fills past Tq, Tk, d and dv; V only in the panels that
// hold a column below dv); otherwise the four warps stage with plain
// loads and each arrives on the barrier it filled.  A K slot is refilled
// once both consumer warpgroups' Q.K^T of it has completed, a V slot
// once their P.V has.
template <int DQK, int DV>
__device__ __forceinline__ void ws_produce(
    uint8_t* smem, uint32_t bars, bool tma, const __nv_bfloat16* qb,
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, int q0, int tq,
    int tk, int d, int dv, int kt0, int n_kt, int bh, int bkv,
    const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap) {
  using L = WsSmem<DQK, DV>;
  constexpr int SL = L::SLOTS;
  const int pt = threadIdx.x - L::CONSUMERS, lane = threadIdx.x & 31;
  const uint32_t full_k = bars + L::FULL_K, full_v = bars + L::FULL_V;
  const uint32_t empty_k = bars + L::EMPTY_K, empty_v = bars + L::EMPTY_V;
  const uint32_t qbar = bars + L::Q_BAR;
  const int np_v = (dv + 63) / 64;
  if (tma) {
    if (pt != 0) return;
    mbar_expect_tx(qbar, L::NQ * L::Q_PANEL);
    for (int p = 0; p < L::NQ; ++p)
      tma_load_3d(smem_u32(smem + p * L::Q_PANEL), qmap, qbar, 64 * p, q0,
                  bh);
  } else {
    ws_stage<L::BQ>(smem, qb, q0, tq, d, L::NQ, L::Q_PANEL, pt);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(qbar);
  }
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int step = kt - kt0, slot = step % SL, fill = step / SL;
    const int k0 = kt * L::BK;
    uint8_t* ks = smem + L::K_OFF + slot * L::K_SLOT;
    uint8_t* vs = smem + L::V_OFF + slot * L::V_SLOT;
    // Tile step - SLOTS used these slots: wait for their release.
    if (fill > 0) mbar_wait(empty_k + 8 * slot, (fill & 1) ^ 1);
    if (tma) {
      mbar_expect_tx(full_k + 8 * slot, L::K_SLOT);
      for (int p = 0; p < L::NQ; ++p)
        tma_load_3d(smem_u32(ks + p * L::KV_PANEL), kmap, full_k + 8 * slot,
                    64 * p, k0, bkv);
    } else {
      ws_stage<L::BK>(ks, kb, k0, tk, d, L::NQ, L::KV_PANEL, pt);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full_k + 8 * slot);
    }
    if (fill > 0) mbar_wait(empty_v + 8 * slot, (fill & 1) ^ 1);
    if (tma) {
      mbar_expect_tx(full_v + 8 * slot, np_v * L::KV_PANEL);
      for (int p = 0; p < np_v; ++p)
        tma_load_3d(smem_u32(vs + p * L::KV_PANEL), vmap, full_v + 8 * slot,
                    64 * p, k0, bkv);
    } else {
      ws_stage<L::BK>(vs, vb, k0, tk, dv, np_v, L::KV_PANEL, pt);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full_v + 8 * slot);
    }
  }
}

// S = Q.K^T for this warpgroup's 64 rows and the BK keys of a K slot:
// DQK / 16 k-steps of wgmma m64n{BK}k16, both operands K-major.
template <int DQK, int DV>
__device__ __forceinline__ void ws_qk(float (&s)[WsSmem<DQK, DV>::BK / 2],
                                      uint32_t q_s, uint32_t k_s) {
  using L = WsSmem<DQK, DV>;
#pragma unroll
  for (int kq = 0; kq < L::KS; ++kq) {
    const uint32_t off = (kq >> 2) * L::Q_PANEL + (kq & 3) * 32;
    const uint64_t da = gmma_desc(q_s + off, 16, 1024);
    const uint64_t db = gmma_desc(
        k_s + (kq >> 2) * L::KV_PANEL + (kq & 3) * 32, 16, 1024);
    if constexpr (L::BK == 128)
      wgmma_ss_n128(s, da, db, kq > 0);
    else
      wgmma_ss_n64(s, da, db, kq > 0);
  }
}

// O += P.V for the BK keys of a V slot: wgmma m64n{DV}k16 with P from
// registers and V MN-major (lbo steps a 64-column panel).
template <int DQK, int DV>
__device__ __forceinline__ void ws_pv(
    float (&o)[DV / 2], uint32_t (&pa)[WsSmem<DQK, DV>::BK / 16][4],
    uint32_t v_s) {
  using L = WsSmem<DQK, DV>;
#pragma unroll
  for (int kc = 0; kc < L::BK / 16; ++kc) {
    const uint64_t vd = gmma_desc(v_s + kc * 16 * 128, L::KV_PANEL, 1024);
    if constexpr (DV == 256)
      wgmma_rs_n256(o, pa[kc], vd, 1);
    else if constexpr (DV == 192)
      wgmma_rs_n192(o, pa[kc], vd, 1);
    else if constexpr (DV == 128)
      wgmma_rs_n128(o, pa[kc], vd, 1);
    else
      wgmma_rs_n64(o, pa[kc], vd, 1);
  }
}

// One tile's online softmax for this thread's two rows (row_lo, row_hi),
// in two halves.  ws_scores: mask where a key of the tile is masked for a
// row of the warpgroup (past its first row's diagonal, at or below its
// last row's window edge, past Tk); s[4i + e] is row row_lo (e < 2) or
// row_hi, key k0 + 8i + 2 t4 + (e & 1).  A row with no key left in the
// tile keeps its max and adds 0.  The max is taken on the raw scores (the
// scale is positive) and the scale folded into the exponent's fma; s
// becomes P, and a_lo / a_hi the factors O is rescaled by.
// ws_rescale_pack: O rescaled, P rounded to bf16 as the A fragments of
// the next P.V.
template <int BK>
__device__ __forceinline__ void ws_scores(
    float (&s)[BK / 2], float& m_lo, float& m_hi, float& l_lo, float& l_hi,
    float& a_lo, float& a_hi, int k0, int wq0, int row_lo, int row_hi,
    int t4, int tk, int causal, int window, float sl2) {
  const bool masked = (causal && k0 + BK - 1 > wq0) || k0 + BK > tk ||
                      (window > 0 && wq0 + 63 - k0 >= window);
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    if (masked) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * i + 2 * t4 + (e & 1);
        const int qpos = e < 2 ? row_lo : row_hi;
        if (kpos >= tk || (causal && kpos > qpos) ||
            (window > 0 && qpos - kpos >= window))
          s[4 * i + e] = -INFINITY;
      }
    }
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(FULL, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(FULL, mx_hi, off));
  }
  const float mn_lo = fmaxf(m_lo, mx_lo * sl2);
  const float mn_hi = fmaxf(m_hi, mx_hi * sl2);
  a_lo = ex2(m_lo - mn_lo);
  a_hi = ex2(m_hi - mn_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
  float rs_lo = 0.0f, rs_hi = 0.0f;     // this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    s[4 * i] = ex2(fmaf(s[4 * i], sl2, -mn_lo));   // masked: ex2(-inf) = 0
    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl2, -mn_lo));
    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl2, -mn_hi));
    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl2, -mn_hi));
    rs_lo += s[4 * i] + s[4 * i + 1];
    rs_hi += s[4 * i + 2] + s[4 * i + 3];
  }
  l_lo = l_lo * a_lo + rs_lo;
  l_hi = l_hi * a_hi + rs_hi;
}

template <int BK, int ON>
__device__ __forceinline__ void ws_rescale_pack(const float (&s)[BK / 2],
                                                float (&o)[ON],
                                                uint32_t (&pa)[BK / 16][4],
                                                float a_lo, float a_hi) {
#pragma unroll
  for (int i = 0; i < ON / 4; ++i) {
    o[4 * i] *= a_lo;
    o[4 * i + 1] *= a_lo;
    o[4 * i + 2] *= a_hi;
    o[4 * i + 3] *= a_hi;
  }
  // The S accumulators of keys 16 kc .. 16 kc + 15 are the A fragment of
  // P.V's k-step kc.
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
    pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
    pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
    pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
  }
}

// A consumer warpgroup: 64 query rows, tiles kt0 .. n_kt - 1.  Turn j
// (one per tile, then one more) issues Q.K^T of tile j and P.V of tile
// j - 1 as two wgmma groups and passes the tensor cores to the next
// warpgroup; once Q.K^T is done it releases the K slot of j and takes
// tile j's scores (max, exponentials, sums); once P.V is done it releases
// the V slot of j - 1, rescales O and packs P.  Warpgroup 0 takes the
// first turn, then 1, ..., NWG - 1, 0, ...  The source takes the scores
// while P.V runs, but ptxas places the wait for P.V at the head of the
// softmax (to interleave the packing of P, which overwrites the registers
// P.V reads, with the exponentials), so a warpgroup's softmax overlaps
// the other warpgroups' products, not its own P.V; a second P buffer, or
// waiting a turn later, measured slower (PERF.md).
template <int DQK, int DV>
__device__ __forceinline__ void ws_consume(
    uint8_t* smem, uint32_t bars, void* out, bool out_bf16, int q0, int tq,
    int tk, int dv, int causal, int window, float scale, int kt0, int n_kt,
    int bh) {
  using L = WsSmem<DQK, DV>;
  constexpr int BK = L::BK, SL = L::SLOTS, NWG = L::NWG;
  const uint32_t full_k = bars + L::FULL_K, full_v = bars + L::FULL_V;
  const uint32_t empty_k = bars + L::EMPTY_K, empty_v = bars + L::EMPTY_V;
  const uint32_t qbar = bars + L::Q_BAR;
  const int wg = threadIdx.x >> 7;
  const int next = 1 + (wg + 1) % NWG;     // the next warpgroup's barrier
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq0 = q0 + 64 * wg;            // this warpgroup's first row
  const int row_lo = wq0 + 16 * warp + g, row_hi = row_lo + 8;
  const float sl2 = LOG2E * scale;         // scores in the exp2 domain
  const uint32_t q_s = smem_u32(smem) + wg * 64 * 128;
  const uint32_t k_s = smem_u32(smem + L::K_OFF);
  const uint32_t v_s = smem_u32(smem + L::V_OFF);
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
  float m_lo = NEG, m_hi = NEG, l_lo = 0.0f, l_hi = 0.0f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  mbar_wait(qbar, 0);
  if (kt0 < n_kt) {                        // else every row stores 0
    if (wg == NWG - 1) turn_pass(1);

    // Turn 0: Q.K^T of the first tile.
    mbar_wait(full_k, 0);
    turn_wait(1 + wg);
    wgmma_fence();
    ws_qk<DQK, DV>(s, q_s, k_s);
    wgmma_commit();
    turn_pass(next);
    wgmma_wait_all();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_k);
    float a_lo, a_hi;
    ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt0 * BK, wq0,
                  row_lo, row_hi, t4, tk, causal, window, sl2);
    ws_rescale_pack<BK, DV / 2>(s, o, pa, a_lo, a_hi);

    for (int kt = kt0 + 1; kt < n_kt; ++kt) {
      const int step = kt - kt0, slot = step % SL, prev = (step - 1) % SL;
      mbar_wait(full_k + 8 * slot, (step / SL) & 1);
      mbar_wait(full_v + 8 * prev, ((step - 1) / SL) & 1);
      turn_wait(1 + wg);
      wgmma_fence();
      ws_qk<DQK, DV>(s, q_s, k_s + slot * L::K_SLOT);
      wgmma_commit();
      ws_pv<DQK, DV>(o, pa, v_s + prev * L::V_SLOT);
      wgmma_commit();
      turn_pass(next);
      wgmma_wait_one();                  // Q.K^T done, P.V in flight
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_k + 8 * slot);
      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt * BK, wq0,
                    row_lo, row_hi, t4, tk, causal, window, sl2);
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * prev);
      ws_rescale_pack<BK, DV / 2>(s, o, pa, a_lo, a_hi);
    }

    // The last turn: P.V of the last tile.  The last warpgroup passes no
    // turn on (warpgroup 0 takes none after it), so every barrier phase
    // completes.
    const int last = n_kt - 1 - kt0;
    mbar_wait(full_v + 8 * (last % SL), (last / SL) & 1);
    turn_wait(1 + wg);
    wgmma_fence();
    ws_pv<DQK, DV>(o, pa, v_s + (last % SL) * L::V_SLOT);
    wgmma_commit();
    if (wg != NWG - 1) turn_pass(next);
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(FULL, l_lo, off);
    l_hi += __shfl_xor_sync(FULL, l_hi, off);
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  const long long ob = (long long)bh * tq * dv;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int c = 8 * i + 2 * t4;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = hi ? row_hi : row_lo;
      const float inv = hi ? inv_hi : inv_lo;
      if (r >= tq || c >= dv) continue;
      const long long at = ob + (long long)r * dv + c;
      const float x0 = o[4 * i + 2 * hi] * inv;
      const float x1 = o[4 * i + 2 * hi + 1] * inv;
      if (out_bf16)
        store_pair(static_cast<__nv_bfloat16*>(out) + at, c, dv, x0, x1);
      else
        store_pair(static_cast<float*>(out) + at, c, dv, x0, x1);
    }
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(WsSmem<DQK, DV>::THREADS, 1)
flash_bf16_ws_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, void* out,
                     int out_bf16, int tma, int tq, int tk, int d, int dv,
                     int causal, int window, int group, int head_group,
                     float scale, const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using L = WsSmem<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + L::BARS);
  // One CTA per (head, query tile) in a 1-D grid, ordered by head group.
  const int n_qt = (tq + L::BQ - 1) / L::BQ;
  const int per_group = head_group * n_qt;
  const int head0 = blockIdx.x / per_group * head_group;
  const int in_group = blockIdx.x % per_group;
  const int heads = min(head_group, (int)gridDim.x / n_qt - head0);
  const int bh = head0 + in_group % heads;
  const int q0 = (n_qt - 1 - in_group / heads) * L::BQ;
  const int bkv = bh / group;              // grouped KV heads: bh / G
  const int kt0 = kv_tile_begin(q0, window, L::BK);
  const int n_kt = wg_kv_tiles<L::BQ, L::BK>(q0, tk, causal);
  if (threadIdx.x == 0) {
    const int fills = tma ? 1 : 4;         // TMA's one thread, or 4 warps
    for (int b = 0; b < 2 * L::SLOTS; ++b)  // full K and V
      mbar_init(bars + 8 * b, fills);
    for (int b = 2 * L::SLOTS; b < 4 * L::SLOTS; ++b)  // consumer warps
      mbar_init(bars + 8 * b, 4 * L::NWG);
    mbar_init(bars + L::Q_BAR, fills);     // Q
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // V panels past dv's last are never loaded: zero them once, so P.V
  // fills O's unstored columns with 0.  (Q and K have none: DQK is the
  // first of 64, 128, 192 and 256 to hold d, so d reaches into every
  // panel of DQK.)
  const int np_v = (dv + 63) / 64;
  for (int p = np_v; p < L::NV; ++p)
    for (int slot = 0; slot < L::SLOTS; ++slot) {
      uint4* pan = reinterpret_cast<uint4*>(smem + L::V_OFF +
                                            slot * L::V_SLOT +
                                            p * L::KV_PANEL);
      for (int c = threadIdx.x; c < L::KV_PANEL / 16; c += L::THREADS)
        pan[c] = make_uint4(0, 0, 0, 0);
    }
  fence_proxy_async();
  __syncthreads();   // the last CTA-wide barrier: the roles part here

  if (threadIdx.x >= L::CONSUMERS) {
    regs_dec<L::PRODUCER_REGS>();
    ws_produce<DQK, DV>(smem, bars, tma != 0, q + (long long)bh * tq * d,
                        k + (long long)bkv * tk * d,
                        v + (long long)bkv * tk * dv, q0, tq, tk, d, dv,
                        kt0, n_kt, bh, bkv, &qmap, &kmap, &vmap);
  } else {
    regs_inc<L::CONSUMER_REGS>();
    ws_consume<DQK, DV>(smem, bars, out, out_bf16 != 0, q0, tq, tk, dv,
                        causal, window, scale, kt0, n_kt, bh);
  }
}

// ------------------------------------------------------------------------ //
// bf16 past d = 256: one pass, O split by columns; past one CTA's reach
// (d > 576 or dv > 512) spread over a cluster.
// ------------------------------------------------------------------------ //
// A CTA owns 64 query rows and all of O's columns.  64 rows of a 512-wide
// fp32 O (128 KB) fit no one warpgroup's registers, so each of two consumer
// warpgroups holds half of O's columns (at DV = 512, 128 registers a
// thread; setmaxnreg as in the body above), and the producer warpgroup
// fills Q once and two-slot rings of K and of V tiles of SP_BK keys (TMA
// from one thread, or plain loads by its four warps).  S = Q.K^T of a key
// tile is formed once: each warpgroup runs Q.K^T over its half of the
// k-steps (of d's columns), the two partial S tiles (64 x SP_BK fp32) are
// exchanged through shared memory and summed (fp32 addition commutes, so
// both warpgroups hold the same S bit for bit), and both run the same
// online max and sum on it.  P, rounded to bf16 in registers, is wgmma's A
// operand; each warpgroup runs O[:, its half] += P.V[:, its half], V
// MN-major through the transpose bit.  A warpgroup's P.V of tile j - 1 is
// issued behind its Q.K^T of tile j and runs while it exchanges and takes
// tile j's scores.  (Each warpgroup forming the whole S itself, 1.5x the
// ideal tensor work and no exchange, is `kernel_variants.py`'s whole_qk.)
//
// Past one CTA's reach the same CTA runs as one of a cluster of C =
// ceil(d / 512) (at most 8) that share a (head, query tile): rank r holds
// the r-th slice of q / k's 64-column panels (at most 512 columns: Q 64 KB)
// and of v / out's, so each CTA's warpgroups form partial S over 1 / (2C)
// of d.  A CTA sums its two partials (S_r, as in one CTA); then S = S_0 +
// S_1 + ... + S_{C-1} in that fixed order, each warpgroup summing half of
// the tile's elements over the ranks (its own S_r from registers, the
// peers' read from their shared memory with ld.shared::cluster) and the
// two swapping their halves, so every CTA holds the same S, m and l bit
// for bit and runs P.V for its own slice of O.  A CTA's S_r slots form a
// ring of SP_XSLOTS; once both warpgroups have written theirs (a named
// barrier), C threads arrive (release, cluster scope) on the slot's
// "written" barrier of every CTA; a reader waits on its own CTA's
// (acquire), sums, and once the CTA's readers are done C threads arrive
// on every CTA's "read" barrier of the slot, which a writer waits on
// before it reuses the slot, so CTAs drift by up to a tile.  A CTA reads
// each peer's S_r once (8 KB a tile): every warpgroup reading all 2C
// partials read 8x as much at C = 2 and measured slower (PERF.md).  Past C = 8 (d > 4,096) Q is not resident: each
// tile's Q.K^T runs in rounds of 8 panels, each round's Q and K loaded
// together (MODE 2), and dv past 4,096 runs as column slabs of 4,096, one
// launch each.  A CTA leaves only after every peer has passed the last
// read of its slots (a cluster barrier at the end of both roles).
constexpr int SP_PRODUCER_REGS = WS_PRODUCER_REGS;   // setmaxnreg's
constexpr int SP_CONSUMER_REGS = WS_CONSUMER_REGS;   // split, as above
constexpr int SP_BQ = 64;            // query rows a CTA
constexpr int SP_BK = 32;            // keys a K / V slot
constexpr int SP_SLOTS = 2;          // slots a ring
constexpr int SP_XSLOTS = 2;         // a cluster's partial-S slots a CTA
// Named barriers over the 256 consumer threads (0 is __syncthreads'):
// both partials of a tile written; 2 + w: warpgroup w's partial was read
// (the reader arrives, the writer waits before it writes the next).
constexpr int SP_BAR_WRITTEN = 1;
constexpr int SP_BAR_READ = 2;
// In a cluster: both warpgroups' halves of the CTA's S_r published.
constexpr int SP_BAR_PUB = 4;

// MODE 0: one CTA (d <= 576, dv <= 512); 1: a rank of a cluster, Q
// resident; 2: a rank of a cluster of 8, Q in rounds.
template <int DQK, int DV, int MODE>
struct SpSmem {
  static_assert((DQK == 512 && (DV == 256 || DV == 512)) ||
                    (DQK == 576 && DV == 512 && MODE == 0),
                "(DQK, DV) is (512, 256), (512, 512) or (576, 512)");
  static constexpr int BK = SP_BK;
  static constexpr int SLOTS = SP_SLOTS;
  static constexpr int NQ = DQK / 64;           // Q / K panels
  static constexpr int NV = DV / 64;            // V panels
  static constexpr int KS = DQK / 16;           // k-steps of the whole Q.K^T
  static constexpr int HALF = DV / 2;           // O columns a warpgroup
  static constexpr int Q_PANEL = SP_BQ * 128;   // bytes: 64 rows of 128 B
  static constexpr int KV_PANEL = BK * 128;     // bytes: BK rows of 128 B
  static constexpr int K_SLOT = NQ * KV_PANEL;
  static constexpr int V_SLOT = NV * KV_PANEL;
  static constexpr int X_WG = SP_BQ * BK * 4;   // one partial S, fp32
  static constexpr int XS = MODE == 0 ? 0 : SP_XSLOTS;   // cluster slots
  // Q, the K slots, the V slots, the two warpgroups' partial S buffers, a
  // cluster's slots of the CTA's S_r (X_WG bytes each), the barriers.
  static constexpr int K_OFF = NQ * Q_PANEL;
  static constexpr int V_OFF = K_OFF + SLOTS * K_SLOT;
  static constexpr int X_OFF = V_OFF + SLOTS * V_SLOT;
  static constexpr int XC_OFF = X_OFF + 2 * X_WG;
  static constexpr int BARS = XC_OFF + XS * X_WG;
  // Barriers (8 bytes each, from BARS): full K[SLOTS], full V[SLOTS], empty
  // K[SLOTS], empty V[SLOTS], Q; in a cluster also Q empty, written X[XS],
  // read X[XS]; + 1 KB to align the base to the 1 KB swizzle period.
  static constexpr int Q_EMPTY = 8 * (4 * SLOTS + 1);
  static constexpr int X_FULL = Q_EMPTY + 8;
  static constexpr int X_EMPTY = X_FULL + 8 * XS;
  static constexpr int NBARS = 4 * SLOTS + 1 + (MODE == 0 ? 0 : 1 + 2 * XS);
  static constexpr int BYTES = BARS + 8 * NBARS + 1024;
  static_assert(BYTES <= 232448, "227 KB of shared memory a block");
  static_assert(KS % 2 == 0 && HALF % 64 == 0, "halves of whole steps");
};

// Columns [c0, c0 + 64 np) of rows [r0, r0 + ROWS) of a [n_rows, w] bf16
// matrix by TMA (one thread) into `np` panels of `panel` bytes, completing
// `bar`'s transaction bytes, or by the producer's four warps (`pt`) with
// plain loads, each warp arriving on `bar`; zero past n_rows and w.
template <int ROWS>
__device__ __forceinline__ void sp_load(uint8_t* dst, bool tma,
                                        const CUtensorMap* map,
                                        const __nv_bfloat16* src, int r0,
                                        int n_rows, int w, int c0, int np,
                                        int panel, int head, uint32_t bar,
                                        int pt) {
  if (tma) {
    if (pt != 0) return;
    mbar_expect_tx(bar, np * panel);
    for (int p = 0; p < np; ++p)
      tma_load_3d(smem_u32(dst + p * panel), map, bar, c0 + 64 * p, r0,
                  head);
  } else {
    ws_stage<ROWS>(dst, src, r0, n_rows, w, np, panel, pt, c0);
    fence_proxy_async();
    __syncwarp();
    if ((pt & 31) == 0) mbar_arrive(bar);
  }
}

// The producer warpgroup: Q once (or a round at a time, MODE 2), then K
// and V of tiles kt0 .. n_kt - 1 into their rings, as ws_produce does,
// loading only this slice's panels that hold a column below d (Q, K) or dv
// (V): the others stay zero.  A slot is refilled once both consumer
// warpgroups have released its last use.
template <int DQK, int DV, int MODE>
__device__ __forceinline__ void sp_produce(
    uint8_t* smem, uint32_t bars, bool tma, const __nv_bfloat16* qb,
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, int q0, int tq,
    int tk, int d, int dv, int kt0, int n_kt, int bh, int bkv,
    const Slice& sl, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap) {
  using L = SpSmem<DQK, DV, MODE>;
  constexpr int SL = L::SLOTS;
  const int pt = threadIdx.x - WS_CONSUMERS;
  const uint32_t full_k = bars, full_v = bars + 8 * SL;
  const uint32_t empty_k = bars + 16 * SL, empty_v = bars + 24 * SL;
  const uint32_t qbar = bars + 32 * SL, q_empty = bars + L::Q_EMPTY;
  const int rounds = MODE == 2 ? sl.rounds : 1;
  if (tma && pt != 0) return;   // one thread issues TMA
  if constexpr (MODE != 2)
    sp_load<SP_BQ>(smem, tma, qmap, qb, q0, tq, d, sl.qc0, sl.np_q,
                   L::Q_PANEL, bh, qbar, pt);
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int step = kt - kt0, k0 = kt * L::BK;
    for (int j = 0; j < rounds; ++j) {
      // Ring step rs of K (a tile's rounds in turn); use `use - 1` of its
      // slot (step rs - SL) must be released first.
      const int rs = step * rounds + j, slot = rs % SL, use = rs / SL;
      const int c0 = sl.qc0 + 512 * j;
      if constexpr (MODE == 2) {
        if (rs > 0) mbar_wait(q_empty, (rs - 1) & 1);
        sp_load<SP_BQ>(smem, tma, qmap, qb, q0, tq, d, c0, sl.np_q,
                       L::Q_PANEL, bh, qbar, pt);
      }
      if (rs >= SL) mbar_wait(empty_k + 8 * slot, (use & 1) ^ 1);
      sp_load<L::BK>(smem + L::K_OFF + slot * L::K_SLOT, tma, kmap, kb, k0,
                     tk, d, c0, sl.np_q, L::KV_PANEL, bkv, full_k + 8 * slot,
                     pt);
    }
    const int slot = step % SL, use = step / SL;
    if (step >= SL) mbar_wait(empty_v + 8 * slot, (use & 1) ^ 1);
    sp_load<L::BK>(smem + L::V_OFF + slot * L::V_SLOT, tma, vmap, vb, k0, tk,
                   dv, sl.v0, sl.np_v, L::KV_PANEL, bkv, full_v + 8 * slot,
                   pt);
  }
}

// S (+)= Q.K^T over k-steps kq0 .. kq0 + NKQ - 1 (d's columns 16 kq0 ..)
// for the 64 query rows and the BK keys of a K slot: wgmma m64n{BK}k16,
// both operands K-major; `acc` adds to S from the first step on.
template <int DQK, int DV, int MODE, int NKQ>
__device__ __forceinline__ void sp_qk(
    float (&s)[SpSmem<DQK, DV, MODE>::BK / 2], uint32_t q_s, uint32_t k_s,
    int kq0, int acc) {
  using L = SpSmem<DQK, DV, MODE>;
#pragma unroll
  for (int i = 0; i < NKQ; ++i) {
    const int kq = kq0 + i;
    const uint64_t da = gmma_desc(
        q_s + (kq >> 2) * L::Q_PANEL + (kq & 3) * 32, 16, 1024);
    const uint64_t db = gmma_desc(
        k_s + (kq >> 2) * L::KV_PANEL + (kq & 3) * 32, 16, 1024);
    if constexpr (L::BK == 64)
      wgmma_ss_n64(s, da, db, i > 0 || acc);
    else
      wgmma_ss_n32(s, da, db, i > 0 || acc);
  }
}

// O[:, this warpgroup's half] += P.V[:, half] for the BK keys of a V slot
// (v_s at the half's first panel): wgmma m64n{DV/2}k16, P from registers,
// V MN-major (lbo steps a 64-column panel).
template <int DQK, int DV, int MODE>
__device__ __forceinline__ void sp_pv(
    float (&o)[DV / 4], uint32_t (&pa)[SpSmem<DQK, DV, MODE>::BK / 16][4],
    uint32_t v_s) {
  using L = SpSmem<DQK, DV, MODE>;
#pragma unroll
  for (int kc = 0; kc < L::BK / 16; ++kc) {
    const uint64_t db = gmma_desc(v_s + kc * 16 * 128, L::KV_PANEL, 1024);
    if constexpr (L::HALF == 256)
      wgmma_rs_n256(o, pa[kc], db, 1);
    else
      wgmma_rs_n128(o, pa[kc], db, 1);
  }
}

// This warpgroup's partial S (over its half of d) into its buffer, the
// other's read back and added: both warpgroups then hold S over all of d,
// with the same bits.  A buffer is float4 [BK / 8][128 threads] (a thread's
// float4s 2 KB apart: no bank conflict).  Before it writes, a warpgroup
// waits until the other has read its last partial (not at the first tile);
// after it reads, it says so (not at the last).
template <int BK>
__device__ __forceinline__ void sp_exchange(float (&s)[BK / 2], float4* mine,
                                            const float4* other, int wg,
                                            bool first, bool last) {
  if (!first) turn_wait(SP_BAR_READ + wg);
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
    mine[128 * i] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2],
                                s[4 * i + 3]);
  turn_wait(SP_BAR_WRITTEN);
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const float4 x = other[128 * i];
    s[4 * i] += x.x;
    s[4 * i + 1] += x.y;
    s[4 * i + 2] += x.z;
    s[4 * i + 3] += x.w;
  }
  if (!last) turn_pass(SP_BAR_READ + (wg ^ 1));
}

// The cluster's exchange of tile step `step`.  The CTA's two partials are
// summed first (sp_exchange: S_r, the same bits in both warpgroups); then
// cl_gather on the CTA's slot step % XS (float4 [BK / 8][128 threads]),
// each warpgroup publishing and summing over the cluster its half of S_r
// (float4s H wg .. H wg + H - 1 of a thread's 2H) behind named barrier
// SP_BAR_PUB; the warpgroups swap the halves they summed (sp_exchange's
// buffers and barriers), and the first warp arrives on every CTA's "read"
// barrier of the slot.  Every warpgroup of every CTA then holds S = S_0 +
// S_1 + ... + S_{C-1} with the same bits, and a CTA reads each peer's S_r
// once, 8 KB a tile.  `x_s` is the CTA's slot 0 offset to this thread's
// float4.
template <int BK, int XS>
__device__ __forceinline__ void cl_exchange(
    float (&s)[BK / 2], float4* x_mine, const float4* x_other, uint32_t x_s,
    uint32_t x_full, uint32_t x_empty, int wg, int rank, int nc, int step,
    bool last) {
  constexpr int X_SLOT = SP_BQ * BK * 4;   // bytes: one S_r
  constexpr int H = BK / 16;               // float4s in a thread's half
  sp_exchange<BK>(s, x_mine, x_other, wg, step == 0, false);
  const int slot = step % XS, use = step / XS;
  cl_gather<H, SP_BAR_PUB, WS_CONSUMERS>(
      s, reinterpret_cast<float4*>(
             __cvta_shared_to_generic(x_s + slot * X_SLOT)),
      x_full, x_empty, slot, use, wg, rank, nc);
  // The halves swapped: this warpgroup's sums out, the other's in.
  turn_wait(SP_BAR_READ + wg);
#pragma unroll
  for (int i = 0; i < 2 * H; ++i)
    if (i / H == wg)
      x_mine[128 * (i % H)] = make_float4(s[4 * i], s[4 * i + 1],
                                          s[4 * i + 2], s[4 * i + 3]);
  turn_wait(SP_BAR_WRITTEN);
  // Every consumer thread of the CTA has passed its peer reads.
  cl_arrive_all(x_empty + 8 * slot, nc);
#pragma unroll
  for (int i = 0; i < 2 * H; ++i) {
    if (i / H != wg) {
      const float4 x = x_other[128 * (i % H)];
      s[4 * i] = x.x;
      s[4 * i + 1] = x.y;
      s[4 * i + 2] = x.z;
      s[4 * i + 3] = x.w;
    }
  }
  if (!last) turn_pass(SP_BAR_READ + (wg ^ 1));
}

// S of tile step `step` completed: the CTA's two partials summed (MODE
// 0), or the cluster's (cl_exchange, on the barriers after `bars`).
template <int DQK, int DV, int MODE>
__device__ __forceinline__ void sp_complete(
    float (&s)[SpSmem<DQK, DV, MODE>::BK / 2], float4* x_mine,
    const float4* x_other, uint32_t x_s, uint32_t bars, int wg, int rank,
    int nc, int step, int lane, bool first, bool last) {
  using L = SpSmem<DQK, DV, MODE>;
  if constexpr (MODE == 0) {
    sp_exchange<L::BK>(s, x_mine, x_other, wg, first, last);
  } else {
    (void)lane;
    cl_exchange<L::BK, L::XS>(s, x_mine, x_other, x_s, bars + L::X_FULL,
                              bars + L::X_EMPTY, wg, rank, nc, step, last);
  }
}

// MODE 2: the Q.K^T rounds of tile step `step` but its last, each waited
// for and its Q and K slot released (nothing else is in flight then).
template <int DQK, int DV, int MODE, int NKQ>
__device__ __forceinline__ void sp_early_rounds(
    float (&s)[SpSmem<DQK, DV, MODE>::BK / 2], uint32_t q_s, uint32_t k_s,
    int kq0, uint32_t bars, int step, int rounds, int lane) {
  using L = SpSmem<DQK, DV, MODE>;
  constexpr int SL = L::SLOTS;
  for (int j = 0; j + 1 < rounds; ++j) {
    const int rs = step * rounds + j, slot = rs % SL;
    mbar_wait(bars + 32 * SL, rs & 1);                   // Q
    mbar_wait(bars + 8 * slot, (rs / SL) & 1);           // full K
    wgmma_fence();
    sp_qk<DQK, DV, MODE, NKQ>(s, q_s, k_s + slot * L::K_SLOT, kq0, j > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(bars + 16 * SL + 8 * slot);            // empty K
      mbar_arrive(bars + L::Q_EMPTY);
    }
  }
}

// A consumer warpgroup: the CTA's 64 query rows and O's columns [wg DV / 2,
// (wg + 1) DV / 2) of its slice, over tiles kt0 .. n_kt - 1.  Each tile:
// Q.K^T of this tile and P.V of the last as two wgmma groups; once Q.K^T
// is done, its K slot released, S completed by the exchange and its scores
// taken while P.V runs; once P.V is done, its V slot released, O rescaled
// and P packed.  In MODE 2 a tile's Q.K^T rounds but its last run first,
// each to completion (nothing else is in flight then).
template <int DQK, int DV, int MODE>
__device__ __forceinline__ void sp_consume(
    uint8_t* smem, uint32_t bars, void* out, bool out_bf16, int q0,
    int tq, int tk, int dv, int causal, int window, float scale, int kt0,
    int n_kt, int bh, const Slice& sl) {
  using L = SpSmem<DQK, DV, MODE>;
  constexpr int BK = L::BK, SL = L::SLOTS, ON = DV / 4;
  constexpr int NKQ = L::KS / 2;           // k-steps a warpgroup
  const uint32_t full_k = bars, full_v = bars + 8 * SL;
  const uint32_t empty_k = bars + 16 * SL, empty_v = bars + 24 * SL;
  const uint32_t qbar = bars + 32 * SL, q_empty = bars + L::Q_EMPTY;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_lo = q0 + 16 * warp + g, row_hi = row_lo + 8;
  const float sl2 = LOG2E * scale;         // scores in the exp2 domain
  const int kq0 = wg * NKQ;                // its half of d's k-steps
  const int rounds = MODE == 2 ? sl.rounds : 1;
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = smem_u32(smem + L::K_OFF);
  const uint32_t v_s = smem_u32(smem + L::V_OFF) +
                       wg * (L::HALF / 64) * L::KV_PANEL;
  float4* x_mine =
      reinterpret_cast<float4*>(smem + L::X_OFF + wg * L::X_WG) + tid;
  const float4* x_other =
      reinterpret_cast<const float4*>(smem + L::X_OFF + (wg ^ 1) * L::X_WG) +
      tid;
  const uint32_t x_s = smem_u32(smem + L::XC_OFF) + 16 * tid;
  float o[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.0f;
  float m_lo = NEG, m_hi = NEG, l_lo = 0.0f, l_hi = 0.0f, a_lo, a_hi;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  if constexpr (MODE != 2) mbar_wait(qbar, 0);
  if (kt0 < n_kt) {                        // else every row stores 0
    // The first tile: Q.K^T alone.
    if constexpr (MODE == 2)
      sp_early_rounds<DQK, DV, MODE, NKQ>(s, q_s, k_s, kq0, bars, 0,
                                          rounds, lane);
    const int rs0 = rounds - 1;            // the first tile's last round
    if constexpr (MODE == 2) mbar_wait(qbar, rs0 & 1);
    mbar_wait(full_k + 8 * (rs0 % SL), (rs0 / SL) & 1);
    wgmma_fence();
    sp_qk<DQK, DV, MODE, NKQ>(s, q_s, k_s + (rs0 % SL) * L::K_SLOT, kq0,
                              rs0 > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(empty_k + 8 * (rs0 % SL));
      if constexpr (MODE == 2) mbar_arrive(q_empty);
    }
    sp_complete<DQK, DV, MODE>(s, x_mine, x_other, x_s, bars, wg, sl.rank,
                               sl.nc, 0, lane, true, kt0 + 1 == n_kt);
    ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt0 * BK, q0,
                  row_lo, row_hi, t4, tk, causal, window, sl2);
    ws_rescale_pack<BK, ON>(s, o, pa, a_lo, a_hi);

    for (int kt = kt0 + 1; kt < n_kt; ++kt) {
      const int step = kt - kt0, prev = (step - 1) % SL;
      if constexpr (MODE == 2)
        sp_early_rounds<DQK, DV, MODE, NKQ>(s, q_s, k_s, kq0, bars, step,
                                            rounds, lane);
      const int rs = step * rounds + rounds - 1, slot = rs % SL;
      if constexpr (MODE == 2) mbar_wait(qbar, rs & 1);
      mbar_wait(full_k + 8 * slot, (rs / SL) & 1);
      mbar_wait(full_v + 8 * prev, ((step - 1) / SL) & 1);
      wgmma_fence();
      sp_qk<DQK, DV, MODE, NKQ>(s, q_s, k_s + slot * L::K_SLOT, kq0,
                                rounds > 1);
      wgmma_commit();
      sp_pv<DQK, DV, MODE>(o, pa, v_s + prev * L::V_SLOT);
      wgmma_commit();
      wgmma_wait_one();                  // Q.K^T of tile kt done
      fence_regs(s);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty_k + 8 * slot);
        if constexpr (MODE == 2) mbar_arrive(q_empty);
      }
      sp_complete<DQK, DV, MODE>(s, x_mine, x_other, x_s, bars, wg,
                                 sl.rank, sl.nc, step, lane, false,
                                 kt + 1 == n_kt);
      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt * BK, q0,
                    row_lo, row_hi, t4, tk, causal, window, sl2);
      wgmma_wait_all();                  // P.V of tile kt - 1 done
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + 8 * prev);
      ws_rescale_pack<BK, ON>(s, o, pa, a_lo, a_hi);
    }

    // P.V of the last tile.
    const int last = n_kt - 1 - kt0;
    mbar_wait(full_v + 8 * (last % SL), (last / SL) & 1);
    wgmma_fence();
    sp_pv<DQK, DV, MODE>(o, pa, v_s + (last % SL) * L::V_SLOT);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(FULL, l_lo, off);
    l_hi += __shfl_xor_sync(FULL, l_hi, off);
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  const long long ob = (long long)bh * tq * dv;
#pragma unroll
  for (int i = 0; i < L::HALF / 8; ++i) {
    const int c = sl.v0 + wg * L::HALF + 8 * i + 2 * t4;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = hi ? row_hi : row_lo;
      const float inv = hi ? inv_hi : inv_lo;
      if (r >= tq || c >= sl.vend) continue;
      const long long at = ob + (long long)r * dv + c;
      const float x0 = o[4 * i + 2 * hi] * inv;
      const float x1 = o[4 * i + 2 * hi + 1] * inv;
      if (out_bf16)
        store_pair(static_cast<__nv_bfloat16*>(out) + at, c, dv, x0, x1);
      else
        store_pair(static_cast<float*>(out) + at, c, dv, x0, x1);
    }
  }
}

template <int DQK, int DV, int MODE>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bf16_sp_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, void* out,
                     int out_bf16, int tma, int tq, int tk, int d, int dv,
                     int causal, int window, int group, float scale,
                     int vs0, int dvs,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using L = SpSmem<DQK, DV, MODE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + L::BARS);
  // One CTA (one cluster of nc) per (head, 64-row query tile) in a 1-D
  // grid, ordered by head group as the body above orders its 128-row
  // tiles.
  const int nc = MODE == 0 ? 1 : cluster_nctarank();
  const Slice sl = make_slice<MODE>(MODE == 0 ? 0 : cluster_ctarank(), nc,
                                    d, dv, vs0, dvs);
  const int tile = (int)blockIdx.x / nc, tiles = (int)gridDim.x / nc;
  const int n_qt = (tq + SP_BQ - 1) / SP_BQ;
  const int per_group = WS_HEAD_GROUP * n_qt;
  const int head0 = tile / per_group * WS_HEAD_GROUP;
  const int in_group = tile % per_group;
  const int heads = min(WS_HEAD_GROUP, tiles / n_qt - head0);
  const int bh = head0 + in_group % heads;
  const int q0 = (n_qt - 1 - in_group / heads) * SP_BQ;
  const int bkv = bh / group;              // grouped KV heads: bh / G
  const int kt0 = kv_tile_begin(q0, window, L::BK);
  const int n_kt = wg_kv_tiles<SP_BQ, L::BK>(q0, tk, causal);
  if (threadIdx.x == 0) {
    const int fills = tma ? 1 : 4;         // TMA's one thread, or 4 warps
    for (int b = 0; b < 2 * L::SLOTS; ++b)  // full K, full V
      mbar_init(bars + 8 * b, fills);
    for (int b = 2 * L::SLOTS; b < 4 * L::SLOTS; ++b)  // empty K, empty V
      mbar_init(bars + 8 * b, 8);          // one per consumer warp
    mbar_init(bars + 32 * L::SLOTS, fills);  // Q
    if constexpr (MODE != 0) {
      mbar_init(bars + L::Q_EMPTY, 8);
      for (int b = 0; b < 2 * L::XS; ++b)  // written X, read X: one
        mbar_init(bars + L::X_FULL + 8 * b, nc);       // arrival a CTA
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Panels past the slice's last 64-column panel below d (dv for V) are
  // never loaded: zero them once, so Q.K^T adds 0 there and P.V fills O's
  // unstored columns with 0.  (MODE 2 loads every panel every round.)
  const int np_q = MODE == 2 ? L::NQ : sl.np_q, np_v = sl.np_v;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int p = np_q; p < L::NQ; ++p) {
    uint4* qp = reinterpret_cast<uint4*>(smem + p * L::Q_PANEL);
    for (int c = threadIdx.x; c < L::Q_PANEL / 16; c += WS_THREADS)
      qp[c] = zero;
    for (int slot = 0; slot < L::SLOTS; ++slot) {
      uint4* kp = reinterpret_cast<uint4*>(smem + L::K_OFF +
                                           slot * L::K_SLOT +
                                           p * L::KV_PANEL);
      for (int c = threadIdx.x; c < L::KV_PANEL / 16; c += WS_THREADS)
        kp[c] = zero;
    }
  }
  for (int p = np_v; p < L::NV; ++p)
    for (int slot = 0; slot < L::SLOTS; ++slot) {
      uint4* vp = reinterpret_cast<uint4*>(smem + L::V_OFF +
                                           slot * L::V_SLOT +
                                           p * L::KV_PANEL);
      for (int c = threadIdx.x; c < L::KV_PANEL / 16; c += WS_THREADS)
        vp[c] = zero;
    }
  fence_proxy_async();
  __syncthreads();   // the last CTA-wide barrier: the roles part here
  // Every CTA's barriers initialised before any peer arrives on them.
  if constexpr (MODE != 0) cluster_sync();

  if (threadIdx.x >= WS_CONSUMERS) {
    regs_dec<SP_PRODUCER_REGS>();
    sp_produce<DQK, DV, MODE>(smem, bars, tma != 0,
                              q + (long long)bh * tq * d,
                              k + (long long)bkv * tk * d,
                              v + (long long)bkv * tk * dv, q0, tq, tk, d,
                              dv, kt0, n_kt, bh, bkv, sl, &qmap, &kmap,
                              &vmap);
    if constexpr (MODE != 0) cluster_sync();
  } else {
    regs_inc<SP_CONSUMER_REGS>();
    sp_consume<DQK, DV, MODE>(smem, bars, out, out_bf16 != 0, q0, tq, tk,
                              dv, causal, window, scale, kt0, n_kt, bh, sl);
    // No CTA leaves while a peer may still read its partial slots.
    if constexpr (MODE != 0) cluster_sync();
  }
}


// cuTensorMapEncodeTiled from the driver, fetched through the runtime, so
// the library needs no link to libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [heads, rows, d] bf16 tensor as a TMA map with boxes of `box_rows`
// rows x 64 columns (128 B, the swizzle span), zero fill outside.
bool make_map(CUtensorMap* map, const void* base, int heads, int rows, int d,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 16-byte copies of q, k and v (the fp32 bodies' fast route): rows of a
// multiple of 4 floats from 16-byte bases; else the staged route.
bool f32_vec(const void* q, const void* k, const void* v, int d, int dv) {
  return d % 4 == 0 && dv % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) & 15) == 0;
}
// 4-column stores of out: rows of a multiple of 4 from a 16-byte base.
bool f32_vec_out(const void* out, int dv) {
  return dv % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
}

// fp32, d <= 256: the body at (DQK, DV).
template <int DQK, int DV, typename OutT>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int tq, int tk, int d, int dv, int causal, int window,
               int group, float scale, cudaStream_t stream) {
  using L = F32Smem<DQK, DV>;
  auto kernel = flash_f32_kernel<DQK, DV, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<OutT*>(out), tq, tk, d, dv,
      causal, window, group, scale, (int)f32_vec(q, k, v, d, dv),
      (int)f32_vec_out(out, dv));
  return (int)cudaGetLastError();
}

// fp32, d <= 256: DQK the first of 32, 64, 128, 256 to hold d; DV = DQK,
// but 128 for dv <= 128 at DQK 256.
template <typename OutT>
int dispatch_f32(const void* q, const void* k, const void* v, void* out,
                 int bh, int tq, int tk, int d, int dv, int causal,
                 int window, int group, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch_f32<32, 32, OutT>(q, k, v, out, bh, tq, tk, d, dv, causal,
                                    window, group, scale, stream);
  if (d <= 64)
    return launch_f32<64, 64, OutT>(q, k, v, out, bh, tq, tk, d, dv, causal,
                                    window, group, scale, stream);
  if (d <= 128)
    return launch_f32<128, 128, OutT>(q, k, v, out, bh, tq, tk, d, dv,
                                      causal, window, group, scale, stream);
  if (dv <= 128)
    return launch_f32<256, 128, OutT>(q, k, v, out, bh, tq, tk, d, dv,
                                      causal, window, group, scale, stream);
  return launch_f32<256, 256, OutT>(q, k, v, out, bh, tq, tk, d, dv, causal,
                                    window, group, scale, stream);
}

// Past d = 256 the single-pass bodies run in one CTA a (head, query
// tile) up to d = 576 with dv <= 512, else in clusters of C = ceil(d /
// 512) CTAs, at most CL_MAX (the portable cluster size), each rank holding
// at most CL_SLICE columns of q / k (but past CL_MAX x CL_SLICE) and of v /
// out; v / out past CL_SLAB columns run as slabs of CL_SLAB, one launch
// each.
constexpr int CL_SLICE = 512;
constexpr int CL_MAX = 8;
constexpr int CL_SLAB = CL_MAX * CL_SLICE;

int flash_cluster(int d, int dv) {
  if (d <= F32SP_DQK && dv <= F32SP_DV) return 1;
  return min(CL_MAX, (d + CL_SLICE - 1) / CL_SLICE);
}

// A launch of `kernel` in clusters of `nc` CTAs along x.
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), dim3 grid, int threads,
                   int smem, int nc, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `nc` CTAs of `kernel` resident on the card at once.
template <typename... Params>
int resident_clusters(void (*kernel)(Params...), int threads, int smem,
                      int nc) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// fp32 past d = 256: the single-pass body, in one CTA or in clusters
// (flash_cluster).
template <typename OutT>
int launch_f32_sp(const void* q, const void* k, const void* v, void* out,
                  int bh, int tq, int tk, int d, int dv, int causal,
                  int window, int group, float scale, cudaStream_t stream) {
  const int nc = flash_cluster(d, dv);
  const int vec = (int)f32_vec(q, k, v, d, dv);
  const int vec_out = (int)f32_vec_out(out, dv);
  if (nc == 1) {
    auto kernel = flash_f32_sp_kernel<OutT, false>;
    using L = F32SpSmem<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(bh, (tq + F32SP_BQ - 1) / F32SP_BQ);
    kernel<<<grid, F32SP_THREADS, L::BYTES, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<OutT*>(out), tq, tk, d,
        dv, causal, window, group, scale, vec, vec_out, 0, dv);
    return (int)cudaGetLastError();
  }
  if ((long long)bh * nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = flash_f32_sp_kernel<OutT, true>;
  using L = F32SpSmem<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh * nc, (tq + F32SP_BQ - 1) / F32SP_BQ);
  for (int vs0 = 0; vs0 < dv; vs0 += CL_SLAB) {
    const int rc = launch_cluster(
        kernel, grid, F32SP_THREADS, L::BYTES, nc, stream,
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<OutT*>(out), tq, tk, d,
        dv, causal, window, group, scale, vec, vec_out, vs0,
        min(CL_SLAB, dv - vs0));
    if (rc != 0) return rc;
  }
  return 0;
}

// TMA needs 16-byte row strides and bases (per-head offsets are then
// multiples of 16 bytes too).
bool tma_fits(const void* q, const void* k, const void* v, int d, int dv) {
  return d % 8 == 0 && dv % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) & 15) == 0;
}

// bf16, d <= 256: the warp-specialised body at (DQK, DV).
template <int DQK, int DV>
int launch_ws(const void* q, const void* k, const void* v, void* out,
              int out_dtype, int bh, int tq, int tk, int d, int dv,
              int causal, int window, int group, float scale,
              cudaStream_t stream) {
  using L = WsSmem<DQK, DV>;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma = tma_fits(q, k, v, d, dv) &&
                   make_map(&maps[0], q, bh, tq, d, L::BQ) &&
                   make_map(&maps[1], k, bh / group, tk, d, L::BK) &&
                   make_map(&maps[2], v, bh / group, tk, dv, L::BK);
  auto kernel = flash_bf16_ws_kernel<DQK, DV>;
  const long long ctas = (long long)bh * ((tq + L::BQ - 1) / L::BQ);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long kv_bytes = 2ll * (bh / group) * tk * (d + dv);
  const int head_group = kv_bytes <= WS_ALL_HEADS_KV_BYTES ? bh
                                                           : WS_HEAD_GROUP;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)ctas, L::THREADS, L::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), out, out_dtype, (int)tma, tq,
      tk, d, dv, causal, window, group, head_group, scale, maps[0],
      maps[1], maps[2]);
  return (int)cudaGetLastError();
}

// bf16 past d = 256: the single-pass body at (DQK, DV, MODE) over the
// columns [vs0, vs0 + dvs) of v / out, in clusters of nc CTAs (MODE > 0).
template <int DQK, int DV, int MODE>
int launch_sp(const void* q, const void* k, const void* v, void* out,
              int out_dtype, int bh, int tq, int tk, int d, int dv,
              int causal, int window, int group, float scale, int nc,
              int vs0, int dvs, cudaStream_t stream) {
  using L = SpSmem<DQK, DV, MODE>;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma = tma_fits(q, k, v, d, dv) &&
                   make_map(&maps[0], q, bh, tq, d, SP_BQ) &&
                   make_map(&maps[1], k, bh / group, tk, d, L::BK) &&
                   make_map(&maps[2], v, bh / group, tk, dv, L::BK);
  auto kernel = flash_bf16_sp_kernel<DQK, DV, MODE>;
  const long long ctas = (long long)bh * ((tq + SP_BQ - 1) / SP_BQ) * nc;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  if (MODE == 0) {
    kernel<<<(unsigned)ctas, WS_THREADS, L::BYTES, stream>>>(
        qb, kb, vb, out, out_dtype, (int)tma, tq, tk, d, dv, causal, window,
        group, scale, vs0, dvs, maps[0], maps[1], maps[2]);
    return (int)cudaGetLastError();
  }
  return launch_cluster(kernel, dim3((unsigned)ctas), WS_THREADS, L::BYTES,
                        nc, stream, qb, kb, vb, out, out_dtype, (int)tma, tq,
                        tk, d, dv, causal, window, group, scale, vs0, dvs,
                        maps[0], maps[1], maps[2]);
}

// bf16 past d = 256.  One CTA (d <= 576, dv <= 512): DQK 512 for d <=
// 512 (DV 256 for dv <= 256, else 512), else 576.  A cluster: DQK 512, DV
// 256 where a rank's v slice holds at most 4 panels, else 512; Q in rounds
// (MODE 2) where a rank's q / k slice passes 8 panels.
int launch_bf16_sp(const void* q, const void* k, const void* v, void* out,
                   int out_dtype, int bh, int tq, int tk, int d, int dv,
                   int causal, int window, int group, float scale,
                   cudaStream_t stream) {
  const int nc = flash_cluster(d, dv);
  if (nc == 1) {
    if (d > 512)
      return launch_sp<576, 512, 0>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                    dv, causal, window, group, scale, 1, 0,
                                    dv, stream);
    return dv <= 256
               ? launch_sp<512, 256, 0>(q, k, v, out, out_dtype, bh, tq, tk,
                                        d, dv, causal, window, group, scale,
                                        1, 0, dv, stream)
               : launch_sp<512, 512, 0>(q, k, v, out, out_dtype, bh, tq, tk,
                                        d, dv, causal, window, group, scale,
                                        1, 0, dv, stream);
  }
  const bool rounds = (d + 63) / 64 > 8 * nc;
  for (int vs0 = 0; vs0 < dv; vs0 += CL_SLAB) {
    const int dvs = min(CL_SLAB, dv - vs0);
    const int per_v = ((dvs + 63) / 64 + nc - 1) / nc;
    const int rc =
        rounds ? launch_sp<512, 512, 2>(q, k, v, out, out_dtype, bh, tq, tk,
                                        d, dv, causal, window, group, scale,
                                        nc, vs0, dvs, stream)
        : per_v <= 4
            ? launch_sp<512, 256, 1>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                     dv, causal, window, group, scale, nc,
                                     vs0, dvs, stream)
            : launch_sp<512, 512, 1>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                     dv, causal, window, group, scale, nc,
                                     vs0, dvs, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

// The body flash_attention_fwd runs for (dtype, d, dv), by the code
// `ops.flash_body` names: 1 fp32 (d <= 256), 3 bf16 (the warp-specialised
// body at DQK 64 / 128, d <= 128), 4 bf16 warp-specialised (DQK 192 /
// 256, d <= 256), 5 bf16 single-pass (any d > 256), 7 fp32 single-pass
// (any d > 256); past d = 576 or dv > 512 the single-pass bodies run in
// clusters (flash_cluster).  (Codes 2 and 6 were the d-sliced bodies.)
int flash_body(int dtype, int d, int dv) {
  (void)dv;
  if (dtype == 0) return d <= 256 ? 1 : 7;
  if (d <= 128) return 3;
  return d <= 256 ? 4 : 5;
}

// bf16, d <= 256: the warp-specialised body.  DQK is the first of 64,
// 128, 192 and 256 to hold d; DV is DQK, but 128 for dv <= 128 past d =
// 128.
int dispatch(int out_dtype, const void* q, const void* k, const void* v,
             void* out, int bh, int tq, int tk, int d, int dv, int causal,
             int window, int group, float scale, cudaStream_t stream) {
  if (d <= 64)
    return launch_ws<64, 64>(q, k, v, out, out_dtype, bh, tq, tk, d, dv,
                             causal, window, group, scale, stream);
  if (d <= 128)
    return launch_ws<128, 128>(q, k, v, out, out_dtype, bh, tq, tk, d, dv,
                               causal, window, group, scale, stream);
  if (d <= 192)
    return dv <= 128
               ? launch_ws<192, 128>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                     dv, causal, window, group, scale,
                                     stream)
               : launch_ws<192, 192>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                     dv, causal, window, group, scale,
                                     stream);
  return dv <= 128
             ? launch_ws<256, 128>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                   dv, causal, window, group, scale, stream)
             : launch_ws<256, 256>(q, k, v, out, out_dtype, bh, tq, tk, d,
                                   dv, causal, window, group, scale, stream);
}

}  // namespace

// out[bh] = softmax(q[bh] k[bh / group]^T * scale, causal: qpos >= kpos;
// window > 0: also qpos - kpos < window) v[bh / group] for contiguous q
// [bh, tq, d], k [bh / group, tk, d], v [bh / group, tk, dv] and out [bh,
// tq, dv]; dtype 0 is fp32, 1 is bf16 (q, k and v), out_dtype the same
// codes for out (converted in the epilogue), any d >= 1 (`flash_body` says
// which body runs) and 1 <= dv <= d, group >= 1 divides bh, bh < 2^31, tq
// <= 4,194,240; a window needs causal and tq <= tk (window 0: none).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take; 0 when there is nothing to compute).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int out_dtype, int bh, int tq, int tk,
                                   int d, int dv, int causal, int window,
                                   int group, float scale, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0 || d <= 0 || dv <= 0 || dv > d || (dtype != 0 && dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) ||
      group <= 0 || bh % group != 0 || (tq + BQ - 1) / BQ > 65535 ||
      window < 0 || (window > 0 && (!causal || tq > tk)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int body = flash_body(dtype, d, dv);
  if (body == 1) {
    if (out_dtype == 0)
      return dispatch_f32<float>(q, k, v, out, bh, tq, tk, d, dv, causal,
                                 window, group, scale, s);
    return dispatch_f32<__nv_bfloat16>(q, k, v, out, bh, tq, tk, d, dv,
                                       causal, window, group, scale, s);
  }
  if (body == 7) {
    if (out_dtype == 0)
      return launch_f32_sp<float>(q, k, v, out, bh, tq, tk, d, dv, causal,
                                  window, group, scale, s);
    return launch_f32_sp<__nv_bfloat16>(q, k, v, out, bh, tq, tk, d, dv,
                                        causal, window, group, scale, s);
  }
  if (body == 5)
    return launch_bf16_sp(q, k, v, out, out_dtype, bh, tq, tk, d, dv, causal,
                          window, group, scale, s);
  return dispatch(out_dtype, q, k, v, out, bh, tq, tk, d, dv, causal, window,
                  group, scale, s);
}

// Which body flash_attention_fwd runs for these operands (`flash_body`'s
// code; 0 for arguments it refuses by type).
extern "C" int flash_attention_body(int dtype, int d, int dv) {
  if ((dtype != 0 && dtype != 1) || d <= 0 || dv <= 0 || dv > d) return 0;
  return flash_body(dtype, d, dv);
}

// The CTAs a cluster of flash_attention_fwd holds for these operands (1:
// no cluster; 0 for arguments it refuses by type).
extern "C" int flash_attention_cluster(int dtype, int d, int dv) {
  if ((dtype != 0 && dtype != 1) || d <= 0 || dv <= 0 || dv > d) return 0;
  return flash_body(dtype, d, dv) == 5 || flash_body(dtype, d, dv) == 7
             ? flash_cluster(d, dv)
             : 1;
}

// Clusters of the instantiation flash_attention_fwd launches for these
// operands (v / out as in its first slab) that the card holds at once
// (cudaOccupancyMaxActiveClusters); 0 where it launches no cluster, minus
// a CUDA error code where the query fails.
extern "C" int flash_attention_clusters_resident(int dtype, int out_dtype,
                                                 int d, int dv) {
  const int nc = flash_attention_cluster(dtype, d, dv);
  if (nc <= 1) return 0;
  if (dtype == 0)
    return out_dtype == 0
               ? resident_clusters(flash_f32_sp_kernel<float, true>,
                                   F32SP_THREADS, F32SpSmem<true>::BYTES, nc)
               : resident_clusters(flash_f32_sp_kernel<__nv_bfloat16, true>,
                                   F32SP_THREADS, F32SpSmem<true>::BYTES,
                                   nc);
  const int dvs = min(CL_SLAB, dv);
  const int per_v = ((dvs + 63) / 64 + nc - 1) / nc;
  if ((d + 63) / 64 > 8 * nc)
    return resident_clusters(flash_bf16_sp_kernel<512, 512, 2>, WS_THREADS,
                             SpSmem<512, 512, 2>::BYTES, nc);
  return per_v <= 4
             ? resident_clusters(flash_bf16_sp_kernel<512, 256, 1>,
                                 WS_THREADS, SpSmem<512, 256, 1>::BYTES, nc)
             : resident_clusters(flash_bf16_sp_kernel<512, 512, 1>,
                                 WS_THREADS, SpSmem<512, 512, 1>::BYTES, nc);
}
