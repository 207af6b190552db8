// GEMM tile kernel for the ACK's GEMM mode:  C = acc + A * B  in fp32
// (and the Pallas kernel's bf16 operands and bf16 output).
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
// bf16 operands (JAX's sweeps run the Pallas kernel on bf16 x and w: the
// MXU's bf16 products summed into an fp32 accumulator) take
// `gemm_bf16_kernel`, a tensor-core body on Hopper's warpgroup MMA:
// wgmma m64nBNk16, both operands read from shared memory under the
// 128-byte swizzle (x K-major; w in its natural [K, N] layout, MN-major,
// through the transpose bit), the fp32 accumulator in registers.  What
// bounds it: at the executor's tile shape (4096 x 128 x 128, fp32 out) one
// call moves 3.1 MB, 0.9 us at 3.35 TB/s, and its 134 MFLOP take 0.14 us
// at the 989 TFLOP/s bf16 rate; at the remapped shape (4096 x 4096 x 128)
// x's 32 MiB bound it (10.7 us); at 4096^3 the tensor cores do (137
// GFLOP, 0.139 ms).  Structure: one producer warp fills a ring of STAGES
// k-stages of 64 (one 128-byte row of x a row) and signals each on a
// `full` mbarrier; one or two consumer warpgroups of 64 output rows issue
// a stage's four k-steps as one wgmma group, keep one group in flight, and
// release a stage on an `empty` mbarrier once the group that read it has
// completed; no CTA-wide barrier follows the start.  The producer issues
// TMA (one thread; the hardware writes the swizzle and zero-fills past M,
// N and K) where x and w start on 16-byte boundaries with row strides of
// multiples of 16 bytes (`copy_width`; `ops.gemm_bf16_route` on the host).
// Other operands (strided views, odd widths) are staged by the whole warp
// into the same swizzled layout: cp.async copies of 16, 8 or 4 bytes, the
// widest the base and row stride allow, src-size zero-filling ragged edges,
// or plain 2-byte loads where rows are only 2-byte aligned (cp.async copies
// no fewer than 4 bytes); the warp signals a stage once its copies have
// landed, checked after issuing the next stage's.  Both routes feed the
// same consumer code, so the same operands give the same bits through
// either.  The epilogue adds acc (fp32) last and rounds once to the output
// type, storing pairs straight from registers, masked at the M and N edges.
//
// Tiles are chosen from N and K only, never from M (`bf16_tile`), so each
// output element's sum, k-steps of 16 in order each added by the tensor
// core to the fp32 accumulator, is fixed by (K, tile): a row slice of a
// call, a second launch and an unaligned copy of the operands give the
// same bits.  No split-K, no atomics.
//  * K <= 256: 64 x 64 tiles, one consumer warpgroup, a ring of 4 (64
//    KB).  At 4096 x 128 x 128 a CTA runs only two k-stages, so latency,
//    not the tensor-core rate, bounds a call: 64 x 64 tiles give 128 CTAs
//    on the 132 SMs (128 x 128 tiles would give 32), and the ring holds
//    the whole K, so a CTA issues every load at once and the call costs
//    about one load round trip, eight wgmma and a 16 KB store a CTA
//    (64 x 128 tiles, 64 CTAs, measured 1.37x slower; PERF.md).
//  * K > 256, N <= 128: the same tiles in a ring of 8 (128 KB).  At 4096 x
//    4096 x 128 they give 128 CTAs streaming 64 rows of x each; the two N
//    tiles of a row block are neighbours in the grid, so x's second read
//    comes from L2.  The ring's depth moves the rate: a ring of 4 measured
//    1.29x slower, one of 12 1.10x; 64 x 128 tiles (x read once, 64
//    CTAs) 1.41x.
//  * N > 128 and K > 256: two consumer warpgroups, 128 x 128 tiles (N <=
//    1024) or 128 x 256 (a ring of 4 stages of 48 KB, 192 KB): a stage
//    feeds 4 wgmma m64n256k16 a warpgroup, and the tensor cores bound it.
//    At 4096^3, 512 CTAs of 128 x 256 in about 4 waves on the 132 SMs
//    (128 x 128 tiles measured 1.17x slower, 64 x 256 with one warpgroup
//    1.69x).
// fp32 operands with a bf16 output take the fp32 kernel above with its
// store templated on the output type: its fp32 result, rounded once.
//
// The file also holds `ell_densify_f32`, which feeds this kernel the dense
// [n1, n_src] adjacency block of a remapped ELL tile (a sparsity-remapped
// binary runs such an AGGREGATE step as dense @ h).  It replaces the XLA
// scatter-add of src/repro/core/ack.py `densify_tile` / `_gemm_agg_xla`,
// which has no Pallas kernel.  A graph may hold the same column twice in
// one row, and a scatter-add on the card sums such duplicates in no fixed
// order, so the block would change from call to call.  What bounds it is
// writing the block: 64 MiB at n1 = n_src = 4096, with 16.8 MB of slots
// (0.025 ms at 3.35 TB/s); most slots are pads, so nearly every byte
// written is a zero.  A row is cut into segments of DSEG = 2048 positions
// counted from the 16-byte boundary at or before its first column (a row
// of an n_src not a multiple of 4 starts 4, 8 or 12 bytes past one), and
// one warp owns a segment, its sums in shared memory (8 KB); lane l owns
// quads l + 32 i.  The warp reads the row's slots 32 at a time, eight
// chunks in flight a lane, a slot's column only where its value is not
// zero, and adds each chunk's slots that land in its segment
// (`densify_chunk`: the slots of one position find each other with a
// match, and the first adds them in slot order; a chunk with none costs a
// vote).  Every element is therefore 0.0f plus its slots in slot order,
// the sum a serial scatter-add makes, with no atomics; skipping the
// zero-valued slots (the pads) changes no bit, as the walk says.  Then
// each quad is written once, 16 bytes a lane and 512 contiguous bytes a
// warp store, scalars for a quad cut by the row's ends, with the
// streaming hint.  Measured on an H100 80GB HBM3 at 700 W (PERF.md):
// plain stores of the block ran at 0.6x the write rate of the same
// stores marked streaming, or of a memset; zeros stored first and the
// sums over them later cost 10-19% more; 1,024-position segments (each of
// four warps reading the row's slots) 7% more on a Flickr slice; every
// column read, pads' too, 9-12% more; one warp broadcasting a chunk's
// slots one at a time (the first design's loop) 42-81% more: it stalls
// on Flickr's hub columns, where one column takes hundreds of a row's
// slots.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(v.z, v.w);
}

// OutT: float, or __nv_bfloat16 for fp32 operands with a bf16 output (the
// fp32 result rounded once as it is stored).
template <bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* acc, OutT* C, int M, int N, int K,
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
      put4(C + gm * ldc + gn,
           make_float4(base.x + c[i][0], base.y + c[i][1], base.z + c[i][2],
                       base.w + c[i][3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (gn + j >= N) continue;
        const float base = acc ? acc[gm * ldacc + gn + j] : 0.0f;
        put(C + gm * ldc + gn + j, base + c[i][j]);
      }
    }
  }
}

// ---- the bf16 body: wgmma from shared memory, fed by TMA or cp.async ----

constexpr int XBK = 64;               // k a stage: one 128-byte row of x
constexpr int B_PANEL = XBK * 128;    // bytes of a 64-column panel of w

// A tile shape: NWG consumer warpgroups of 64 output rows, BN columns, a
// ring of STAGES k-stages; each stage holds x's [BM][64] panel and w's
// [64][BN] as BN / 64 panels of 64 columns, all rows 128 bytes, swizzled.
template <int NWG, int BN, int STAGES>
struct Bf16Tile {
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma width");
  // The staged producer signals stage kt only after issuing kt + 1, and a
  // consumer releases stage kt - 1 only once stage kt is full: a slot
  // reused at kt waits for the release of stage kt - STAGES, which needs
  // stage kt - STAGES + 1 signalled, hence kt - STAGES + 2 issued, so a
  // ring of 2 would wait on itself.
  static_assert(STAGES >= 3, "the staged producer signals one stage late, "
                "so a slot waits for the release of a stage two behind");
  static constexpr int BM = 64 * NWG;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + (BN / 64) * B_PANEL;
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
  static constexpr int BARS = STAGES * STAGE;      // full[], empty[]
  // + 1 KB to align the base to the swizzle's 1 KB period.
  static constexpr int SMEM = BARS + 16 * STAGES + 1024;
};

// Byte offset of the 16-byte chunk holding columns c .. c+7 of row r, in
// 64-column panels of `panel` bytes with the 128-byte swizzle (what TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B into a 1 KB-aligned buffer).
__device__ __forceinline__ uint32_t swz(int r, int c, int panel) {
  return (c >> 6) * panel + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
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
// TMA: the box at (c0, c1) of a 2-D tensor map into shared memory,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1)
      : "memory");
}
// Shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Every committed wgmma group but the last N has completed.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an in-flight wgmma writes: reads of them may not be moved
// above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  For a K-major
// operand (x) the stride byte offset (sbo) steps 8 rows and the leading
// byte offset is unused; for an MN-major operand (w) lbo steps one
// 64-column panel along N and sbo 8 rows along K.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D (+)= A.B for a 64 x 64 tile, depth 16: A (x, K-major) and B (w,
// MN-major: the transpose bit is set) from shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_tb_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
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

// D (+)= A.B for a 64 x 128 tile, depth 16: A (x, K-major) and B (w,
// MN-major: the transpose bit is set) from shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_tb_n128(float (&d)[64], uint64_t da,
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
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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

// D (+)= A.B for a 64 x 256 tile, depth 16: A (x, K-major) and B (w,
// MN-major: the transpose bit is set) from shared memory, 128-byte swizzle.
__device__ __forceinline__ void wgmma_tb_n256(float (&d)[128], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
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
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tb(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64) wgmma_tb_n64(d, da, db, 1);
  else if constexpr (BN == 128) wgmma_tb_n128(d, da, db, 1);
  else wgmma_tb_n256(d, da, db, 1);
}

__device__ __forceinline__ void cp8(uint32_t dst, const void* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// 16 bytes of shared memory at dst (a swizzle chunk: 8 bf16) from the
// `valid` (0..8) elements at src, zero-filled after them, in copies of w
// bytes: cp.async of 16, 8 or 4 bytes (the widest the operand's base and
// row stride allow, so every copy is aligned), or plain 2-byte loads where
// rows are only 2-byte aligned (cp.async copies no fewer than 4 bytes).
// `base` is any readable address of the operand (w-aligned), the source of
// a copy that reads nothing.
__device__ __forceinline__ void stage_chunk(uint32_t dst,
                                            const __nv_bfloat16* src,
                                            const __nv_bfloat16* base,
                                            int valid, int w) {
  if (w == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(valid ? src : base), "r"(2 * valid));
  } else if (w == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(max(valid - 4 * h, 0), 4);
      cp8(dst + 8 * h, n ? src + 4 * h : base, 2 * n);
    }
  } else if (w == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int n = min(max(valid - 2 * h, 0), 2);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       dst + 4 * h),
                   "l"(n ? src + 2 * h : base), "r"(2 * n));
    }
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint32_t lo = 2 * h < valid ? s[2 * h] : 0u;
      const uint32_t hi = 2 * h + 1 < valid ? s[2 * h + 1] : 0u;
      v[h] = lo | (hi << 16);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                 "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                 : "memory");
  }
}

// The producer warp: fills k-stages 0 .. n_kt - 1 of the ring, each once
// every consumer warp has released its last use.  TMA: one thread, the
// hardware swizzling and zero-filling past M, N and K.  Staged: the whole
// warp, cp.async into the same layout; stage kt is signalled once it has
// landed, which the warp checks after issuing stage kt + 1, so one stage's
// copies are in flight while the last one's land.
template <int NWG, int BN, int STAGES, bool TMA>
__device__ __forceinline__ void produce(
    uint32_t ring, uint32_t full, uint32_t empty,
    const __nv_bfloat16* A, const __nv_bfloat16* B, int M, int N, int K,
    long long lda, long long ldb, int m0, int n0, int n_kt, int wa, int wb,
    const CUtensorMap* amap, const CUtensorMap* bmap) {
  using L = Bf16Tile<NWG, BN, STAGES>;
  const int lane = threadIdx.x & 31;
  if constexpr (TMA) {
    if (lane != 0) return;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % STAGES;
      // Stage kt - STAGES used this slot: wait for its release.
      if (kt >= STAGES)
        mbar_wait(empty + 8 * st, ((kt / STAGES) & 1) ^ 1);
      const uint32_t as = ring + st * L::STAGE, bs = as + L::A_BYTES;
      const int k0 = kt * XBK;
      mbar_expect_tx(full + 8 * st, L::STAGE);
      tma_load_2d(as, amap, full + 8 * st, k0, m0);
#pragma unroll
      for (int p = 0; p < BN / 64; ++p)
        tma_load_2d(bs + p * B_PANEL, bmap, full + 8 * st, n0 + 64 * p, k0);
    }
  } else {
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % STAGES;
      if (kt >= STAGES)
        mbar_wait(empty + 8 * st, ((kt / STAGES) & 1) ^ 1);
      const uint32_t as = ring + st * L::STAGE, bs = as + L::A_BYTES;
      const int k0 = kt * XBK;
      for (int e = lane; e < L::BM * 8; e += 32) {
        const int r = e >> 3, c = (e & 7) * 8;
        const int gk = k0 + c;
        const int valid = m0 + r < M ? min(max(K - gk, 0), 8) : 0;
        stage_chunk(as + swz(r, c, 0), A + (long long)(m0 + r) * lda + gk,
                    A, valid, wa);
      }
      for (int e = lane; e < XBK * (BN / 8); e += 32) {
        const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
        const int gn = n0 + c;
        const int valid = k0 + r < K ? min(max(N - gn, 0), 8) : 0;
        stage_chunk(bs + swz(r, c, B_PANEL),
                    B + (long long)(k0 + r) * ldb + gn, B, valid, wb);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      // Stage kt - 1 has landed: signal it.
      if (kt > 0) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + 8 * ((kt - 1) % STAGES));
      }
    }
    if (n_kt > 0) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full + 8 * ((n_kt - 1) % STAGES));
    }
  }
}

// C = acc + A * B for bf16 A [M, K] and B [K, N] (row strides lda, ldb),
// fp32 acc [M, N] (or null) and C [M, N] in fp32 or, with out_bf16, bf16;
// one BM x BN output tile a CTA.  wa / wb are the staged route's copy
// widths; vec_out says C (and acc) take two-element stores.
template <int NWG, int BN, int STAGES, bool TMA>
__global__ void __launch_bounds__(Bf16Tile<NWG, BN, STAGES>::THREADS, 1)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B, const float* acc,
                 void* C, int out_bf16, int M, int N, int K, long long lda,
                 long long ldb, long long ldacc, long long ldc, int wa,
                 int wb, int vec_out,
                 const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap) {
  using L = Bf16Tile<NWG, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + L::BARS, empty = full + 8 * STAGES;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * BN;
  const int n_kt = (K + XBK - 1) / XBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);             // the producer's arrival
      mbar_init(empty + 8 * s, 4 * NWG);      // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the last CTA-wide barrier: the roles part here

  if (threadIdx.x >= L::CONSUMERS) {
    produce<NWG, BN, STAGES, TMA>(ring, full, empty, A, B, M, N, K, lda,
                                  ldb, m0, n0, n_kt, wa, wb, &amap, &bmap);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float c[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) c[i] = 0.0f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(full + 8 * st, (kt / STAGES) & 1);
    const uint32_t as = ring + st * L::STAGE + wg * 64 * 128;
    const uint32_t bs = ring + st * L::STAGE + L::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < XBK / 16; ++ks)     // 16 k: 32 B of x, 16 rows of w
      wgmma_tb<BN>(c, gmma_desc(as + ks * 32, 16, 1024),
                   gmma_desc(bs + ks * 16 * 128, B_PANEL, 1024));
    wgmma_commit();
    // The last stage's products have completed: release its slot.
    if (kt > 0) {
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
    }
  }
  wgmma_wait<0>();
  fence_regs(c);

  // c[4i + e] is row r_lo (e < 2) or r_lo + 8, column n0 + 8i + 2 (lane
  // % 4) + (e & 1): the m64nNk16 accumulator layout.
  const int r_lo = m0 + 64 * wg + 16 * warp + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long gm = r_lo + 8 * h;
    if (gm >= M) continue;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int gn = n0 + 8 * i + 2 * (lane & 3);
      const float v0 = c[4 * i + 2 * h], v1 = c[4 * i + 2 * h + 1];
      if (vec_out && gn + 1 < N) {
        const float2 a = acc ? *reinterpret_cast<const float2*>(
                                   acc + gm * ldacc + gn)
                             : make_float2(0.0f, 0.0f);
        if (out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(C) + gm * ldc + gn) =
              __floats2bfloat162_rn(a.x + v0, a.y + v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(C) + gm * ldc +
                                     gn) = make_float2(a.x + v0, a.y + v1);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (gn + j >= N) continue;
          const float v = (acc ? acc[gm * ldacc + gn + j] : 0.0f) +
                          (j ? v1 : v0);
          if (out_bf16)
            static_cast<__nv_bfloat16*>(C)[gm * ldc + gn + j] =
                __float2bfloat16_rn(v);
          else
            static_cast<float*>(C)[gm * ldc + gn + j] = v;
        }
      }
    }
  }
}

constexpr int DSEG = 2048;      // positions of a row a densify warp owns
constexpr int DQ = DSEG / 128;  // 16-byte quads a lane owns in its segment
constexpr int DWARPS = 4;       // densify warps per CTA
constexpr int DB = 8;           // chunks of 32 slots loaded before a walk

// Quad p .. p + 3 of a row (positions: `base` is 16-byte aligned and
// position p is column p - m): one 16-byte store where all four columns
// lie in [0, n_src), else a scalar store for each column that does.  The
// stores are marked streaming (evict first): the block is written once,
// and plain stores left it to L2 and wrote it at 0.6x the rate.
__device__ __forceinline__ void densify_put(float* base, int p, int m,
                                            int n_src, float4 x) {
  const int c = p - m;
  if (c >= 0 && c + 3 < n_src) {
    __stcs(reinterpret_cast<float4*>(base + p), x);
    return;
  }
  const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j >= 0 && c + j < n_src) __stcs(base + p + j, e[j]);
}

// Adds one chunk of 32 slots to the warp's segment in shared memory: lane
// l's slot (slot order is lane order) lands at position p of the segment,
// or p = -1 (a pad, zero-valued, out of range or in another segment).  The
// slots of one position find each other (match); the first of them reads
// the position's sum, adds its own value and then the others', in slot
// order, and writes it back, so every element's sum is taken in slot
// order, and positions are summed side by side.
__device__ __forceinline__ void densify_chunk(float* segf, int p, float v,
                                              int lane) {
  if (!__any_sync(0xffffffffu, p >= 0)) return;
  const unsigned same = __match_any_sync(0xffffffffu, p);
  const bool lead = p >= 0 && (same & ((1u << lane) - 1)) == 0;
  const int n = lead ? __popc(same) : 0;
  const int rounds = __reduce_max_sync(0xffffffffu, n);
  float sum = lead ? segf[p] : 0.0f;
  unsigned rest = same;
  for (int j = 0; j < rounds; ++j) {   // the same count in every lane
    const int q = __ffs(rest) - 1;
    rest &= rest - 1;
    const float vq = __shfl_sync(0xffffffffu, v, q < 0 ? lane : q);
    if (j < n) sum += vq;
  }
  if (lead) segf[p] = sum;
  __syncwarp();
}

__global__ void __launch_bounds__(DWARPS * 32)
ell_densify_kernel(const int* __restrict__ cols,
                   const float* __restrict__ vals, float* D, int n1, int w,
                   int n_src, long long ldd, int nseg) {
  __shared__ float4 seg_all[DWARPS][DSEG / 4];
  const int lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * DWARPS + (threadIdx.x >> 5);
  if (u >= (long long)n1 * nseg) return;  // whole warps; no block barrier
  const long long r = u / nseg;
  const int p0 = (int)(u - r * nseg) * DSEG;
  float* row = D + r * ldd;
  const int m = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  if (p0 >= n_src + m) return;
  float4* seg = seg_all[threadIdx.x >> 5];
  float* segf = reinterpret_cast<float*>(seg);
#pragma unroll
  for (int i = 0; i < DQ; ++i)
    seg[lane + 32 * i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncwarp();
  const int* cr = cols + r * (long long)w;
  const float* vr = vals + r * (long long)w;
  for (int k0 = 0; k0 < w; k0 += 32 * DB) {
    int cb[DB];
    float vb[DB];
#pragma unroll
    for (int b = 0; b < DB; ++b) {   // DB loads a lane in flight at once
      const int k = k0 + 32 * b + lane;
      vb[b] = k < w ? vr[k] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < DB; ++b)     // a pad's column is not read
      cb[b] = vb[b] != 0.0f ? cr[k0 + 32 * b + lane] : -1;
#pragma unroll
    for (int b = 0; b < DB; ++b) {
      // A sum that starts at +0.0f is never -0.0f, so adding 0.0f of
      // either sign leaves it unchanged: zero-valued slots (the pads) are
      // skipped without changing a bit.
      const int p = cb[b] >= 0 && cb[b] < n_src ? cb[b] + m - p0 : -1;
      densify_chunk(segf, p >= 0 && p < DSEG ? p : -1, vb[b], lane);
    }
  }
  // Each quad is written once: lane l stores quads l + 32 i, so a warp
  // store is 512 contiguous bytes.
  float* base = row - m;
#pragma unroll
  for (int i = 0; i < DQ; ++i)
    densify_put(base, p0 + 4 * (lane + 32 * i), m, n_src, seg[lane + 32 * i]);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename OutT>
int launch_f32(const float* A, const float* B, const float* acc, OutT* C,
               int M, int N, int K, long long lda, long long ldb,
               long long ldacc, long long ldc, cudaStream_t s) {
  // 16-byte staging: A and B rows start on 16-byte boundaries.
  const bool vec = aligned16(A) && aligned16(B) && lda % 4 == 0 &&
                   ldb % 4 == 0;
  // Four-element stores: C rows on 4 * sizeof(OutT) bytes, acc on 16.
  const bool vec_out =
      (reinterpret_cast<uintptr_t>(C) % (4 * sizeof(OutT))) == 0 &&
      ldc % 4 == 0 && (acc == nullptr || (aligned16(acc) && ldacc % 4 == 0));
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (vec)
    gemm_f32_kernel<true, OutT><<<grid, THREADS, SMEM_BYTES, s>>>(
        A, B, acc, C, M, N, K, lda, ldb, ldacc, ldc, vec_out);
  else
    gemm_f32_kernel<false, OutT><<<grid, THREADS, SMEM_BYTES, s>>>(
        A, B, acc, C, M, N, K, lda, ldb, ldacc, ldc, vec_out);
  return (int)cudaGetLastError();
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

// A [rows, cols] bf16 matrix with row stride ld as a TMA map with boxes of
// `box_rows` rows x 64 columns (128 B, the swizzle span), zero fill
// outside.
bool make_map(CUtensorMap* map, const void* base, long long rows, int cols,
              long long ld, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The widest copy (16, 8, 4 or 2 bytes) that every row of a bf16 operand
// at p with row stride ld (elements) starts on a multiple of.  TMA takes
// the operand when it is 16: a 16-byte-aligned base and a row stride of a
// multiple of 16 bytes (`ops.gemm_bf16_route`).
int copy_width(const void* p, long long ld) {
  const unsigned long long x =
      reinterpret_cast<uintptr_t>(p) | (unsigned long long)(ld * 2) | 16ull;
  return (int)(x & (~x + 1));
}

// The tile of the bf16 body, from N and K only (never M): 0 and 1 are
// 64 x 64 with one consumer warpgroup (a ring of 4 or 8 k-stages), 2 is
// 128 x 128 and 3 is 128 x 256 with two.
int bf16_tile(int N, int K) {
  if (K <= 256) return 0;          // short K: latency
  if (N <= 128) return 1;          // tall K, narrow N: streaming x
  return N <= 1024 ? 2 : 3;        // the tensor-core rate
}

template <int NWG, int BN, int STAGES>
int launch_bf16(const void* A, const void* B, const float* acc, void* C,
                int out_bf16, int M, int N, int K, long long lda,
                long long ldb, long long ldacc, long long ldc,
                cudaStream_t s) {
  using L = Bf16Tile<NWG, BN, STAGES>;
  const int wa = copy_width(A, lda), wb = copy_width(B, ldb);
  const bool tma = wa == 16 && wb == 16;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  // K == 0 loads nothing (and a map needs a dimension of at least 1).
  if (tma && K > 0 && !(make_map(&maps[0], A, M, K, lda, L::BM) &&
                        make_map(&maps[1], B, K, N, ldb, XBK)))
    return (int)cudaErrorNotSupported;
  const size_t es = out_bf16 ? 2 : 4;
  const bool vec_out =
      (reinterpret_cast<uintptr_t>(C) % (2 * es)) == 0 && ldc % 2 == 0 &&
      (acc == nullptr ||
       ((reinterpret_cast<uintptr_t>(acc) & 7) == 0 && ldacc % 2 == 0));
  auto kernel = tma ? &gemm_bf16_kernel<NWG, BN, STAGES, true>
                    : &gemm_bf16_kernel<NWG, BN, STAGES, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + L::BM - 1) / L::BM);
  kernel<<<grid, L::THREADS, L::SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(B), acc, C, out_bf16, M, N, K, lda,
      ldb, ldacc, ldc, wa, wb, vec_out, maps[0], maps[1]);
  return (int)cudaGetLastError();
}

}  // namespace

// C = acc + A * B.  Returns cudaGetLastError() after the launch (0 when
// there is nothing to compute).
extern "C" int gemm_f32(const float* A, const float* B, const float* acc,
                        float* C, int M, int N, int K, long long lda,
                        long long ldb, long long ldacc, long long ldc,
                        void* stream) {
  if (M <= 0 || N <= 0) return 0;
  return launch_f32<float>(A, B, acc, C, M, N, K, lda, ldb, ldacc, ldc,
                           (cudaStream_t)stream);
}

// C = acc + A * B with A, B in bf16 (in_bf16) or fp32 and C in bf16
// (out_bf16) or fp32; acc is fp32 (or null), the sum fp32.  bf16 operands
// take the wgmma body (TMA or staged, by `copy_width`), fp32 ones the fp32
// kernel.  Returns cudaGetLastError() after the launch (0 when there is
// nothing to compute; cudaErrorNotSupported if the driver refuses a TMA
// map the operands qualify for).
extern "C" int gemm_mixed(const void* A, const void* B, const float* acc,
                          void* C, int in_bf16, int out_bf16, int M, int N,
                          int K, long long lda, long long ldb,
                          long long ldacc, long long ldc, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!in_bf16) {
    const float *a = static_cast<const float*>(A),
                *b = static_cast<const float*>(B);
    return out_bf16 ? launch_f32(a, b, acc, static_cast<__nv_bfloat16*>(C),
                                 M, N, K, lda, ldb, ldacc, ldc, s)
                    : launch_f32(a, b, acc, static_cast<float*>(C), M, N, K,
                                 lda, ldb, ldacc, ldc, s);
  }
  switch (bf16_tile(N, K)) {
    case 0:
      return launch_bf16<1, 64, 4>(A, B, acc, C, out_bf16, M, N, K, lda,
                                   ldb, ldacc, ldc, s);
    case 1:
      return launch_bf16<1, 64, 8>(A, B, acc, C, out_bf16, M, N, K, lda,
                                   ldb, ldacc, ldc, s);
    case 2:
      return launch_bf16<2, 128, 4>(A, B, acc, C, out_bf16, M, N, K, lda,
                                    ldb, ldacc, ldc, s);
    default:
      return launch_bf16<2, 256, 4>(A, B, acc, C, out_bf16, M, N, K, lda,
                                    ldb, ldacc, ldc, s);
  }
}

// What gemm_mixed does with bf16 operands of these pointers, strides and
// sizes: 2 * its tile (`bf16_tile`) + 1 where TMA loads them (0: staged).
extern "C" int gemm_bf16_plan(const void* A, const void* B, int N, int K,
                              long long lda, long long ldb) {
  return 2 * bf16_tile(N, K) +
         (copy_width(A, lda) == 16 && copy_width(B, ldb) == 16);
}

// D[r, :] = the sum over slots k of vals[r, k] at column cols[r, k], for
// an [n1, w] ELL tile (cols, vals contiguous) into D [n1, n_src] with row
// stride ldd; columns outside [0, n_src) are dropped.  Returns
// cudaGetLastError() after the launch (0 when there is nothing to do).
extern "C" int ell_densify_f32(const int* cols, const float* vals, float* D,
                               int n1, int w, int n_src, long long ldd,
                               void* stream) {
  if (n1 <= 0 || n_src <= 0) return 0;
  // A row's positions run from its 16-byte boundary: m floats before its
  // first column, the same m for every row where ldd is a multiple of 4,
  // at most 3 where rows differ.
  const int m =
      ldd % 4 == 0 ? (int)((reinterpret_cast<uintptr_t>(D) >> 2) & 3) : 3;
  const int nseg = (n_src + m + DSEG - 1) / DSEG;
  const long long warps = (long long)n1 * nseg;
  ell_densify_kernel<<<(unsigned)((warps + DWARPS - 1) / DWARPS),
                       DWARPS * 32, 0, (cudaStream_t)stream>>>(
      cols, vals, D, n1, w, n_src, ldd, nseg);
  return (int)cudaGetLastError();
}
