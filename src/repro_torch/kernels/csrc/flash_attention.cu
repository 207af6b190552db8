// Flash attention forward for the LM prefill path:
//
//   out[bh] = softmax(q[bh] . k[bh / G]^T * scale [+ causal mask]) . v[bh / G]
//
// per row block of q, with the online max/sum recurrence and fp32 running
// max, sum and accumulator.  The causal mask is the Pallas kernel's index
// mask qpos >= kpos, both counted from 0.  G query heads share one KV head
// (grouped-query attention; G = 1 is one KV head per query head).
//
// Replaces: src/repro/kernels/flash_attention.py, `flash_attention` /
// `_flash_kernel` (the Pallas kernel: grid (B*H, Tq/bq), the whole [Tk, d]
// K and V of one head in VMEM, a loop over KV blocks with fp32 m / l / acc
// scratch, causal skip of KV blocks strictly after the query block).  On
// the port's path it is reached through src/repro_torch/kernels/ops.py
// `flash_attention` from src/repro_torch/models/attention.py `attention`
// (causal self-attention with default positions, every layer of
// DecoderLM.forward).
//
// What bounds it on an H100: operations.  At the path shape (qwen3-0.6b
// prefill, B=4, T=2048: BH = 64 query heads over 32 KV heads, d = 128,
// bf16, causal) the call needs 4 * BH * d * T(T+1)/2 = 68.8 GFLOP of
// products (0.069 ms at the 989 TFLOP/s bf16 tensor-core rate) and moves
// q and out (67 MB) and k and v (34 MB with grouped heads, 67 MB with one
// KV head per query head): 0.030-0.040 ms at 3.35 TB/s.  In fp32 the
// products run on CUDA cores (67 TFLOP/s): 1.0 ms.
//
// Design.  Hopper runs blocks in parallel, so the Pallas grid's sequential
// KV walk becomes a loop inside one CTA per (bh, query tile), with the
// running statistics in registers; K and V are staged through shared
// memory one key tile at a time (the Pallas kernel keeps the whole [Tk, d]
// head in VMEM, which would not fit in 227 KB at T = 2048).  Query tiles
// are issued heaviest first (the last causal tiles walk the most keys).
// Ragged edges are masked in the kernel: rows past Tq are computed on
// zeros and not stored, keys past Tk score nothing, columns past d are zero
// in shared memory, so any Tq, Tk >= 1 and d <= 128 work.  KV tiles
// strictly after the query tile are skipped under causal masking, as in the
// Pallas kernel (their keys are masked for every row, so skipping them is
// exact).  Every sum runs in one fixed order with no atomics, so results
// are deterministic.  Two bodies:
//  * bf16 inputs: tensor cores through wgmma, Hopper's warpgroup MMA.  A
//    CTA owns 128 query rows: two consumer warpgroups of 64 rows each (K
//    and V are read from L2 once per 128 rows) and one producer warp.
//    The producer fills a ring of two shared-memory stages, each 128 keys
//    of K and V, ahead of the math with TMA (one thread; the hardware
//    writes the 128-byte swizzle and zero-fills past Tq, Tk and d) and
//    signals each stage on a `full` mbarrier; every consumer warp releases
//    a stage on an `empty` mbarrier once its products have read it.  No
//    CTA-wide barrier follows the start, so the two warpgroups drift apart
//    and one's softmax overlaps the other's products.  Q, K and V lie in
//    shared memory as 64-column panels of 128-byte rows whose 16-byte
//    chunks are XORed by row % 8 (wgmma's 128-byte swizzle).  S = Q.K^T
//    is wgmma m64n128k16 with both operands from shared memory (K-major);
//    its fp32 accumulators are, per warp, the m16n8k16 A fragments of
//    P.V, so P is rounded to bf16 in registers (as the JAX kernel rounds
//    it) and O += P.V is wgmma m64n{64,128}k16 with A from registers and V
//    read in its natural [keys, d] layout through the transpose bit
//    (MN-major).  Max, sum and rescaling run in fp32, the max on the raw
//    scores with the scale folded into the exponent's fma; the mask is
//    applied only on tiles that hold a masked key (the causal diagonal,
//    the ragged end of Tk).  Shared memory: Q 32 KB and two 64 KB K+V
//    stages at d = 128 (160 KB, one CTA of 9 warps per SM); 16 KB and
//    2 x 32 KB at d <= 64 (the staged width is at least one 64-column
//    panel).  Tensors TMA cannot take (d not a multiple of 8, a base not
//    16-byte aligned) are staged by the producer warp with plain loads
//    into the same layout.
//  * fp32 inputs: CUDA cores, IEEE fp32 throughout (the fp32 parities hold
//    it to 2e-5).  256 threads over 64 query rows; thread (rg, cg) owns
//    query rows 4rg..4rg+3, score columns cg + 16j and output columns
//    cg + 16j; row max and sum are reduced over the 16 lanes of a row
//    group by a fixed xor-shuffle tree; P goes through shared memory to
//    the P.V product, and K and V share one staging buffer (85 KB at
//    d = 128, two CTAs per SM).  Loads and math alternate behind
//    __syncthreads.
// The kernel launches on the caller's stream and allocates nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 64;           // fp32 body: query rows per CTA
constexpr int BK = 64;           // fp32 body: keys per staged KV tile
constexpr float NEG = -1e30f;    // initial running max (as the Pallas NEG)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int kv_tiles(int q0, int tk, int causal) {
  // Keys after the query tile's last row are masked for every row.
  const int end = causal ? min(tk, q0 + BQ) : tk;
  return (end + BK - 1) / BK;
}

// ------------------------------------------------------------------------ //
// fp32: CUDA cores.
// ------------------------------------------------------------------------ //
constexpr int SIMT_THREADS = 256;

template <int DP>
struct SimtSmem {
  static constexpr int LD = DP + 4;      // float4-aligned, conflict-free
  static constexpr int LDP = BK + 4;
  static constexpr int BYTES = (BQ * LD + BK * LD + BQ * LDP) * 4;
};

template <int DP>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int r0, int n_rows, int d) {
  constexpr int LD = SimtSmem<DP>::LD;
  for (int e = threadIdx.x; e < BK * DP; e += SIMT_THREADS) {
    const int r = e / DP, c = e % DP;
    const int gr = r0 + r;
    dst[r * LD + c] = (gr < n_rows && c < d) ? src[(long long)gr * d + c]
                                             : 0.0f;
  }
}

template <int DP>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int tq, int tk, int d, int causal, int group, float scale) {
  constexpr int LD = SimtSmem<DP>::LD;
  constexpr int LDP = SimtSmem<DP>::LDP;
  constexpr int OC = DP / 16;            // output columns per thread
  extern __shared__ float4 smem_f4[];
  float* Qs = reinterpret_cast<float*>(smem_f4);   // [BQ][LD]
  float* KVs = Qs + BQ * LD;                       // [BK][LD]: K, then V
  float* Ps = KVs + BK * LD;                       // [BQ][LDP]

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long bh = blockIdx.x;
  const long long bkv = (int)blockIdx.x / group;   // grouped KV heads
  const float* qb = q + bh * tq * d;
  const float* kb = k + bkv * tk * d;
  const float* vb = v + bkv * tk * d;

  stage_f32<DP>(Qs, qb, q0, tq, d);   // BQ == BK rows

  float m[4], l[4], o[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < OC; ++j) o[i][j] = 0.0f;
  }

  const int n_kt = kv_tiles(q0, tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // last tile's P.V reads done
    stage_f32<DP>(KVs, kb, k0, tk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(rg * 4 + i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&KVs[(cg + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + cg + 16 * j;
        const bool ok = kpos < tk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
        Ps[(rg * 4 + i) * LDP + cg + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(FULL, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC; ++j) o[i][j] *= alpha;
    }
    __syncthreads();                       // S reads of K done, P written
    stage_f32<DP>(KVs, vb, k0, tk, d);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(rg * 4 + i) * LDP + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &KVs[(kk + t) * LD + cg];
#pragma unroll
        for (int j = 0; j < OC; ++j) {
          const float vv = vrow[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = t == 0 ? pa[i].x : t == 1 ? pa[i].y
                          : t == 2 ? pa[i].z : pa[i].w;
            o[i][j] = fmaf(p, vv, o[i][j]);
          }
        }
      }
    }
  }

  float* ob = out + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= tq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int c = cg + 16 * j;
      if (c < d) ob[(long long)r * d + c] = o[i][j] * inv;
    }
  }
}

// ------------------------------------------------------------------------ //
// bf16: tensor cores through wgmma, K/V ring filled by cp.async.
// ------------------------------------------------------------------------ //
constexpr int WG_BQ = 128;       // query rows per CTA: two warpgroups of 64
constexpr int WG_BK = 128;       // keys per K/V stage (one m64n128 S)
constexpr int WG_STAGES = 2;     // K/V ring depth
constexpr int WG_CONSUMERS = 256;              // warps 0-7: two warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // warp 8: the producer
constexpr float LOG2E = 1.4426950408889634f;

template <int DP>
struct WgSmem {
  static constexpr int PN = DP < 64 ? 64 : DP;  // staged width, whole panels
  static constexpr int NP = PN / 64;            // 64-column panels
  static constexpr int Q_PANEL = WG_BQ * 128;   // bytes: 128 rows of 128 B
  static constexpr int KV_PANEL = WG_BK * 128;  // bytes: 128 rows of 128 B
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int STAGE = 2 * NP * KV_PANEL;  // K panels, then V panels
  static constexpr int BARS = Q_BYTES + WG_STAGES * STAGE;  // mbarriers
  // Barriers: full[STAGES], empty[STAGES], Q; + 1 KB to align the base to
  // the 1 KB swizzle period.
  static constexpr int BYTES = BARS + 8 * (2 * WG_STAGES + 1) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk holding columns c .. c+7 of row r, in
// 64-column panels of `panel` bytes with the 128-byte swizzle.
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

// The producer warp's fallback when TMA cannot take the tensors (d not a
// multiple of 8, or a base not 16-byte aligned): rows [r0, r0 + ROWS) x
// [0, PN) of a [n_rows, d] bf16 matrix, zero padded, by plain loads into
// the same swizzled panels (`panel` bytes each) that TMA writes.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_tile_warp(uint8_t* dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n_rows, int d,
                                                int panel, int lane) {
  constexpr int CPR = WgSmem<DP>::PN / 8;     // 16-byte chunks per row
  for (int e = lane; e < ROWS * CPR; e += 32) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const int gr = r0 + r;
    __align__(16) __nv_bfloat16 h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h[i] = (gr < n_rows && c + i < d) ? src[(long long)gr * d + c + i]
                                        : __float2bfloat16(0.0f);
    *reinterpret_cast<uint4*>(dst + swz(r, c, panel)) =
        *reinterpret_cast<uint4*>(h);
  }
}

__device__ __forceinline__ int wg_kv_tiles(int q0, int tk, int causal) {
  // Keys after the CTA's last query row are masked for every row.
  const int end = causal ? min(tk, q0 + WG_BQ) : tk;
  return (end + WG_BK - 1) / WG_BK;
}

// Warp 8 fills Q once and the K/V ring ahead of the consumers: with TMA
// (one thread, hardware swizzle, zero fill past Tq / Tk / d) or, for
// tensors TMA cannot take, by the whole warp with plain loads.  Each
// stage is reused once both warpgroups have released it.
template <int DP, bool TMA>
__device__ __forceinline__ void produce(
    uint8_t* Qs, uint8_t* ring, uint32_t bars, const __nv_bfloat16* qb,
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, int q0, int tq,
    int tk, int d, int n_kt, int bh, int bkv, const CUtensorMap* qmap,
    const CUtensorMap* kmap, const CUtensorMap* vmap) {
  using L = WgSmem<DP>;
  const int lane = threadIdx.x & 31;
  const uint32_t full = bars, empty = bars + 8 * WG_STAGES;
  const uint32_t qbar = bars + 16 * WG_STAGES;
  if (TMA) {
    if (lane != 0) return;
    mbar_expect_tx(qbar, L::Q_BYTES);
    for (int p = 0; p < L::NP; ++p)
      tma_load_3d(smem_u32(Qs + p * L::Q_PANEL), qmap, qbar, 64 * p, q0, bh);
  } else {
    stage_tile_warp<DP, WG_BQ>(Qs, qb, q0, tq, d, L::Q_PANEL, lane);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(qbar);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % WG_STAGES;
    // Tile kt - STAGES used this stage: wait for its release.
    if (kt >= WG_STAGES)
      mbar_wait(empty + 8 * st, ((kt / WG_STAGES) & 1) ^ 1);
    uint8_t* ks = ring + st * L::STAGE;
    uint8_t* vs = ks + L::NP * L::KV_PANEL;
    const int k0 = kt * WG_BK;
    if (TMA) {
      mbar_expect_tx(full + 8 * st, L::STAGE);
      for (int p = 0; p < L::NP; ++p) {
        tma_load_3d(smem_u32(ks + p * L::KV_PANEL), kmap, full + 8 * st,
                    64 * p, k0, bkv);
        tma_load_3d(smem_u32(vs + p * L::KV_PANEL), vmap, full + 8 * st,
                    64 * p, k0, bkv);
      }
    } else {
      stage_tile_warp<DP, WG_BK>(ks, kb, k0, tk, d, L::KV_PANEL, lane);
      stage_tile_warp<DP, WG_BK>(vs, vb, k0, tk, d, L::KV_PANEL, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(full + 8 * st);
    }
  }
}

template <int DP, bool TMA>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int tq, int tk, int d,
                  int causal, int group, float scale,
                  const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap) {
  using L = WgSmem<DP>;
  constexpr int KS = DP / 16;              // k-steps of Q.K^T
  constexpr int ON = L::PN / 2;            // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;                      // [NP][128 rows][128 B]
  uint8_t* ring = smem + L::Q_BYTES;       // stage s: K at s * STAGE, V after
  const uint32_t bars = smem_u32(smem + L::BARS);
  const uint32_t full = bars, empty = bars + 8 * WG_STAGES;
  const uint32_t qbar = bars + 16 * WG_STAGES;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;
  const int bh = blockIdx.x;
  const int bkv = bh / group;              // grouped KV heads: bh / G
  const int n_kt = wg_kv_tiles(q0, tk, causal);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);          // the producer's arrival (+ bytes)
      mbar_init(empty + 8 * s, 8);         // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the last CTA-wide barrier: the roles part here

  if (threadIdx.x >= WG_CONSUMERS) {
    produce<DP, TMA>(Qs, ring, bars, q + (long long)bh * tq * d,
                     k + (long long)bkv * tk * d,
                     v + (long long)bkv * tk * d, q0, tq, tk, d, n_kt, bh,
                     bkv, &qmap, &kmap, &vmap);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq0 = q0 + 64 * wg;            // this warpgroup's first row
  const int row_lo = wq0 + 16 * warp + g, row_hi = row_lo + 8;
  const float sl2 = scale * LOG2E;         // scores in the exp2 domain
  float o[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.0f;
  float m_lo = NEG, m_hi = NEG, l_lo = 0.0f, l_hi = 0.0f;
  const uint32_t q_s = smem_u32(Qs) + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % WG_STAGES;
    const int k0 = kt * WG_BK;
    mbar_wait(full + 8 * st, (kt / WG_STAGES) & 1);
    const uint32_t k_s = smem_u32(ring + st * L::STAGE);
    const uint32_t v_s = k_s + L::NP * L::KV_PANEL;

    // S = Q.K^T: 64 rows x 128 keys, fp32.
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t koff = (ks & 3) * 32;   // 16 columns = 32 B
      const uint64_t da = gmma_desc(q_s + (ks >> 2) * L::Q_PANEL + koff, 16,
                                    1024);
      const uint64_t db = gmma_desc(k_s + (ks >> 2) * L::KV_PANEL + koff, 16,
                                    1024);
      wgmma_ss_n128(s, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Mask where a key of the tile is masked; s[4i + e] is row row_lo
    // (e < 2) or row_hi, key k0 + 8i + 2 t4 + (e & 1).  The max is taken
    // on the raw scores (the scale is positive) and the scale folded into
    // the exponent's fma.
    const bool masked = (causal && k0 + WG_BK - 1 > wq0) || k0 + WG_BK > tk;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < WG_BK / 8; ++i) {
      if (masked) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * t4 + (e & 1);
          const int qpos = e < 2 ? row_lo : row_hi;
          if (kpos >= tk || (causal && kpos > qpos)) s[4 * i + e] = -INFINITY;
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
    const float a_lo = ex2(m_lo - mn_lo), a_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float rs_lo = 0.0f, rs_hi = 0.0f;   // this thread's part of the row sum
#pragma unroll
    for (int i = 0; i < WG_BK / 8; ++i) {
      s[4 * i] = ex2(fmaf(s[4 * i], sl2, -mn_lo));   // masked: ex2(-inf) = 0
      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl2, -mn_lo));
      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl2, -mn_hi));
      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl2, -mn_hi));
      rs_lo += s[4 * i] + s[4 * i + 1];
      rs_hi += s[4 * i + 2] + s[4 * i + 3];
    }
    l_lo = l_lo * a_lo + rs_lo;
    l_hi = l_hi * a_hi + rs_hi;
#pragma unroll
    for (int i = 0; i < ON / 4; ++i) {
      o[4 * i] *= a_lo;
      o[4 * i + 1] *= a_lo;
      o[4 * i + 2] *= a_hi;
      o[4 * i + 3] *= a_hi;
    }

    // O += P.V: the S accumulators of keys 16 kc .. 16 kc + 15 are the A
    // fragment of k-step kc.
    uint32_t pa[WG_BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < WG_BK / 16; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < WG_BK / 16; ++kc) {
      const uint64_t dv = gmma_desc(v_s + kc * 16 * 128, L::KV_PANEL, 1024);
      if constexpr (L::PN == 128)
        wgmma_rs_n128(o, pa[kc], dv, 1);
      else
        wgmma_rs_n64(o, pa[kc], dv, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();                          // the stage is read: release it
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(FULL, l_lo, off);
    l_hi += __shfl_xor_sync(FULL, l_hi, off);
  }
  const float inv_lo = 1.0f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.0f / fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = out + (long long)bh * tq * d;
#pragma unroll
  for (int i = 0; i < ON / 4; ++i) {
    const int c = 8 * i + 2 * t4;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = hi ? row_hi : row_lo;
      const float inv = hi ? inv_hi : inv_lo;
      if (r >= tq) continue;
      __nv_bfloat16* dst = ob + (long long)r * d + c;
      const float x0 = o[4 * i + 2 * hi] * inv;
      const float x1 = o[4 * i + 2 * hi + 1] * inv;
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < d) dst[0] = __float2bfloat16(x0);
        if (c + 1 < d) dst[1] = __float2bfloat16(x1);
      }
    }
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

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int bh, int tq, int tk, int d, int causal, int group,
               float scale, cudaStream_t stream) {
  auto kernel = flash_f32_kernel<DP>;
  const int smem = SimtSmem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + BQ - 1) / BQ);
  kernel<<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), tq, tk, d,
      causal, group, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int tq, int tk, int d, int causal, int group,
                float scale, cudaStream_t stream) {
  // TMA needs 16-byte row strides and bases (per-head offsets are then
  // multiples of 16 bytes too).
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma = (d % 8 == 0) &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
                   make_map(&maps[0], q, bh, tq, d, WG_BQ) &&
                   make_map(&maps[1], k, bh / group, tk, d, WG_BK) &&
                   make_map(&maps[2], v, bh / group, tk, d, WG_BK);
  auto kernel = tma ? flash_bf16_kernel<DP, true>
                    : flash_bf16_kernel<DP, false>;
  const int smem = WgSmem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + WG_BQ - 1) / WG_BQ);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), tq, tk, d, causal, group, scale,
      maps[0], maps[1], maps[2]);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             void* out, int bh, int tq, int tk, int d, int causal, int group,
             float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<DP>(q, k, v, out, bh, tq, tk, d, causal, group, scale,
                          stream);
  return launch_bf16<DP>(q, k, v, out, bh, tq, tk, d, causal, group, scale,
                         stream);
}

}  // namespace

// out[bh] = softmax(q[bh] k[bh / group]^T * scale, causal: qpos >= kpos)
// v[bh / group] for contiguous q / out [bh, tq, d] and k / v
// [bh / group, tk, d]; dtype 0 is fp32, 1 is bf16 (all four tensors),
// 1 <= d <= 128, group >= 1 divides bh, bh < 2^31, tq <= 4,194,240.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take; 0 when there is nothing to compute).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int bh, int tq, int tk, int d, int causal,
                                   int group, float scale, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0 || d <= 0 || d > 128 || (dtype != 0 && dtype != 1) ||
      group <= 0 || bh % group != 0 || (tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32) return dispatch<32>(dtype, q, k, v, out, bh, tq, tk, d,
                                   causal, group, scale, s);
  if (d <= 64) return dispatch<64>(dtype, q, k, v, out, bh, tq, tk, d,
                                   causal, group, scale, s);
  return dispatch<128>(dtype, q, k, v, out, bh, tq, tk, d, causal, group,
                       scale, s);
}
