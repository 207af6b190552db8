// Flash attention forward for the LM prefill path:
//
//   out[bh] = softmax(q[bh] . k[bh]^T * scale [+ causal mask]) . v[bh]
//
// per row block of q, with the online max/sum recurrence and fp32 running
// max, sum and accumulator.  The causal mask is the Pallas kernel's index
// mask qpos >= kpos, both counted from 0.
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
// prefill, B=4, T=2048: BH = 64 query heads with K/V heads repeated, d =
// 128, bf16, causal) the call moves 134 MB (q, k, v read once, out written
// once: 0.040 ms at 3.35 TB/s) and needs 4 * BH * d * T(T+1)/2 = 68.8 GFLOP
// of products (0.069 ms at the 989 TFLOP/s bf16 tensor-core rate).  In
// fp32 the products run on CUDA cores (67 TFLOP/s): 1.0 ms.
//
// Design.  Hopper runs blocks in parallel, so the Pallas grid's sequential
// KV walk becomes a loop inside one CTA per (bh, 64-row query tile), with
// the running statistics in registers; K and V are staged through shared
// memory 64 keys at a time (the Pallas kernel keeps the whole [Tk, d] head
// in VMEM, which would not fit in 227 KB at T = 2048).  Query tiles are
// issued heaviest first (the last causal tiles walk the most keys).  Ragged
// edges are masked in the kernel: rows past Tq are computed on zeros and
// not stored, keys past Tk score nothing, columns past d are zero in shared
// memory, so any Tq, Tk >= 1 and d <= 128 work.  KV tiles strictly after
// the query tile are skipped under causal masking, as in the Pallas kernel
// (their keys are masked for every row, so skipping them is exact).  Every
// sum runs in one fixed order with no atomics, so results are
// deterministic.  Two bodies:
//  * fp32 inputs: CUDA cores, IEEE fp32 throughout.  256 threads; thread
//    (rg, cg) owns query rows 4rg..4rg+3, score columns cg + 16j and output
//    columns cg + 16j; row max and sum are reduced over the 16 lanes of a
//    row group by a fixed xor-shuffle tree; P goes through shared memory
//    to the P.V product, and K and V share one staging buffer (85 KB at
//    d = 128, two CTAs per SM).
//  * bf16 inputs: tensor cores through mma.sync m16n8k16 (bf16 operands,
//    fp32 accumulate).  Four warps, each owning 16 query rows; the warp's Q
//    fragments stay in registers for the whole KV walk, S = Q.K^T lands in
//    registers in the accumulator layout, which is also the A-operand
//    layout of P.V, so P (rounded to bf16, as the tensor cores take it)
//    never leaves registers; V is staged transposed so its B fragments are
//    single 32-bit shared loads.  Max, sum and rescaling run in fp32.
// No cp.async / TMA pipelining and no wgmma yet: loads and math alternate
// behind __syncthreads.  The kernel launches on the caller's stream and
// allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per staged KV tile
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
                 int tq, int tk, int d, int causal, float scale) {
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
  const float* qb = q + bh * tq * d;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;

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
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate).
// ------------------------------------------------------------------------ //
constexpr int MMA_THREADS = 128;         // four warps x 16 query rows

template <int DP>
struct MmaSmem {
  static constexpr int LQ = DP + 8;      // bf16 stride of Q / K rows
  static constexpr int LV = BK + 8;      // bf16 stride of V^T rows
  static constexpr int BYTES = (BQ * LQ + BK * LQ + DP * LV) * 2;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [r0, r0 + 64) x [0, DP) of a [n_rows, d] bf16 matrix, zero
// padded, row-major into dst (stride LQ) or, with TRANS, transposed
// (dst[c * LV + r]).  16-byte loads when d is a multiple of 8 and src is
// 16-byte aligned (a contiguous view may start anywhere).
template <int DP, bool TRANS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r0,
                                           int n_rows, int d) {
  constexpr int LQ = MmaSmem<DP>::LQ;
  constexpr int LV = MmaSmem<DP>::LV;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  if ((d & 7) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int VPR = DP / 8;            // 8-element vectors per row
    for (int e = threadIdx.x; e < BK * VPR; e += MMA_THREADS) {
      const int r = e / VPR, c = (e % VPR) * 8;
      const int gr = r0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && c < d)
        val = *reinterpret_cast<const uint4*>(src + (long long)gr * d + c);
      if (!TRANS) {
        *reinterpret_cast<uint4*>(dst + r * LQ + c) = val;
      } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(c + i) * LV + r] = h[i];
      }
    }
  } else {
    for (int e = threadIdx.x; e < BK * DP; e += MMA_THREADS) {
      const int r = e / DP, c = e % DP;
      const int gr = r0 + r;
      const __nv_bfloat16 val =
          (gr < n_rows && c < d) ? src[(long long)gr * d + c] : zero;
      if (!TRANS)
        dst[r * LQ + c] = val;
      else
        dst[c * LV + r] = val;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int tq, int tk, int d,
                  int causal, float scale) {
  constexpr int LQ = MmaSmem<DP>::LQ;
  constexpr int LV = MmaSmem<DP>::LV;
  constexpr int KS = DP / 16;              // k-steps of Q.K^T
  constexpr int NT = BK / 8;               // 8-key column tiles of S
  constexpr int DN = DP / 8;               // 8-column tiles of O
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [BQ][LQ]
  __nv_bfloat16* Ks = Qs + BQ * LQ;                                // [BK][LQ]
  __nv_bfloat16* Vt = Ks + BK * LQ;                                // [DP][LV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long bh = blockIdx.x;
  const __nv_bfloat16* qb = q + bh * tq * d;
  const __nv_bfloat16* kb = k + bh * tk * d;
  const __nv_bfloat16* vb = v + bh * tk * d;

  stage_bf16<DP, false>(Qs, qb, q0, tq, d);
  __syncthreads();
  // The warp's A fragments of Q (rows 16 warp + g and + 8), all k-steps.
  uint32_t qf[KS][4];
  {
    const __nv_bfloat16* r0 = Qs + (warp * 16 + g) * LQ + t4 * 2;
    const __nv_bfloat16* r1 = r0 + 8 * LQ;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = lds32(r0 + ks * 16);
      qf[ks][1] = lds32(r1 + ks * 16);
      qf[ks][2] = lds32(r0 + ks * 16 + 8);
      qf[ks][3] = lds32(r1 + ks * 16 + 8);
    }
  }
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  const int n_kt = kv_tiles(q0, tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // last tile's reads done
    stage_bf16<DP, false>(Ks, kb, k0, tk, d);
    stage_bf16<DP, true>(Vt, vb, k0, tk, d);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + g) * LQ + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qf[ks], lds32(kr + ks * 16), lds32(kr + ks * 16 + 8));
    }

    // Scale and mask; s[nt][0..1] belong to row0, s[nt][2..3] to row1.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int qpos = e < 2 ? row0 : row1;
        const bool ok = kpos < tk && (!causal || kpos <= qpos);
        s[nt][e] = ok ? s[nt][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rs0 += __shfl_xor_sync(FULL, rs0, off);
      rs1 += __shfl_xor_sync(FULL, rs1, off);
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }

    // O += P.V: the S accumulators of key tiles 2kc, 2kc+1 are the A
    // fragment of k-step kc.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vr = Vt + g * LV + kc * 16 + t4 * 2;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        mma_bf16(o[dn], pa, lds32(vr + dn * 8 * LV),
                 lds32(vr + dn * 8 * LV + 8));
    }
  }

  __nv_bfloat16* ob = out + bh * tq * d;
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c = dn * 8 + t4 * 2;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? row0 : row1;
      const int cc = c + (e & 1);
      if (r < tq && cc < d)
        ob[(long long)r * d + cc] =
            __float2bfloat16(o[dn][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int smem, int threads, const void* q,
           const void* k, const void* v, void* out, int bh, int tq, int tk,
           int d, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + BQ - 1) / BQ);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), tq, tk, d, causal,
      scale);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             void* out, int bh, int tq, int tk, int d, int causal,
             float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_f32_kernel<DP>, SimtSmem<DP>::BYTES,
                         SIMT_THREADS, q, k, v, out, bh, tq, tk, d, causal,
                         scale, stream);
  return launch<__nv_bfloat16>(flash_bf16_kernel<DP>, MmaSmem<DP>::BYTES,
                               MMA_THREADS, q, k, v, out, bh, tq, tk, d,
                               causal, scale, stream);
}

}  // namespace

// out[bh] = softmax(q[bh] k[bh]^T * scale, causal: qpos >= kpos) v[bh] for
// contiguous q / out [bh, tq, d] and k / v [bh, tk, d]; dtype 0 is fp32,
// 1 is bf16 (all four tensors), 1 <= d <= 128, bh < 2^31, tq <= 4,194,240.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// arguments the kernel does not take; 0 when there is nothing to compute).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int bh, int tq, int tk, int d, int causal,
                                   float scale, void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  if (tk <= 0 || d <= 0 || d > 128 || (dtype != 0 && dtype != 1) ||
      (tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32) return dispatch<32>(dtype, q, k, v, out, bh, tq, tk, d,
                                   causal, scale, s);
  if (d <= 64) return dispatch<64>(dtype, q, k, v, out, bh, tq, tk, d,
                                   causal, scale, s);
  return dispatch<128>(dtype, q, k, v, out, bh, tq, tk, d, causal, scale, s);
}
