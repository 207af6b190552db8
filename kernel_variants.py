#!/usr/bin/env python3
"""Tile-shape variants of the GEMM (its fp32 kernel and its bf16 body),
the densify kernel, SpDMM, SDDMM and flash kernels, read beside the
kernels themselves on one GPU, and planted faults in the GEMM's bf16
body.

    python3 kernel_variants.py [--parent DIR] [--only KERNEL ...]
                               [--json-out PATH]

Builds ``src/repro_torch/kernels/csrc/gemm.cu``, ``sddmm.cu`` and
``flash_attention.cu`` and one copy of each per entry of ``VARIANTS`` (a text edit of the source that
changes a tile or block constant; each edited text must appear in the
source exactly once), one ``nvcc`` per source, all at once, under the
git-ignored ``src/repro_torch/kernels/_build/variants/``
(``build.build_copies``); the sources in the checkout are not touched.
With ``--parent DIR`` (a checkout of another tree, for example an
unpacked ``git archive`` of the parent commit) that tree's GEMM, SDDMM
and flash sources are built as the variant ``parent`` (a flash source
whose entry has no dv argument is called with V zero-padded to d).  Each variant is called
through the unchanged ``ops.gemm`` / ``ops.sddmm`` /
``ops.flash_attention`` wrappers (``ops.entry`` swapped) and:

* held against the plain version on ``chip_smoke.py``'s ragged sweeps and
  the path shapes (fp32 rtol 1e-5 / atol 1e-4; the unmasked SDDMM sweep
  at the JAX sweep's 1e-4 / 1e-4), and compared bit for bit with the
  kernel in the checkout (a GEMM variant keeps each element's sum order,
  so it must be equal; an SDDMM variant keeps each slot's);
* timed as ``chip_smoke.py`` times kernels (median of 5 trials of 20
  calls queued behind a spin kernel): GEMM at 4096x128xN, N in {128, 64,
  8}, strided views, and at the remapped shape 4096x4096x128 (a dense
  block times a strided view), C = A.B and C = acc + A.B, beside
  ``torch.matmul`` and ``torch.addmm``; SDDMM on the widest ELL slice of full-scale Flickr
  (n1 = 4096, n2 = 128, the partition every FL program uses, its real
  mask), on the synthetic hub tile of ``chip_smoke.py`` and on two
  narrow tiles (w = 8 and 64, row lengths uniform in [0, w]), with an
  accumulator, beside ``torch.sparse.sampled_addmm``; flash (bf16,
  causal) at the B=4, T=2048 prefill shapes of gemma3-12b (d = 240,
  without and with the window of 1024), gemma3-27b (d = 168), deepseek-v3's
  MLA call (BH = 512, d = 192, V 128 wide) and qwen3-0.6b (d = 128), each
  under ``chip_smoke.check_rows`` against the plain version, with its
  bound and whether its bits equal the checkout's kernel's.

The densify kernel (``--only densify``; variants that store zeros first
and the sums over them, store without the streaming hint, own 1,024- or
4,096-position segments, read every slot's column, load 4 or 16 chunks
ahead, or broadcast a chunk's slots one at a time, each a text edit of
``gemm.cu`` called through its entry; the ``DIAGNOSTIC`` builds that
only store the zeros or only walk are timed only; with ``--parent`` the
parent tree's ``gemm.cu``) is held bit for bit to ``ref.densify_ref``,
twice alike, on the widest FL slice (its real values) and
``chip_smoke.densify_cases`` (unaligned n_src, duplicates over quads and
segments, out-of-range columns, the hub-heavy tile), and timed on the FL
slice and the hub-heavy tile beside ``index_put_(accumulate=True)``, a
``zero_`` of the same block (the write rate a library call reaches) and
the bound; each build's registers and spills are printed.  ``--only
sddmm`` also runs bf16 operands through every build's ``sddmm_bf16``
entry on both routes (8-byte loads, and rows one element off), bit for
bit the fp32 kernel on the widened operands (``bf16_load16``, 16-byte
loads in another sum order, and the parent only to tolerance), and times
the vector route per build beside the checkout's scalar route and its
fp32 operands on the four tiles.

The GEMM's bf16 body (``--only gemm_bf16``; variants of its tile width,
stage count and consumer warpgroups, each a text edit of ``gemm.cu``
called through the ``gemm_mixed`` entry, and with ``--parent`` the parent
tree's ``gemm_mixed``) is held on ``chip_smoke.py``'s bf16 sweep and tile
shapes within rtol 2e-2 / atol 1e-2 of the plain version and, but for the
parent, bit for bit the checkout's body, timed at
``chip_smoke.GEMM_BF16_TIMED`` (4096x128x128 with a strided x,
4096x4096x128, 4096x4096x4096) beside bf16 ``torch.matmul``; then each
of ``GEMM_FAULTS`` (copies of ``gemm.cu`` with one planted fault, built
beside the variants) must fail ``chip_smoke.gemm_bf16_check``, which the
checkout's body passes.

The single-pass flash body past d = 256 (``--only flash_wide``; variants
that form the whole S in each consumer warpgroup instead of exchanging
halves, that take 64-key tiles in one slot, or 32-key tiles in one slot,
and in a cluster (past d = 576 or dv > 512) that lock every CTA of it
together with one barrier.cluster a tile, keep one partial-S slot a CTA
instead of two, or have each CTA form the whole S itself, each a text
edit of ``flash_attention.cu``, and with ``--parent`` the parent tree's
flash source) is held to the plain version with
``chip_smoke.check_rows`` on ``chip_smoke.CONTRACT_MODES`` at
``FLASH_WIDE_CHECKED`` and at the timed rows, each build's two launches
bit for bit and, within one CTA's reach, its bits against the checkout's
and the parent's, and timed at ``FLASH_WIDE_TIMED`` (d = 512 at BH = 32,
T = 2048; the absorbed-MLA shape, BH = 128 over one KV head, d = 576, dv
= 512; d = 1,024 and 2,048 at BH = 32, clusters of 2 and 4, where only
the checkout's body, the parent's and the cluster variants are timed)
beside ``F.scaled_dot_product_attention`` (its backend named), the plain
version and the bound.

The fp32 flash bodies (``--only flash_f32``; variants with one ring slot
instead of two, 64 query rows a CTA instead of 128, 32-key slots (the
smaller micro-tile) and, in a cluster, one barrier.cluster a tile or one
partial-S slot, each a text edit of ``flash_attention.cu``, and with
``--parent`` the parent tree's flash source) are held to the plain version at rtol 1e-5 / atol 1e-4 on
``chip_smoke.CONTRACT_MODES`` at ``FLASH_F32_CHECKED`` and at the timed
rows, each build's bits compared with the checkout's and with a second
launch of its own, and timed at ``FLASH_F32_TIMED`` (qwen3-0.6b's prefill
heads, BH = 64 over 32, d = 128; d = 512 at BH = 32; T = 2048, causal)
beside fp32 ``F.scaled_dot_product_attention`` (``enable_gqa=True`` and on
KV heads repeated) and the bound.

The bf16 flash body at d <= 128 (``--only flash_d128``: the
warp-specialised body at DQK 64 / 128; variants without the ping-pong,
without ``setmaxnreg``, with heads fastest (the old body's grid order) or in
groups of 8 at every shape, with two consumer warpgroups or 64-key tiles
at DQK 64, with three ring slots, with a quarter or half of the
exponentials on the FMA pipe, with O's rescale skipped where its factor is
1, and with the phase probe, each a text edit of ``flash_attention.cu``;
the ``DIAGNOSTIC`` build without the exponentials is timed only; with
``--parent`` the parent tree's flash source and, as ``parent_probe``,
that source with the same probe planted in its body at d <= 128
(``PARENT_PROBE``)) is held by ``chip_smoke.check_rows`` at
``FLASH_D128_SHAPES`` (the eight path shapes of that body), each build's
bits compared with the checkout's and with a second launch of its own,
and timed beside ``F.scaled_dot_product_attention`` and the bound.  A probe build stamps
``clock64`` in one CTA (the first head's heaviest query tile) at each
phase of each tile for both consumer warpgroups; at
``FLASH_D128_PROBED`` (qwen3-0.6b's and hymba-1.5b's prefill) each
phase's share of the tiles is printed, with the share in which a
warpgroup has no product of its own in flight and in which neither has
(``probe_shares``).  The registers and spills of both bodies'
instantiations come from the builds' ``-Xptxas -v`` reports.

The SpDMM kernel (``--only spdmm``; variants of its span length, no
span split, registers and blocks an SM, rows a block, the hub pass's
gathers in flight and the old share of a round's spans, each a text
edit of ``spdmm.cu`` called through its step-list and one-step entries;
"per_step", the checkout's build called a step at a time; with
``--parent`` the parent tree's source, whose one-step entries run each
list a step at a time) runs on full-scale Flickr's b2 program: the
widest slice as a one-step call, a synthetic slice with the same walked
slots spread at <= 64 a row, and the widest slice's row block as one
step list (every hub threshold of the checkout's build too), each held
to the plain version and, for the builds that keep the sum order, to
the checkout's bits, timed beside ``torch.sparse.mm`` / ``torch.addmm``
and the bound; then a replayed b2@FL and gat-dot@FL hit per route under
the profiler, its SpDMM launches binned by walked slots and longest row
(``chip_smoke.launch_histogram``).

The kernel in the checkout is timed first and last (change, variants,
change), so its two readings show the drift within the call.  It exits
non-zero if a build fails, the checkout's kernel or a variant fails its
check, a variant that must be bit-identical is not, or a planted fault
passes.  The last line of
the output is the readings as JSON.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Past 48 KB of shared memory a launch needs the opt-in (deeper rings at
# 64-column tiles); harmless below it.
_OPT_IN = ("  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);\n",
           "  cudaFuncSetAttribute(gemm_f32_kernel<true, OutT>,\n"
           "      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);\n"
           "  cudaFuncSetAttribute(gemm_f32_kernel<false, OutT>,\n"
           "      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);\n"
           "  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);\n")

# The warp-specialised flash body's ping-pong (named barriers 1 and 2)
# and register split, each removed.
_NO_PINGPONG = [('  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), '
                 '"n"(WS_CONSUMERS) : "memory");\n', ""),
                ('  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), '
                 '"n"(WS_CONSUMERS)\n               : "memory");\n', "")]
_NO_SETMAXNREG = [("    regs_dec<L::PRODUCER_REGS>();\n", ""),
                  ("    regs_inc<L::CONSUMER_REGS>();\n", "")]
# The clusters in lock step (both bodies' cl_barrier): one barrier.cluster
# a tile in place of the slots' written / read mbarriers.  Every thread of
# the cluster meets it, the bf16 producers too: each after a tile's first
# round of K (the cluster's barrier of tile kt - 1; V of kt waits for the
# release of tile kt - 2's V, which follows the exchange of kt - 1) and
# once more at its end; only the producer threads that load wait on the
# slots (an idle thread could see a slot's barrier two phases on, and
# wait for ever on a parity that came back).
_CL_LOCKSTEP = [
    ("  if (tma && pt != 0) return;   // one thread issues TMA\n",
     "  constexpr bool LOCKSTEP = MODE != 0;\n"
     "  if (tma && pt != 0 && !LOCKSTEP) return;\n"
     "  const bool waits = !LOCKSTEP || !tma || pt == 0;\n"),
    ("        if (rs > 0) mbar_wait(q_empty, (rs - 1) & 1);",
     "        if (waits && rs > 0) mbar_wait(q_empty, (rs - 1) & 1);"),
    ("      if (rs >= SL) mbar_wait(empty_k + 8 * slot, (use & 1) ^ 1);",
     "      if (waits && rs >= SL) mbar_wait(empty_k + 8 * slot, (use & 1) "
     "^ 1);"),
    ("L::KV_PANEL, bkv, full_k + 8 * slot,\n                     pt);\n"
     "    }\n",
     "L::KV_PANEL, bkv, full_k + 8 * slot,\n                     pt);\n"
     "      if constexpr (LOCKSTEP) {\n"
     "        if (j == 0 && kt > kt0) cluster_sync();\n"
     "      }\n    }\n"),
    ("    if (step >= SL) mbar_wait(empty_v + 8 * slot, (use & 1) ^ 1);",
     "    if (waits && step >= SL) mbar_wait(empty_v + 8 * slot, (use & 1) "
     "^ 1);"),
    ("L::KV_PANEL, bkv, full_v + 8 * slot,\n                   pt);\n"
     "  }\n}\n",
     "L::KV_PANEL, bkv, full_v + 8 * slot,\n                   pt);\n"
     "  }\n  if constexpr (LOCKSTEP) {\n"
     "    if (kt0 < n_kt) cluster_sync();\n  }\n}\n"),
    ("  if (use > 0) mbar_wait_cluster(x_empty + 8 * slot, (use - 1) & 1);\n",
     ""),
    ('  asm volatile("bar.sync %0, %1;\\n" ::"n"(BAR), "n"(NT) : "memory");\n'
     "  cl_arrive_all(x_full + 8 * slot, nc);\n"
     "  mbar_wait_cluster(x_full + 8 * slot, use & 1);\n",
     "  cluster_sync();\n"),
    ("  __syncthreads();   // both halves' sums written, every peer read "
     "done\n  cl_arrive_all(x_empty + 8 * slot, nc);\n",
     "  __syncthreads();   // both halves' sums written, every peer read "
     "done\n"),
    ("  // Every consumer thread of the CTA has passed its peer reads.\n"
     "  cl_arrive_all(x_empty + 8 * slot, nc);\n", ""),
]
# Variants run for their time alone (their output is not held to the
# plain version): measurements of where a tile's time goes.
DIAGNOSTIC = ("diag_no_ex2", "cl_diag_own", "cl_diag_nowait",
              "diag_fill", "diag_no_store")


# Part of the softmax's exponentials on the FMA pipe instead of the SFU
# (MUFU.EX2, 16 lanes an SM): 2^x = 2^j 2^f with j = round(x), f in [-0.5,
# 0.5], 2^f a degree-3 polynomial (relative error 1.0e-4, a fortieth of
# a bf16 ulp) and 2^j added to its exponent bits; 0 below x = -125 (the
# SFU's flush gives 0 below -126).  ``n`` of every 4 groups of a thread's
# 4 scores take it.
def _ex2_fma(n):
    return [
        ("__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) "
         "{\n",
         "__device__ __forceinline__ float ex2_fma(float x) {\n"
         "  const float t = x + 12582912.0f;   // 1.5 * 2^23: j = round(x)\n"
         "  const float f = x - (t - 12582912.0f);\n"
         "  const float p = fmaf(fmaf(fmaf(0.05500893f, f, 0.24221098f), f,\n"
         "                            0.69328290f), f, 1.0f);\n"
         "  const int b = __float_as_int(p) + (__float_as_int(t) << 23);\n"
         "  return x < -125.0f ? 0.0f : __int_as_float(b);\n"
         "}\n"
         f"constexpr int EX2_FMA_OF_4 = {n};\n"
         "__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) "
         "{\n"),
        ("    s[4 * i] = ex2(fmaf(s[4 * i], sl2, -mn_lo));   // masked: "
         "ex2(-inf) = 0\n"
         "    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl2, -mn_lo));\n"
         "    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl2, -mn_hi));\n"
         "    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl2, -mn_hi));\n",
         "    if (i % 4 < EX2_FMA_OF_4) {\n"
         "      s[4 * i] = ex2_fma(fmaf(s[4 * i], sl2, -mn_lo));\n"
         "      s[4 * i + 1] = ex2_fma(fmaf(s[4 * i + 1], sl2, -mn_lo));\n"
         "      s[4 * i + 2] = ex2_fma(fmaf(s[4 * i + 2], sl2, -mn_hi));\n"
         "      s[4 * i + 3] = ex2_fma(fmaf(s[4 * i + 3], sl2, -mn_hi));\n"
         "    } else {\n"
         "      s[4 * i] = ex2(fmaf(s[4 * i], sl2, -mn_lo));\n"
         "      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl2, -mn_lo));\n"
         "      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl2, -mn_hi));\n"
         "      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl2, -mn_hi));\n"
         "    }\n")]


# The warp-specialised body's CTA order: heads in groups of 8 where the K
# and V of all heads exceed WS_ALL_HEADS_KV_BYTES, else heads fastest over
# all BH; or either everywhere.
_WS_HEAD_RULE = ("  const int head_group = kv_bytes <= WS_ALL_HEADS_KV_BYTES ? bh\n"
                 "                                                           "
                 ": WS_HEAD_GROUP;\n")
# The phase probe: clock64 stamps of one CTA's (up to three) consumer
# warpgroups,
# PROBE_MARKS a tile for up to PROBE_TILES tiles each, in a device array
# the entry flash_probe_read copies out (flash_probe_clear zeroes it and
# the grid probe's); the grid probe (the warp-specialised body's only):
# for each of the first PROBE_CTAS CTAs, CTA_MARKS stamps (below).
PROBE_TILES, PROBE_MARKS, PROBE_CTAS, CTA_MARKS = 32, 8, 8192, 8
_PROBE_COMMON = [
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     f"constexpr int PROBE_TILES = {PROBE_TILES}, PROBE_MARKS = "
     f"{PROBE_MARKS};\n"
     f"constexpr int PROBE_CTAS = {PROBE_CTAS}, CTA_MARKS = {CTA_MARKS};\n"
     "__device__ long long flash_probe[3 * PROBE_TILES * PROBE_MARKS];\n"
     "__device__ long long flash_probe_cta[PROBE_CTAS * CTA_MARKS];\n"
     "__device__ __forceinline__ long long probe_ns() {\n"
     "  long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n"
     "}\n"
     "__device__ __forceinline__ long long probe_sm() {\n"
     "  unsigned id;\n"
     '  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));\n'
     "  return id;\n"
     "}\n"
     "#define PROBE_CTA(e_, v_) \\\n"
     "  if (blockIdx.x < PROBE_CTAS) \\\n"
     "    flash_probe_cta[blockIdx.x * CTA_MARKS + (e_)] = (v_);\n"
     "#define PROBE_MARK(step, e) \\\n"
     "  if (probe_on && (step) < PROBE_TILES) \\\n"
     "    flash_probe[((threadIdx.x >> 7) * PROBE_TILES + (step)) * "
     "PROBE_MARKS + (e)] = clock64();\n"),
    ('extern "C" int flash_attention_body(int dtype, int d, int dv) {',
     'extern "C" int flash_probe_read(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, flash_probe, "
     "sizeof(flash_probe));\n"
     "}\n"
     'extern "C" int flash_probe_cta_read(void* dst) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, flash_probe_cta, "
     "sizeof(flash_probe_cta));\n"
     "}\n"
     'extern "C" int flash_probe_clear() {\n'
     "  static long long zero[PROBE_CTAS * CTA_MARKS];\n"
     "  const int rc = (int)cudaMemcpyToSymbol(flash_probe, zero, "
     "sizeof(flash_probe));\n"
     "  return rc ? rc : (int)cudaMemcpyToSymbol(flash_probe_cta, zero, "
     "sizeof(flash_probe_cta));\n"
     "}\n"
     'extern "C" int flash_attention_body(int dtype, int d, int dv) {')]
# ... in the warp-specialised body: per turn of tile kt > kt0 (its step),
# 0 before the waits for K and V, 1 after them, 2 with the tensor cores
# handed over, 3 with Q.K^T and the last tile's P.V issued, 4 Q.K^T done,
# 5 scores done, 6 that P.V done, 7 O rescaled and P packed; per CTA
# (thread 0; thread 128 w for 3 + w), 0 its start (globaltimer ns), 1 its
# SM, 2 the first K tile landed, 3 + w warpgroup w's last store, 6 / 7
# clock64 at the start and at warpgroup 0's last store.
_WS_PROBE = [
    ("  const uint32_t bars = smem_u32(smem + L::BARS);\n"
     "  // One CTA per (head, query tile) in a 1-D grid, ordered by head "
     "group.\n",
     "  const uint32_t bars = smem_u32(smem + L::BARS);\n"
     "  if (threadIdx.x == 0) {\n"
     "    PROBE_CTA(6, clock64());\n"
     "    PROBE_CTA(0, probe_ns());\n"
     "    PROBE_CTA(1, probe_sm());\n"
     "  }\n"
     "  // One CTA per (head, query tile) in a 1-D grid, ordered by head "
     "group.\n"),
    ("    // Turn 0: Q.K^T of the first tile.\n"
     "    mbar_wait(full_k, 0);\n",
     "    // Turn 0: Q.K^T of the first tile.\n"
     "    mbar_wait(full_k, 0);\n"
     "    if (threadIdx.x == 0) PROBE_CTA(2, probe_ns());\n"),
    ("        store_pair(static_cast<float*>(out) + at, c, dv, x0, x1);\n"
     "    }\n  }\n}\n\ntemplate <int DQK, int DV>\n"
     "__global__ void __launch_bounds__(WsSmem<DQK, DV>::THREADS, 1)\n"
     "flash_bf16_ws_kernel(",
     "        store_pair(static_cast<float*>(out) + at, c, dv, x0, x1);\n"
     "    }\n  }\n"
     "  if ((threadIdx.x & 127) == 0) {\n"
     "    if (threadIdx.x == 0) PROBE_CTA(7, clock64());\n"
     "    PROBE_CTA(3 + wg, probe_ns());\n"
     "  }\n"
     "}\n\ntemplate <int DQK, int DV>\n"
     "__global__ void __launch_bounds__(WsSmem<DQK, DV>::THREADS, 1)\n"
     "flash_bf16_ws_kernel("),
    ("  const uint32_t q_s = smem_u32(smem) + wg * 64 * 128;\n",
     "  const uint32_t q_s = smem_u32(smem) + wg * 64 * 128;\n"
     "  const bool probe_on = blockIdx.x == 0 && (threadIdx.x & 127) == 0;\n"),
    ("      mbar_wait(full_k + 8 * slot, (step / SL) & 1);\n"
     "      mbar_wait(full_v + 8 * prev, ((step - 1) / SL) & 1);\n"
     "      turn_wait(1 + wg);\n"
     "      wgmma_fence();\n"
     "      ws_qk<DQK, DV>(s, q_s, k_s + slot * L::K_SLOT);\n",
     "      PROBE_MARK(step, 0);\n"
     "      mbar_wait(full_k + 8 * slot, (step / SL) & 1);\n"
     "      mbar_wait(full_v + 8 * prev, ((step - 1) / SL) & 1);\n"
     "      PROBE_MARK(step, 1);\n"
     "      turn_wait(1 + wg);\n"
     "      PROBE_MARK(step, 2);\n"
     "      wgmma_fence();\n"
     "      ws_qk<DQK, DV>(s, q_s, k_s + slot * L::K_SLOT);\n"),
    ("      turn_pass(next);\n"
     "      wgmma_wait_one();                  // Q.K^T done, P.V in flight\n"
     "      fence_regs(s);\n",
     "      turn_pass(next);\n"
     "      PROBE_MARK(step, 3);\n"
     "      wgmma_wait_one();                  // Q.K^T done, P.V in flight\n"
     "      fence_regs(s);\n"
     "      PROBE_MARK(step, 4);\n"),
    ("      wgmma_wait_all();\n"
     "      fence_regs(o);\n"
     "      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(empty_v + 8 * prev);\n"
     "      ws_rescale_pack<BK, DV / 2>(s, o, pa, a_lo, a_hi);\n",
     "      PROBE_MARK(step, 5);\n"
     "      wgmma_wait_all();\n"
     "      fence_regs(o);\n"
     "      PROBE_MARK(step, 6);\n"
     "      __syncwarp();\n"
     "      if (lane == 0) mbar_arrive(empty_v + 8 * prev);\n"
     "      ws_rescale_pack<BK, DV / 2>(s, o, pa, a_lo, a_hi);\n"
     "      PROBE_MARK(step, 7);\n")]
# ... in the old body at d <= 128 (the parent's flash_bf16_kernel), per tile (its
# step): 0 before the wait for its K / V stage, 1 after it, 2 Q.K^T done,
# 3 softmax done (P packed), 4 P.V done.  Applied to the --parent source.
PARENT_PROBE = _PROBE_COMMON + [
    ("  const float sl2 = scale * LOG2E;         // scores in the exp2 "
     "domain\n",
     "  const float sl2 = scale * LOG2E;         // scores in the exp2 "
     "domain\n"
     "  const bool probe_on = blockIdx.x == 0 && blockIdx.y == 0 &&\n"
     "                        (threadIdx.x & 127) == 0;\n"),
    ("    mbar_wait(full + 8 * st, (step / WG_STAGES) & 1);\n",
     "    PROBE_MARK(step, 0);\n"
     "    mbar_wait(full + 8 * st, (step / WG_STAGES) & 1);\n"
     "    PROBE_MARK(step, 1);\n"),
    ("    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(s);\n\n",
     "    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(s);\n"
     "    PROBE_MARK(step, 2);\n\n"),
    ("    wgmma_fence();\n#pragma unroll\n"
     "    for (int kc = 0; kc < BK / 16; ++kc) {\n"
     "      const uint64_t vd = gmma_desc(v_s + kc * 16 * 128, L::KV_PANEL, "
     "1024);\n",
     "    PROBE_MARK(step, 3);\n"
     "    wgmma_fence();\n#pragma unroll\n"
     "    for (int kc = 0; kc < BK / 16; ++kc) {\n"
     "      const uint64_t vd = gmma_desc(v_s + kc * 16 * 128, L::KV_PANEL, "
     "1024);\n"),
    ("    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(o);\n"
     "    __syncwarp();                          // the stage is read: "
     "release it\n",
     "    wgmma_commit();\n    wgmma_wait_all();\n    fence_regs(o);\n"
     "    PROBE_MARK(step, 4);\n"
     "    __syncwarp();                          // the stage is read: "
     "release it\n")]

# kernel -> variant -> (what it changes, [(text, replacement), ...])
VARIANTS = {
    "gemm": {
        "stages3": ("a ring of 3 k-stages of 32",
                    [("constexpr int STAGES = 2;",
                      "constexpr int STAGES = 3;"), _OPT_IN]),
        "stages4": ("a ring of 4 k-stages of 32 (K = 128 all in flight)",
                    [("constexpr int STAGES = 2;",
                      "constexpr int STAGES = 4;"), _OPT_IN]),
        "bk16": ("k-stages of 16, a ring of 4",
                 [("constexpr int BK = 32;", "constexpr int BK = 16;"),
                  ("constexpr int STAGES = 2;",
                   "constexpr int STAGES = 4;")]),
        "nopad": ("A panel rows unpadded (stride BK)",
                  [("constexpr int AST = BK + 4;",
                    "constexpr int AST = BK;")]),
        "bm32": ("32-row output tiles (64 threads)",
                 [("constexpr int BM = 64;", "constexpr int BM = 32;")]),
        "bn64": ("64-column output tiles (256 threads)",
                 [("constexpr int BN = 32;", "constexpr int BN = 64;")]),
        "bn16": ("16-column output tiles (64 threads)",
                 [("constexpr int BN = 32;", "constexpr int BN = 16;")]),
    },
    # The bf16 body of gemm.cu (entry gemm_mixed): tile widths, stage
    # counts and consumer warpgroups, each a text edit of `bf16_tile` or of
    # one launch in `gemm_mixed`'s switch.  Tiles 0 / 1 are 64 x 64 (K <=
    # 256 / K > 256 at N <= 128), 2 is 128 x 128 and 3 is 128 x 256.
    "gemm_bf16": {
        "bn64": ("64-column tiles everywhere (one warpgroup, a ring of 8 "
                 "past K = 256)",
                 [("  if (N <= 128) return 1;", "  return 1;")]),
        "bn128": ("128 x 128 tiles past N = 128 at K > 256",
                  [("  return N <= 1024 ? 2 : 3;", "  return 2;")]),
        "bn256": ("128 x 256 tiles past N = 128 at K > 256",
                  [("  return N <= 1024 ? 2 : 3;", "  return 3;")]),
        "short_bn128": ("K <= 256: 64 x 128 tiles",
                        [("launch_bf16<1, 64, 4>", "launch_bf16<1, 128, 4>")]),
        "short_two_wg": ("K <= 256: 128 x 64 tiles, two consumer warpgroups",
                         [("launch_bf16<1, 64, 4>", "launch_bf16<2, 64, 4>")]),
        "short_stages3": ("K <= 256: a ring of 3 k-stages",
                          [("launch_bf16<1, 64, 4>", "launch_bf16<1, 64, 3>")]),
        "tall_stages4": ("K > 256, N <= 128: a ring of 4",
                         [("launch_bf16<1, 64, 8>", "launch_bf16<1, 64, 4>")]),
        "tall_stages12": ("K > 256, N <= 128: a ring of 12",
                          [("launch_bf16<1, 64, 8>", "launch_bf16<1, 64, 12>")]),
        "tall_bn128": ("K > 256, N <= 128: 64 x 128 tiles, a ring of 6",
                       [("launch_bf16<1, 64, 8>", "launch_bf16<1, 128, 6>")]),
        "big_stages3": ("128 x 256 tiles in a ring of 3",
                        [("launch_bf16<2, 256, 4>", "launch_bf16<2, 256, 3>")]),
        "big_one_wg": ("64 x 256 tiles, one consumer warpgroup",
                       [("launch_bf16<2, 256, 4>", "launch_bf16<1, 256, 4>")]),
    },
    "sddmm": {
        "span32": ("32-slot spans (one slot a lane)",
                   [("constexpr int J = 2;", "constexpr int J = 1;")]),
        "span128": ("128-slot spans",
                    [("constexpr int J = 2;", "constexpr int J = 4;")]),
        "span256": ("256-slot spans",
                    [("constexpr int J = 2;", "constexpr int J = 8;")]),
        "warps8": ("8 warps a block",
                   [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")]),
        "warps16": ("16 warps a block",
                    [("constexpr int WARPS = 4;",
                      "constexpr int WARPS = 16;")]),
        "bf16_load16": ("bf16 operands: 16-byte loads of eight features a "
                        "lane in the first 128 (lane l holds features "
                        "8 l .. + 7 and 64 + 8 l .. + 7; another sum "
                        "order, held to tolerance), where f and the row "
                        "strides are multiples of 8 and the bases of 16 "
                        "bytes",
                        [("template <typename T, int Q = 4>\n",
                          "template <typename T, int Q = sizeof(T) == 2 ? 8 "
                          ": 4>\n"),
                         ("#pragma unroll\n  for (int i = 0; i < 4; ++i) "
                          "x[i] = quad<VEC, T>(row, 4 * (l + 8 * i), f);\n",
                          "  if constexpr (VEC && sizeof(T) == 2) {\n"
                          "#pragma unroll\n"
                          "    for (int i = 0; i < 2; ++i) {\n"
                          "      const int c = 8 * (l + 8 * i);\n"
                          "      x[2 * i] = x[2 * i + 1] = make_float4(0.0f, "
                          "0.0f, 0.0f, 0.0f);\n"
                          "      if (c < f) {\n"
                          "        const uint4 u = *reinterpret_cast<const "
                          "uint4*>(row + c);\n"
                          "        x[2 * i] = widen4(u.x, u.y);\n"
                          "        x[2 * i + 1] = widen4(u.z, u.w);\n"
                          "      }\n"
                          "    }\n"
                          "  } else {\n"
                          "#pragma unroll\n"
                          "    for (int i = 0; i < 4; ++i)\n"
                          "      x[i] = quad<VEC, T>(row, 4 * (l + 8 * i), "
                          "f);\n"
                          "  }\n")]),
        "bf16_two_slots": ("bf16 operands on the vector route at f <= 128: "
                           "two slots a group per round (slots b0 + g and "
                           "b0 + 4 + g, each summed in the checkout's "
                           "order), eight a warp",
                           [("    for (int b0 = 0; b0 < n_live; b0 += 4) {\n",
                             "    for (int b0 = 0; b0 < n_live; b0 += 4) {\n"
                             "      if constexpr (VEC && sizeof(T) == 2) {\n"
                             "        if (f <= 128) {\n"
                             "          const int i0 = b0 + g, i1 = b0 + 4 + "
                             "g;\n"
                             "          const int c0 = i0 < n_live ? "
                             "list_c[wid][i0] : 0;\n"
                             "          const int c1 = i1 < n_live ? "
                             "list_c[wid][i1] : 0;\n"
                             "          const bool bad0 = (unsigned)c0 >= "
                             "(unsigned)n_src;\n"
                             "          const bool bad1 = (unsigned)c1 >= "
                             "(unsigned)n_src;\n"
                             "          float4 x0[4], x1[4];\n"
                             "          lane_quads<VEC, T>(hs + (long long)"
                             "(bad0 ? 0 : c0) * lds, l, f, x0);\n"
                             "          lane_quads<VEC, T>(hs + (long long)"
                             "(bad1 ? 0 : c1) * lds, l, f, x1);\n"
                             "          float p0 = 0.0f, p1 = 0.0f;\n"
                             "#pragma unroll\n"
                             "          for (int i = 0; i < 4; ++i) {\n"
                             "            p0 = dot4(p0, d[i], x0[i]);\n"
                             "            p1 = dot4(p1, d[i], x1[i]);\n"
                             "          }\n"
                             "#pragma unroll\n"
                             "          for (int off = 4; off > 0; off >>= 1)"
                             " {\n"
                             "            p0 += __shfl_xor_sync(FULL, p0, "
                             "off);\n"
                             "            p1 += __shfl_xor_sync(FULL, p1, "
                             "off);\n"
                             "          }\n"
                             "          if (l == 0 && i0 < n_live)\n"
                             "            list_s[wid][i0] = bad0 ? "
                             "__int_as_float(0x7fc00000) : p0;\n"
                             "          if (l == 0 && i1 < n_live)\n"
                             "            list_s[wid][i1] = bad1 ? "
                             "__int_as_float(0x7fc00000) : p1;\n"
                             "          b0 += 4;\n"
                             "          continue;\n"
                             "        }\n"
                             "      }\n")]),
    },
    # The densify kernel (ell_densify_kernel in gemm.cu), each a text edit
    # called through its entry; every build keeps each element's sum
    # (0.0f plus its slots in slot order), so each is held bit for bit.
    "densify": {
        "early_zeros": ("each segment's zeros stored first, before its "
                        "slots are read, and after the walk only the quads "
                        "whose sums are not all +0.0f (over the zeros, by "
                        "the same lane)",
                        [("  float4* seg = seg_all[threadIdx.x >> 5];\n",
                          "  float* base = row - m;\n"
                          "#pragma unroll\n"
                          "  for (int i = 0; i < DQ; ++i)\n"
                          "    densify_put(base, p0 + 4 * (lane + 32 * i), m, "
                          "n_src,\n                make_float4(0.0f, 0.0f, "
                          "0.0f, 0.0f));\n"
                          "  float4* seg = seg_all[threadIdx.x >> 5];\n"),
                         ("  float* base = row - m;\n#pragma unroll\n"
                          "  for (int i = 0; i < DQ; ++i)\n"
                          "    densify_put(base, p0 + 4 * (lane + 32 * i), m, "
                          "n_src, seg[lane + 32 * i]);\n",
                          "#pragma unroll\n"
                          "  for (int i = 0; i < DQ; ++i) {\n"
                          "    const float4 x = seg[lane + 32 * i];\n"
                          "    if (__float_as_uint(x.x) | __float_as_uint(x.y)"
                          " |\n        __float_as_uint(x.z) | "
                          "__float_as_uint(x.w))\n"
                          "      densify_put(base, p0 + 4 * (lane + 32 * i), "
                          "m, n_src, x);\n  }\n")]),
        "plain_stores": ("stores without the streaming hint",
                         [("    __stcs(reinterpret_cast<float4*>(base + p), "
                           "x);", "    *reinterpret_cast<float4*>(base + p) "
                           "= x;"),
                          ("__stcs(base + p + j, e[j]);",
                           "base[p + j] = e[j];")]),
        "seg1024": ("1,024-position segments, 8 warps a CTA (a "
                    "4096-column row is 4 warps' work, each reading the "
                    "row's slots)",
                    [("constexpr int DSEG = 2048;",
                      "constexpr int DSEG = 1024;"),
                     ("constexpr int DWARPS = 4;",
                      "constexpr int DWARPS = 8;")]),
        "seg4096": ("4,096-position segments, 2 warps a CTA (16 KB of "
                    "shared memory a warp; a 4096-column row is one warp's "
                    "work)",
                    [("constexpr int DSEG = 2048;",
                      "constexpr int DSEG = 4096;"),
                     ("constexpr int DWARPS = 4;",
                      "constexpr int DWARPS = 2;")]),
        "cols_always": ("every slot's column read, pads' too (a pad "
                        "still lands nowhere)",
                        [("      cb[b] = vb[b] != 0.0f ? cr[k0 + 32 * b + "
                          "lane] : -1;",
                          "      cb[b] = k0 + 32 * b + lane < w ? cr[k0 + 32 "
                          "* b + lane] : -1,\n"
                          "      cb[b] = vb[b] != 0.0f || cb[b] == "
                          "-2147483647 - 1 ? cb[b] : -1;")]),
        "db4": ("4 chunks of 32 slots loaded a lane before a walk",
                [("constexpr int DB = 8;", "constexpr int DB = 4;")]),
        "db16": ("16 chunks of 32 slots loaded a lane before a walk",
                 [("constexpr int DB = 8;", "constexpr int DB = 16;")]),
        "serial": ("a chunk's live slots broadcast one at a time in slot "
                   "order, the lane that owns each one's quad adding it "
                   "(the first design's loop)",
                   [("  const unsigned same = __match_any_sync(0xffffffffu, "
                     "p);\n",
                     "  for (unsigned t = __ballot_sync(0xffffffffu, p >= 0);"
                     " t;\n       t &= t - 1) {\n"
                     "    const int q = __ffs(t) - 1;\n"
                     "    const int pq = __shfl_sync(0xffffffffu, p, q);\n"
                     "    const float vq = __shfl_sync(0xffffffffu, v, q);\n"
                     "    if (((pq >> 2) & 31) == lane) segf[pq] += vq;\n"
                     "  }\n"
                     "  if (p > -2) return;\n"
                     "  const unsigned same = __match_any_sync(0xffffffffu, "
                     "p);\n")]),
        "diag_fill": ("diagnostic, timed only (wrong sums): the segments' "
                      "zeros stored, no slot read",
                      [("  for (int k0 = 0; k0 < w; k0 += 32 * DB) {",
                        "  for (int k0 = 0; k0 < 0; k0 += 32 * DB) {")]),
        "diag_no_store": ("diagnostic, timed only (nothing written): the "
                          "walk and its sums, no global store",
                          [("  const int c = p - m;\n",
                            "  const int c = p - m;\n"
                            "  if (x.x != -7.25e-30f) return;\n")]),
    },
    "flash_attention": {
        "wide_two_wg": ("bf16 body past d = 128: the two consumer "
                        "warpgroups without setmaxnreg (every thread at the "
                        "launch's 168 registers)", _NO_SETMAXNREG),
        "wide_pv_halves": ("bf16 body past d = 128: P.V as two m64n128 "
                           "halves instead of one m64n256 (DV = 256)",
                           [("      wgmma_rs_n256(o, pa[kc], vd, 1);\n",
                             "    {\n"
                             "      wgmma_rs_n128(*reinterpret_cast<"
                             "float(*)[64]>(o), pa[kc], vd, 1);\n"
                             "      wgmma_rs_n128(*reinterpret_cast<"
                             "float(*)[64]>(o + 64), pa[kc], gmma_desc("
                             "v_s + 2 * L::KV_PANEL + kc * 16 * 128, "
                             "L::KV_PANEL, 1024), 1);\n"
                             "    }\n")]),
        "wide_kstep_break": ("bf16 body past d = 128: Q.K^T stops at the "
                             "last k-step below d (a branch between the "
                             "wgmma of one tile)",
                             [("                                      "
                               "uint32_t q_s, uint32_t k_s) {",
                               "                                      "
                               "uint32_t q_s, uint32_t k_s, int d) {"),
                              ("  for (int kq = 0; kq < L::KS; ++kq) {\n",
                               "  for (int kq = 0; kq < L::KS; ++kq) {\n"
                               "    if (16 * kq >= d) break;\n"),
                              ("  ws_qk<DQK, DV>(s, q_s, k_s);",
                               "  ws_qk<DQK, DV>(s, q_s, k_s, d);"),
                              ("    ws_qk<DQK, DV>(s, q_s, k_s + slot * "
                               "L::K_SLOT);",
                               "    ws_qk<DQK, DV>(s, q_s, k_s + slot * "
                               "L::K_SLOT, d);"),
                              ("    int tk, int dv, int causal,",
                               "    int tk, int d, int dv, int causal,"),
                              ("out_bf16 != 0, q0, tq, tk, dv,",
                               "out_bf16 != 0, q0, tq, tk, d, dv,")]),
        "wide_no_pingpong": ("bf16 body past d = 128: the consumer "
                             "warpgroups issue their products without "
                             "taking turns (no named barriers)",
                             _NO_PINGPONG),
        "wide_bk64": ("bf16 body past d = 128: 64-key tiles at DQK 192 / "
                      "DV 128 (MLA) instead of 128",
                      [("  static constexpr int BK = DQK + DV <= 320 ? 128 "
                        ": 64;", "  static constexpr int BK = 64;")]),
        "wide_serial_turn": (
            "bf16 body past d = 128: a turn issues the last tile's P.V and "
            "this tile's Q.K^T as one group and runs the whole softmax "
            "after both (no overlap inside a warpgroup)",
            [(
              "      wgmma_fence();\n"
              "      ws_qk<DQK, DV>(s, q_s, k_s + slot * L::K_SLOT);\n"
              "      wgmma_commit();\n"
              "      ws_pv<DQK, DV>(o, pa, v_s + prev * L::V_SLOT);\n"
              "      wgmma_commit();\n"
              "      turn_pass(next);\n"
              "      wgmma_wait_one();                  // Q.K^T done, P.V in "
              "flight\n"
              "      fence_regs(s);\n"
              "      __syncwarp();\n"
              "      if (lane == 0) mbar_arrive(empty_k + 8 * slot);\n"
              "      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt *"
              " BK, wq0,\n"
              "                    row_lo, row_hi, t4, tk, causal, window, sl2"
              ");\n"
              "      wgmma_wait_all();\n"
              "      fence_regs(o);\n"
              "      __syncwarp();\n"
              "      if (lane == 0) mbar_arrive(empty_v + 8 * prev);\n",
              "      wgmma_fence();\n"
              "      ws_pv<DQK, DV>(o, pa, v_s + prev * L::V_SLOT);\n"
              "      ws_qk<DQK, DV>(s, q_s, k_s + slot * L::K_SLOT);\n"
              "      wgmma_commit();\n"
              "      turn_pass(next);\n"
              "      wgmma_wait_all();\n"
              "      fence_regs(o);\n"
              "      fence_regs(s);\n"
              "      __syncwarp();\n"
              "      if (lane == 0) {\n"
              "        mbar_arrive(empty_k + 8 * slot);\n"
              "        mbar_arrive(empty_v + 8 * prev);\n"
              "      }\n"
              "      ws_scores<BK>(s, m_lo, m_hi, l_lo, l_hi, a_lo, a_hi, kt *"
              " BK, wq0,\n"
              "                    row_lo, row_hi, t4, tk, causal, window, sl2"
              ");\n")]),
    },
    # The single-pass bf16 flash body past d = 256 (flash_bf16_sp_kernel),
    # each a text edit of flash_attention.cu called through its entry.
    "flash_wide": {
        "whole_qk": ("single-pass body in one CTA: each consumer warpgroup "
                     "forms the whole S itself (1.5x the ideal tensor work, "
                     "no exchange of partial S)",
                     [("  constexpr int NKQ = L::KS / 2;",
                       "  constexpr int NKQ = MODE == 0 ? L::KS : L::KS / 2;"),
                      ("  const int kq0 = wg * NKQ;",
                       "  const int kq0 = MODE == 0 ? 0 : wg * NKQ;"),
                      ("    sp_exchange<L::BK>(s, x_mine, x_other, wg, "
                       "first, last);\n", "    ;\n")]),
        "bk64_one_slot": ("single-pass body in one CTA: 64-key tiles, one "
                          "slot a ring, at DQK 512 (two do not fit beside "
                          "Q; at DQK 576 one does not either, and 32 x 2 "
                          "stays)",
                          [("  static constexpr int BK = SP_BK;",
                            "  static constexpr int BK = DQK == 512 && "
                            "MODE == 0 ? 64 : SP_BK;"),
                           ("  static constexpr int SLOTS = SP_SLOTS;",
                            "  static constexpr int SLOTS = DQK == 512 && "
                            "MODE == 0 ? 1 : SP_SLOTS;")]),
        "one_slot": ("single-pass body: 32-key tiles, one slot a ring",
                     [("constexpr int SP_SLOTS = 2;",
                       "constexpr int SP_SLOTS = 1;")]),
        "cl_barrier": ("single-pass body in a cluster: one barrier.cluster a "
                       "tile (every thread of the cluster in lock step, the "
                       "producers too) in place of the written / read "
                       "mbarriers",
                       _CL_LOCKSTEP),
        "cl_one_xslot": ("single-pass body in a cluster: one partial-S slot "
                         "a CTA instead of two (a CTA writes a tile's "
                         "partial only once every peer read the last)",
                         [("constexpr int SP_XSLOTS = 2;",
                           "constexpr int SP_XSLOTS = 1;")]),
        "cl_diag_own": ("diagnostic, timed only (wrong sums): the clusters' "
                        "exchange reads no peer's S_r (no distributed shared "
                        "memory read; every barrier kept)",
                        [("      const uint32_t base = peer_addr(at, r) + 16 "
                          "* 128 * N * HF;",
                          "      continue;\n      const uint32_t base = "
                          "peer_addr(at, r) + 16 * 128 * N * HF;")]),
        "cl_diag_nowait": ("diagnostic, timed only (wrong sums): as "
                           "cl_diag_own, and no wait on the written or read "
                           "barriers (the arrivals kept)",
                           [("      const uint32_t base = peer_addr(at, r) + "
                             "16 * 128 * N * HF;",
                             "      continue;\n      const uint32_t base = "
                             "peer_addr(at, r) + 16 * 128 * N * HF;"),
                            ("  mbar_wait_cluster(x_full + 8 * slot, use & "
                             "1);\n", ""),
                            ("  if (use > 0) mbar_wait_cluster(x_empty + 8 * "
                             "slot, (use - 1) & 1);\n", "")]),
        "cl_whole_s": ("single-pass body in a cluster: each CTA forms the "
                       "whole S itself (C x the Q.K^T work, Q in rounds of "
                       "8 panels through shared memory, no exchange across "
                       "the cluster; the CTA's two halves still swap)",
                       [("    s.rounds = ((pq + 7) / 8 + nc - 1) / nc;\n"
                         "    s.qc0 = rank * s.rounds * 512;",
                         "    s.rounds = (pq + 7) / 8;\n    s.qc0 = 0;"),
                        ("  const bool rounds = (d + 63) / 64 > 8 * nc;",
                         "  const bool rounds = true;"),
                        ("  if constexpr (MODE == 0) {\n    sp_exchange",
                         "  if constexpr (true) {\n    sp_exchange")]),
    },
    # The fp32 flash bodies (flash_f32_kernel up to d = 256,
    # flash_f32_sp_kernel past it), each a text edit of flash_attention.cu
    # called through its entry.
    "flash_f32": {
        "one_slot": ("fp32 bodies: one slot a ring (each tile's / piece's "
                     "loads exposed behind a second barrier)",
                     [("constexpr int F32_SLOTS = 2;",
                       "constexpr int F32_SLOTS = 1;"),
                      ("constexpr int F32SP_SLOTS = 2;",
                       "constexpr int F32SP_SLOTS = 1;")]),
        "rows64": ("fp32 body: four warps a CTA, 64 query rows at d <= 128 "
                   "(32 past it), so K and V are read twice as often",
                   [("constexpr int F32_WARPS = 8;",
                     "constexpr int F32_WARPS = 4;")]),
        "bk32": ("fp32 body: 32-key slots at d <= 128, the smaller "
                 "micro-tile (8 rows x 2 keys of S a lane)",
                 [("constexpr int F32_BK = 64;",
                   "constexpr int F32_BK = 32;")]),
        "cl_barrier": ("single-pass body in a cluster: one barrier.cluster a "
                       "tile in place of the written / read mbarriers",
                       _CL_LOCKSTEP),
        "cl_one_xslot": ("single-pass body in a cluster: one partial-S slot "
                         "a CTA instead of two",
                         [("constexpr int F32SP_XSLOTS = 2;",
                           "constexpr int F32SP_XSLOTS = 1;")]),
    },
    # The bf16 body at d <= 128 (flash_bf16_ws_kernel<64, 64> and <128,
    # 128>), each a text edit of flash_attention.cu called through its
    # entry; with --parent also the old body and its phase probe.
    "flash_d128": {
        "d128_no_pingpong": ("the consumer warpgroups issue their products "
                             "without taking turns (no named barriers)",
                             _NO_PINGPONG),
        "d128_no_setmaxnreg": ("every thread at the launch's 168 registers "
                               "(no setmaxnreg)", _NO_SETMAXNREG),
        "d128_heads_fastest": ("the grid runs heads fastest over all BH, "
                               "query tiles heaviest first (the old body's "
                               "order) "
                               "at every shape",
                               [(_WS_HEAD_RULE,
                                 "  const int head_group = bh;\n")]),
        "d128_grouped": ("the grid runs heads in groups of 8 at every shape",
                         [(_WS_HEAD_RULE,
                           "  const int head_group = WS_HEAD_GROUP;\n")]),
        "d128_lazy_rescale": ("O rescaled only where a row's max moved in "
                              "the warp (a factor of 1 skipped: the same "
                              "bits)",
                              [("  for (int i = 0; i < ON / 4; ++i) {\n"
                                "    o[4 * i] *= a_lo;\n",
                                "  if (__any_sync(FULL, a_lo != 1.0f || "
                                "a_hi != 1.0f))\n"
                                "  for (int i = 0; i < ON / 4; ++i) {\n"
                                "    o[4 * i] *= a_lo;\n")]),
        "diag_no_ex2": ("diagnostic, not held: the softmax's exponentials "
                        "left out (P = the exponent's argument), a "
                        "timing of the SFU's share only",
                        [("    s[4 * i] = ex2(fmaf(s[4 * i], sl2, -mn_lo));"
                          "   // masked: ex2(-inf) = 0\n"
                          "    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], sl2, "
                          "-mn_lo));\n"
                          "    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], sl2, "
                          "-mn_hi));\n"
                          "    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], sl2, "
                          "-mn_hi));\n",
                          "    s[4 * i] = fmaf(s[4 * i], sl2, -mn_lo);\n"
                          "    s[4 * i + 1] = fmaf(s[4 * i + 1], sl2, "
                          "-mn_lo);\n"
                          "    s[4 * i + 2] = fmaf(s[4 * i + 2], sl2, "
                          "-mn_hi);\n"
                          "    s[4 * i + 3] = fmaf(s[4 * i + 3], sl2, "
                          "-mn_hi);\n")]),
        "d128_two_wg64": ("DQK 64: two consumer warpgroups (128 query "
                          "rows a CTA, 232 registers) instead of three",
                          [("constexpr int WS_NWG_DQK64 = 3;",
                            "constexpr int WS_NWG_DQK64 = 2;")]),
        "d128_three_wg128": ("DQK 128: three consumer warpgroups (192 "
                             "query rows a CTA, 160 registers) on 64-key "
                             "tiles (other bits)",
                             [("  static constexpr int NWG = DQK == 64 ? "
                               "WS_NWG_DQK64 : 2;",
                               "  static constexpr int NWG = DQK <= 128 ? 3 "
                               ": 2;"),
                              ("  static constexpr int BK = DQK + DV <= 320 ? "
                               "128 : 64;",
                               "  static constexpr int BK = DQK == 128 ? 64 : "
                               "DQK + DV <= 320 ? 128 : 64;")]),
        "d128_bk64": ("DQK 64: 64-key tiles instead of 128 (other bits: "
                      "another rescale order)",
                      [("  static constexpr int BK = DQK + DV <= 320 ? 128 "
                        ": 64;", "  static constexpr int BK = DQK == 64 ? 64 "
                        ": DQK + DV <= 320 ? 128 : 64;")]),
        "d128_slots3": ("three slots a K and a V ring at DQK 64 / 128 "
                        "(DQK 128: 224 KB)",
                        [("  static constexpr int SLOTS = 2;               "
                          "// slots of the K and V rings",
                          "  static constexpr int SLOTS = DQK <= 128 ? 3 "
                          ": 2;")]),
        "d128_ex2_fma25": ("a quarter of the softmax's exponentials on the "
                           "FMA pipe (other bits)", _ex2_fma(1)),
        "d128_ex2_fma50": ("half of the softmax's exponentials on the FMA "
                           "pipe (other bits)", _ex2_fma(2)),
        "d128_probe": ("the body with clock64 stamps in one CTA (the first "
                       "head's heaviest query tile) and globaltimer stamps "
                       "of every CTA: the phase and grid probes",
                       _PROBE_COMMON + _WS_PROBE),
    },
    # The SpDMM kernel (spdmm.cu), called through its step-list entry
    # spdmm_steps and its one-step entry spdmm_f32.
    "spdmm": {
        "span32": ("32-slot spans (other bits past 32 slots a row)",
                   [("constexpr int SPAN = 64;", "constexpr int SPAN = 32;")]),
        "span128": ("128-slot spans (other bits past 64 slots a row)",
                    [("constexpr int SPAN = 64;",
                      "constexpr int SPAN = 128;")]),
        "no_split": ("no span split: one warp walks a row's step whole, "
                     "as PR 30's kernel did (other bits past 64 slots)",
                     [("constexpr int SPAN = 64;",
                       "constexpr int SPAN = 1 << 20;")]),
        "inflight16": ("16 row gathers in flight, 2 blocks an SM (the same "
                       "bits)",
                       [("constexpr int INFLIGHT = 8;",
                         "constexpr int INFLIGHT = 16;"),
                        ("constexpr int MIN_BLOCKS = 4;",
                         "constexpr int MIN_BLOCKS = 2;")]),
        "blocks3": ("3 blocks an SM (85 registers; the same bits)",
                    [("constexpr int MIN_BLOCKS = 4;",
                      "constexpr int MIN_BLOCKS = 3;")]),
        "one_rows8": ("a one-step call's blocks hold 8 rows, as a step "
                      "list's do (the same bits)",
                      [("constexpr int ROWS_ONE = 4;",
                        "constexpr int ROWS_ONE = 8;")]),
        "list_rows4": ("a step list's blocks hold 4 rows, as a one-step "
                       "call's do (the same bits)",
                       [("constexpr int ROWS_LIST = 8;",
                         "constexpr int ROWS_LIST = 4;")]),
        "hub_inflight8": ("the hub pass with 8 row gathers in flight (the "
                          "same bits)",
                          [("constexpr int HUB_INFLIGHT = 16;",
                            "constexpr int HUB_INFLIGHT = 8;")]),
        "round_robin": ("each warp takes PER_WARP consecutive spans of a "
                        "round from the first warp on, as the first "
                        "designs did (the same bits)",
                        [("const int share = (end - b + WARPS - 1) / WARPS;",
                          "const int share = PER_WARP;")]),
    },
}
# SpDMM variants whose sums keep the checkout's order (bit for bit).
SPDMM_SAME_BITS = ("per_step", "inflight16", "blocks3", "one_rows8",
                   "list_rows4", "hub_inflight8", "round_robin")
# Planted faults in the GEMM kernel's bf16 body, each of which
# ``chip_smoke.gemm_bf16_check`` must fail: name -> (what it does, edits).
# None can leave a warp waiting forever (the ring's mbarrier protocol is
# untouched); a flipped stage parity could, once a warp runs a ring round
# ahead of the other side.
GEMM_FAULTS = {
    "swizzle_64b": ("wgmma descriptors say a 64-byte swizzle where TMA and "
                    "the staged route write the 128-byte one",
                    [("((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62)",
                      "((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62)")]),
    "drop_last_kstage": ("the consumers skip the last k-stage's products "
                         "(still waiting for it and releasing it)",
                         [("      wgmma_tb<BN>(c, gmma_desc(as + ks * 32, 16, "
                           "1024),",
                           "      if (kt + 1 < n_kt)\n"
                           "      wgmma_tb<BN>(c, gmma_desc(as + ks * 32, 16, "
                           "1024),")]),
    "w_panel_step": ("w's descriptor steps half a panel between its "
                     "64-column panels (only tiles wider than 64 read a "
                     "second panel)",
                     [("gmma_desc(bs + ks * 16 * 128, B_PANEL, 1024)",
                       "gmma_desc(bs + ks * 16 * 128, B_PANEL / 2, 1024)")]),
    "staged_no_swizzle": ("the staged route writes its chunks unswizzled "
                          "(the TMA route is right)",
                          [("((((c >> 3) & 7) ^ (r & 7)) << 4)",
                            "(((c >> 3) & 7) << 4)")]),
}
# Variant keys built from another kernel's source, and the entry point
# their copies are called through.
SOURCE = {"gemm_bf16": "gemm", "densify": "gemm",
          "flash_wide": "flash_attention",
          "flash_f32": "flash_attention", "flash_d128": "flash_attention"}
ENTRY = {"gemm_bf16": "gemm_mixed", "flash_wide": "flash_attention",
         "flash_f32": "flash_attention", "flash_d128": "flash_attention",
         "spdmm": "spdmm_steps"}
# The entry a parent copy is called through, where it differs (the
# parent's SpDMM source has only the one-step entries).
PARENT_ENTRY = {"spdmm": "spdmm"}
# Kernels whose parent source is built as the variant "parent".
PARENT_KERNELS = ("gemm", "gemm_bf16", "densify", "sddmm",
                  "flash_attention", "flash_wide", "flash_f32", "flash_d128",
                  "spdmm")
# A flash entry without the dv argument (the signature before V took its
# own width): the parent's, when its source has no dv.
FLASH_NO_DV = "int d, int causal, int window,"


def flash_without_dv(fn):
    """The entry ``fn`` of a flash source whose C signature has no dv,
    called as the wrappers call the current one: only with dv = d (V as
    wide as q)."""
    import ctypes
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])

    def call(q, k, v, out, dtype, out_dtype, bh, tq, tk, d, dv, *rest):
        if dv != d:
            raise ValueError("this flash entry takes V as wide as q only")
        return fn(q, k, v, out, dtype, out_dtype, bh, tq, tk, d, *rest)
    call.no_dv = True
    return call


def log(*a) -> None:
    print(*a, flush=True)


def build_variants(build, parent, kernels):
    """Build every variant of ``kernels`` (and the parent's sources);
    returns (kernel, name) -> C entry point, the checkout's kernels as
    "change"."""
    copies, keys = {}, {}
    for kern, variants in VARIANTS.items():
        if kern not in kernels:
            continue
        src, ent = SOURCE.get(kern, kern), ENTRY.get(kern, kern)
        edits = dict((n, e) for n, (_, e) in variants.items())
        if kern == "gemm_bf16":
            edits.update((f"fault_{n}", e) for n, (_, e) in
                         GEMM_FAULTS.items())
        for name, ed in edits.items():
            copies[f"{kern}_{name}"] = (ent, build.edited(src, ed))
            keys[f"{kern}_{name}"] = (kern, name)
        if parent and kern in PARENT_KERNELS:
            with open(os.path.join(parent, "src/repro_torch/kernels/csrc",
                                   f"{src}.cu")) as fh:
                copies[f"{kern}_parent"] = (PARENT_ENTRY.get(kern, ent),
                                        fh.read())
            keys[f"{kern}_parent"] = (kern, "parent")
            if kern == "flash_d128":
                text = copies[f"{kern}_parent"][1]
                for old, new in PARENT_PROBE:
                    if text.count(old) != 1:
                        raise ValueError("the parent's flash source does "
                                         "not hold the probe's text once: "
                                         f"{old!r}")
                    text = text.replace(old, new)
                copies[f"{kern}_parent_probe"] = (ent, text)
                keys[f"{kern}_parent_probe"] = (kern, "parent_probe")
    t0 = time.perf_counter()
    built = build.build_copies(copies, os.path.join(build.BUILD_DIR,
                                                    "variants"))
    log(f"build: {len(copies)} copies and the checkout's kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    fns = {}
    for tag, (fn, report) in built.items():
        kern, name = keys[tag]
        src = SOURCE.get(kern, kern)
        if src == "flash_attention" and FLASH_NO_DV in copies[tag][1]:
            fn = flash_without_dv(fn)
        regs = [ln.split("ptxas info    :")[-1].strip()
                for ln in report.splitlines() if "Used" in ln or "spill" in ln]
        log(f"nvcc {kern} {name}: " + "; ".join(regs))
        fns[(kern, name)] = fn
        REPORTS[(kern, name)] = report
    return fns


# (kernel, variant) -> the nvcc -Xptxas -v report of its build.
REPORTS = {}


class entry_as:
    """While open, the wrappers launch ``fn`` (one variant's entry) in
    place of every entry point, or only of the entry ``only``."""

    def __init__(self, ops, fn, only=None):
        self.ops, self.fn, self.real, self.only = ops, fn, ops.entry, only

    def __enter__(self):
        real, fn, only = self.real, self.fn, self.only
        self.ops.entry = lambda name: fn if only in (None, name) else \
            real(name)

    def __exit__(self, *exc):
        self.ops.entry = self.real


def remapped_block(torch, gen, x):
    """``x`` with 1.5% of its entries kept, the rest zero: a densified
    ELL block's density (about 60 edges a row of 4096, as FL's widest
    slice), so a 4096-deep fp32 sum adds few rounded terms and the kernel
    tolerance holds against ``torch.matmul``'s other order."""
    return x * (torch.rand(x.shape, generator=gen, device=x.device) < 0.015)


def gemm_phase(torch, cs, ops, ref, fns):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    names = [n for k, n in fns if k == "gemm"]
    shapes = cs.GEMM_SWEEP + [(4096, 128, n) for n in (128, 64, 8)] + [
        (4096, 4096, 128)]
    for m, k, n in shapes:
        x, w, acc = randn(m, 2 * k)[:, k:], randn(k, n), randn(m, n)
        if k == 4096:
            x = remapped_block(torch, gen, x)
        want = acc + ref.gemm_ref(x, w)
        with entry_as(ops, fns[("gemm", "change")]):
            mine = ops.gemm(x, w, acc)
        for nm in names:
            with entry_as(ops, fns[("gemm", nm)]):
                got = ops.gemm(x, w, acc)
            cs.check_close(torch, f"gemm {nm} {m}x{k}x{n}", got, want,
                           cs.KERNEL_RTOL, cs.KERNEL_ATOL)
            if not torch.equal(got, mine):
                cs.fail(f"gemm {nm} {m}x{k}x{n}: not bit-identical to the "
                        "checkout's kernel")
    log(f"gemm: {len(names)} builds within tolerance and bit-identical on "
        f"{len(shapes)} shapes")
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {}
    for m, k, n in ((4096, 128, 128), (4096, 128, 64), (4096, 128, 8),
                    (4096, 4096, 128)):
        if k == 128:
            h_full, w_full = randn(m, 4 * k), randn(4 * k, 2 * n)
            x, w = h_full[:, k:2 * k], w_full[k:2 * k, n:2 * n]
        else:                  # the remapped shape: dense block @ a view
            x = remapped_block(torch, gen, randn(m, k))
            w = randn(k, 4 * n)[:, n:2 * n]
        acc = randn(m, n)
        row = {}
        for i, nm in enumerate(order):
            with entry_as(ops, fns[("gemm", nm)]):
                t = cs.median_ms(torch, lambda: ops.gemm(x, w))
                ta = cs.median_ms(torch, lambda: ops.gemm(x, w, acc))
            row[nm if i < len(order) - 1 else "change_again"] = [t, ta]
        row["torch"] = [cs.median_ms(torch, lambda: torch.matmul(x, w)),
                        cs.median_ms(torch, lambda: torch.addmm(acc, x, w))]
        out[f"N={n}" if k == 128 else f"{m}x{k}x{n}"] = row
        log(f"gemm {m}x{k}x{n} ms (C = A.B / C = acc + A.B): " + ", ".join(
            f"{nm} {a:.4f} / {b:.4f}" for nm, (a, b) in row.items())
            + " (torch: matmul / addmm)")
    return out


def gemm_bf16_phase(torch, cs, ops, ref, fns):
    """Each build of the bf16 body (through ``gemm_mixed``) on
    ``chip_smoke``'s bf16 sweep, its tile shapes and its timed shapes:
    within the JAX sweep's bf16 tolerance of the plain version and, but
    for the parent's plain body, bit for bit the checkout's body (the
    float64 bound holds the checkout's in ``chip_smoke``); timed at the
    timed shapes (change, variants, parent, change) beside bf16
    ``torch.matmul``; then every planted fault run through
    ``chip_smoke.gemm_bf16_check``, which each must fail.  Fails if a
    variant's bits differ, the real body fails the check or a fault
    passes it."""
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    bf = torch.bfloat16
    names = [n for k, n in fns if k == "gemm_bf16"
             and not n.startswith("fault_")]
    faults = [n for k, n in fns if k == "gemm_bf16" and n.startswith("fault_")]
    differ = []
    shapes = cs.GEMM_SWEEP + cs.GEMM_BF16_TILES + cs.GEMM_BF16_TIMED
    for m, k, n in shapes:
        x, w = cs.gemm_bf16_operands(torch, randn, m, k, n)
        acc = randn(m, n)
        want = acc + ref.gemm_ref(x, w)
        with entry_as(ops, fns[("gemm_bf16", "change")], "gemm_mixed"):
            mine = ops.gemm(x, w, acc)
        for nm in names:
            with entry_as(ops, fns[("gemm_bf16", nm)], "gemm_mixed"):
                got = ops.gemm(x, w, acc)
            cs.check_close(torch, f"gemm bf16 {nm} {m}x{k}x{n}", got, want,
                           cs.BF16_RTOL, cs.BF16_ATOL)
            if nm != "parent" and not torch.equal(got, mine):
                differ.append(f"{nm} {m}x{k}x{n}")
        del x, w, acc, want, mine
    log(f"gemm bf16: {len(names)} builds within tolerance on {len(shapes)} "
        f"shapes; bits differ from the checkout's body: {differ or 'none'}")
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {"bits_differ": differ}
    for m, k, n in cs.GEMM_BF16_TIMED:
        x, w = cs.gemm_bf16_operands(torch, randn, m, k, n)
        row = {}
        for i, nm in enumerate(order):
            with entry_as(ops, fns[("gemm_bf16", nm)], "gemm_mixed"):
                t = cs.median_ms(torch, lambda: ops.gemm(x, w))
            row[nm if i < len(order) - 1 else "change_again"] = t
        row["torch_matmul_bf16"] = cs.median_ms(torch,
                                                lambda: torch.matmul(x, w))
        b_ms, b_by = cs.bound_ms(2 * (m * k + k * n) + 4 * m * n,
                                 2.0 * m * n * k, cs.PEAK_BF16_FLOP_S)
        row["bound_ms"] = b_ms
        out[f"{m}x{k}x{n}"] = row
        del x, w
        torch.cuda.empty_cache()
        log(f"gemm bf16 {m}x{k}x{n} ms: " + ", ".join(
            f"{nm} {t:.4f}" for nm, t in row.items()) + f" ({b_by})")
    passed = []
    with entry_as(ops, fns[("gemm_bf16", "change")], "gemm_mixed"):
        cs.gemm_bf16_check(torch, ops, ref, randn)
    log("gemm bf16: the checkout's body passes chip_smoke.gemm_bf16_check")
    for nm in faults:
        what = GEMM_FAULTS[nm[len("fault_"):]][0]
        try:
            with entry_as(ops, fns[("gemm_bf16", nm)], "gemm_mixed"):
                cs.gemm_bf16_check(torch, ops, ref, randn)
            verdict = "passes"
            passed.append(nm)
        except SystemExit as e:
            verdict = f"fails ({e})"
        torch.cuda.synchronize()
        out[nm] = verdict
        log(f"gemm bf16 {nm} ({what}): gemm_bf16_check {verdict}")
    if differ:
        cs.fail(f"gemm bf16 variants not bit-identical: {differ}")
    if passed:
        cs.fail(f"gemm bf16 faults pass the check: {passed}")
    return out


# Prefill shapes of the flash kernel at B=4 (bf16, causal): (label, query
# heads, KV heads, T, d, window, V's width dv).
FLASH_SHAPES = [("gemma3-12b", 64, 32, 2048, 240, 0, 240),
                ("gemma3-12b local", 64, 32, 2048, 240, 1024, 240),
                ("gemma3-27b", 128, 64, 2048, 168, 0, 168),
                ("deepseek-v3 MLA", 512, 512, 2048, 192, 0, 128),
                ("qwen3-0.6b", 64, 32, 2048, 128, 0, 128)]


def flash_phase(torch, cs, ops, ref, fns):
    """Each flash build against the plain version (``check_rows``) and
    against the checkout's kernel (equal bits or not) at the prefill
    shapes, timed as ``chip_smoke.py`` times kernels."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    names = [n for k, n in fns if k == "flash_attention"]
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {}
    for label, bh, kvh, t, d, w, dv in FLASH_SHAPES:
        q = torch.randn(bh, t, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(kvh, t, n, generator=gen, device="cuda"
                            ).bfloat16() for n in (d, dv))
        # an entry without dv gets V zero-padded to d (the call MLA made
        # before V took its own width); its first dv columns are compared
        vd = torch.nn.functional.pad(v, (0, d - dv))
        want = ref.flash_attention_plain(q, k, v, True, w)
        with entry_as(ops, fns[("flash_attention", "change")]):
            mine = ops.flash_attention(q, k, v, True, w)
        row = {}
        for i, nm in enumerate(order):
            vv = vd if getattr(fns[("flash_attention", nm)], "no_dv",
                               False) else v
            with entry_as(ops, fns[("flash_attention", nm)]):
                got = ops.flash_attention(q, k, vv, True, w)[..., :dv]
                whole, worst = cs.check_rows(torch, f"flash {nm} {label}",
                                             got, want)
                ms = cs.median_ms(torch, lambda: ops.flash_attention(
                    q, k, vv, True, w))
            row[nm if i < len(order) - 1 else "change_again"] = {
                "ms": ms, "rel_l2_whole": whole, "rel_l2_worst_row": worst,
                "equal_to_change": bool(torch.equal(got, mine))}
        b_ms, b_by = cs.flash_bound(bh, t, t, d, True, 2,
                                    cs.PEAK_BF16_FLOP_S, kv_heads=kvh,
                                    window=w, dv=dv)
        row["bound_ms"] = b_ms
        out[label] = row
        del q, k, v, vd, vv, want, mine, got
        torch.cuda.empty_cache()
        log(f"flash {label} (BH={bh} over {kvh}, T={t}, d={d}, dv={dv}, "
            f"window {w}) "
            f"ms: " + ", ".join(f"{nm} {r['ms']:.4f}" + (
                "" if r["equal_to_change"] else " (bits differ)")
                for nm, r in row.items() if nm != "bound_ms")
            + f"; bound {b_ms:.4f} ({b_by})")
    return out


# Flash past d = 256 (bf16, causal), timed: (label, query heads, KV heads,
# T, d, dv): chip_smoke.py's two timed rows.
FLASH_WIDE_TIMED = [("d=512", 32, 32, 2048, 512, 512),
                    ("absorbed MLA", 128, 1, 2048, 576, 512),
                    ("d=1024", 32, 32, 2048, 1024, 1024),
                    ("d=2048", 32, 32, 2048, 2048, 2048)]
# Past the single CTA's reach (d > 576 or dv > 512) only the checkout's
# body, the parent's and the variants named CLUSTER_PREFIX* are timed (the
# other variants run the checkout's code there), each in fewer calls.
CLUSTER_PREFIX = "cl_"


def cluster_row(d, dv):
    """Whether (d, dv) lies past one CTA's reach."""
    return d > 576 or dv > 512


def timed_builds(names, d, dv):
    """The builds timed at (d, dv), in the order change, the others,
    change."""
    keep = [nm for nm in names if nm != "change" and (
        not cluster_row(d, dv) or nm == "parent"
        or nm.startswith(CLUSTER_PREFIX))]
    return ["change"] + keep + ["change"]


def row_reps(d, dv):
    """median_ms's (reps, launches) at (d, dv): fewer past one CTA's
    reach, where the parent's d-sliced bodies take 0.1-0.3 s a call."""
    return (3, 3) if cluster_row(d, dv) else (5, 20)
# ... and held to the plain version (d, dv) in each of chip_smoke.py's
# CONTRACT_MODES.
FLASH_WIDE_CHECKED = ((320, 100), (385, 256), (512, 512), (576, 512),
                      (640, 640), (1024, 1024), (1100, 64), (600, 513),
                      (4160, 4160))


def flash_wide_phase(torch, cs, ops, ref, fns):
    """Each build of the single-pass body (and the parent's: past d = 576
    its d-sliced body until the clusters came) held to the plain version
    with ``check_rows`` on
    ``chip_smoke.CONTRACT_MODES`` at ``FLASH_WIDE_CHECKED`` and at the
    timed rows, its bits compared with the checkout's body and with a
    second launch of its own, and timed at ``FLASH_WIDE_TIMED`` (change,
    variants, parent, change) beside ``F.scaled_dot_product_attention``.
    Fails if a build fails its check or two of its launches differ."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    names = [n for k, n in fns if k == "flash_wide"]

    def qkv(bh, kvh, tq, tk, d, dv):
        return (torch.randn(bh, tq, d, generator=gen, device="cuda"
                            ).bfloat16(),
                *(torch.randn(kvh, tk, n, generator=gen, device="cuda"
                              ).bfloat16() for n in (d, dv)))

    n_checked = 0
    # Whether each build gives the checkout's and the parent's bits on
    # every checked case within one CTA's reach.
    checked = [nm for nm in names if nm not in DIAGNOSTIC]
    bits = {nm: {"change": True, "parent": True} for nm in checked}
    for d, dv in FLASH_WIDE_CHECKED:
        for label, tq, tk, h, g, causal, window in cs.CONTRACT_MODES:
            q, k, v = qkv(h, h // g, tq, tk, d, dv)
            want = ref.flash_attention_plain(q, k, v, causal, window)
            got = {}
            for nm in checked:
                with entry_as(ops, fns[("flash_wide", nm)]):
                    got[nm] = ops.flash_attention(q, k, v, causal, window)
                    cs.check_rows(torch, f"flash {nm} d={d} dv={dv} {label}",
                                  got[nm], want)
                n_checked += 1
            if not cluster_row(d, dv):
                for nm in checked:
                    for other in ("change", "parent"):
                        if other in got:
                            bits[nm][other] &= bool(torch.equal(got[nm],
                                                                got[other]))
        log(f"flash d={d} dv={dv}: {', '.join(checked)} pass check_rows in "
            f"every mode")
    log(f"flash past d = 256: {len(checked)} builds pass check_rows on "
        f"{len(FLASH_WIDE_CHECKED) * len(cs.CONTRACT_MODES)} cases each; "
        "within one CTA's reach, bit for bit the checkout's / the "
        "parent's: " + ", ".join(f"{nm} {b['change']} / {b['parent']}"
                                  for nm, b in bits.items()))
    if "parent" in names and not bits["change"]["parent"]:
        cs.fail("flash past d = 256: the checkout's body differs from the "
                "parent's within one CTA's reach")
    out = {"cases_checked": n_checked, "bits_equal_within_reach": bits}
    # Clusters resident at once (cudaOccupancyMaxActiveClusters) for each
    # cluster size the rule gives, at d = dv = 512 C (d = 4,160: Q in
    # rounds), each type.
    resident = {}
    for d in [512 * c for c in range(2, 9)] + [4160]:
        for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            resident[f"{str(dt)[6:]} d={d}"] = {
                "cluster": ops.flash_cluster(dt, d, d),
                "resident": ops.entry("flash_clusters_resident")(code, code,
                                                                 d, d)}
    log("clusters resident at once: " + ", ".join(
        f"{k} (C = {r['cluster']}) {r['resident']}"
        for k, r in resident.items()))
    out["clusters_resident"] = resident
    for label, bh, kvh, t, d, dv in FLASH_WIDE_TIMED:
        q, k, v = qkv(bh, kvh, t, t, d, dv)
        want = ref.flash_attention_plain(q, k, v, True)
        with entry_as(ops, fns[("flash_wide", "change")]):
            mine = ops.flash_attention(q, k, v, True)
        reps, calls = row_reps(d, dv)
        builds = timed_builds(names, d, dv)
        row = {"body": ops.flash_body(torch.bfloat16, d, dv),
               "cluster": ops.flash_cluster(torch.bfloat16, d, dv)}
        for i, nm in enumerate(builds):
            with entry_as(ops, fns[("flash_wide", nm)]):
                got = ops.flash_attention(q, k, v, True)
                if nm in DIAGNOSTIC:      # timed only
                    whole = worst = None
                else:
                    whole, worst = cs.check_rows(
                        torch, f"flash {nm} {label}", got, want)
                    if not torch.equal(got, ops.flash_attention(q, k, v,
                                                                True)):
                        cs.fail(f"flash {nm} {label}: two launches differ")
                ms = cs.median_ms(torch, lambda: ops.flash_attention(
                    q, k, v, True), reps=reps, launches=calls)
            row[nm if i < len(builds) - 1 else "change_again"] = {
                "ms": ms, "rel_l2_whole": whole, "rel_l2_worst_row": worst,
                "equal_to_change": bool(torch.equal(got, mine))}
            del got
        lib, how = cs.sdpa_yardstick(torch, q, k, v)
        row["sdpa"] = {"ms": cs.median_ms(torch, lib, reps=reps,
                                          launches=calls), "how": how,
                       "backend": cs.sdpa_backend(torch, lib)}
        row["plain"] = {"ms": cs.median_ms(
            torch, lambda: ref.flash_attention_plain(q, k, v, True),
            reps=3, launches=3)}
        b_ms, b_by = cs.flash_bound(bh, t, t, d, True, 2,
                                    cs.PEAK_BF16_FLOP_S, kv_heads=kvh, dv=dv)
        row["bound_ms"] = b_ms
        out[label] = row
        del q, k, v, want, mine
        torch.cuda.empty_cache()
        log(f"flash {label} (BH={bh} over {kvh}, T={t}, d={d}, dv={dv}, "
            "causal) ms: " + ", ".join(
                f"{nm} {r['ms']:.4f}" + ("" if r.get("equal_to_change", True)
                                         else " (bits differ)")
                for nm, r in row.items() if isinstance(r, dict))
            + f" ({how}, backend {row['sdpa']['backend']}; body "
            f"{row['body']}, C = {row['cluster']}); bound {b_ms:.4f} "
            f"({b_by})")
    return out


# The fp32 bodies, timed: (label, query heads, KV heads, T, d, dv, the
# body): chip_smoke.py's two fp32 rows (causal).
FLASH_F32_TIMED = [("qwen3-0.6b", 64, 32, 2048, 128, 128, "fp32"),
                   ("d=512", 32, 32, 2048, 512, 512, "fp32 single-pass"),
                   ("d=1024", 32, 32, 2048, 1024, 1024, "fp32 single-pass"),
                   ("d=2048", 32, 32, 2048, 2048, 2048, "fp32 single-pass")]
# ... and held to the plain version (d, dv) in each of chip_smoke.py's
# CONTRACT_MODES: each instantiation and the staged route's widths.
FLASH_F32_CHECKED = ((33, 33), (64, 64), (128, 128), (192, 128),
                     (255, 255), (320, 100), (512, 512), (576, 512),
                     (640, 640), (1024, 1024), (1100, 64), (4160, 4160))


def flash_f32_phase(torch, cs, ops, ref, fns):
    """Each build of the fp32 bodies (and the parent's: past d = 576 its
    d-sliced body until the clusters came) held to the plain version at
    rtol 1e-5 / atol 1e-4 on ``chip_smoke.CONTRACT_MODES`` at
    ``FLASH_F32_CHECKED`` and at the timed rows, its bits compared with
    the checkout's bodies and with a second launch of its own, and timed
    at ``FLASH_F32_TIMED`` (change, variants, parent, change) beside fp32
    ``F.scaled_dot_product_attention`` (``enable_gqa`` and on repeated KV
    heads) and the bound.  Fails if a build fails its check or two of its
    launches differ."""
    gen = torch.Generator(device="cuda").manual_seed(30)
    names = [n for k, n in fns if k == "flash_f32"]

    def qkv(bh, kvh, tq, tk, d, dv):
        return (torch.randn(bh, tq, d, generator=gen, device="cuda"),
                *(torch.randn(kvh, tk, n, generator=gen, device="cuda")
                  for n in (d, dv)))

    def run(nm, q, k, v, causal, window=0):
        with entry_as(ops, fns[("flash_f32", nm)]):
            return ops.flash_attention(q, k, v, causal, window)

    # Whether each build gives the checkout's bits on every checked case,
    # and the parent's on those within one CTA's reach.
    n_checked = 0
    bits = {nm: {"change": True, "parent": True} for nm in names}
    for d, dv in FLASH_F32_CHECKED:
        for label, tq, tk, h, g, causal, window in cs.CONTRACT_MODES:
            q, k, v = qkv(h, h // g, tq, tk, d, dv)
            want = ref.flash_attention_plain(q, k, v, causal, window)
            got = {}
            for nm in names:
                got[nm] = run(nm, q, k, v, causal, window)
                cs.check_close(torch, f"flash {nm} d={d} dv={dv} {label}",
                               got[nm], want, cs.KERNEL_RTOL, cs.KERNEL_ATOL)
                n_checked += 1
            for nm in names:
                bits[nm]["change"] &= bool(torch.equal(got[nm],
                                                       got["change"]))
                if "parent" in got and not cluster_row(d, dv):
                    bits[nm]["parent"] &= bool(torch.equal(got[nm],
                                                           got["parent"]))
    log(f"fp32 flash: {len(names)} builds within rtol {cs.KERNEL_RTOL} / "
        f"atol {cs.KERNEL_ATOL} on "
        f"{len(FLASH_F32_CHECKED) * len(cs.CONTRACT_MODES)} cases each; "
        "bit for bit the checkout's bodies on every case / the parent's "
        "within one CTA's reach: " + ", ".join(
            f"{nm} {b['change']} / {b['parent']}" for nm, b in bits.items()))
    if "parent" in names and not bits["change"]["parent"]:
        cs.fail("fp32 flash: the checkout's bodies differ from the "
                "parent's within one CTA's reach")
    out = {"cases_checked": n_checked, "bits_equal_on_checked": bits}
    for label, bh, kvh, t, d, dv, body in FLASH_F32_TIMED:
        if ops.flash_body(torch.float32, d, dv) != body:
            cs.fail(f"flash fp32 {label}: runs "
                    f"{ops.flash_body(torch.float32, d, dv)}, not {body}")
        q, k, v = qkv(bh, kvh, t, t, d, dv)
        want = ref.flash_attention_plain(q, k, v, True)
        mine = run("change", q, k, v, True)
        reps, calls = row_reps(d, dv)
        builds = timed_builds(names, d, dv)
        row = {"cluster": ops.flash_cluster(torch.float32, d, dv)}
        for i, nm in enumerate(builds):
            with entry_as(ops, fns[("flash_f32", nm)]):
                got = ops.flash_attention(q, k, v, True)
                err = cs.check_close(torch, f"flash {nm} {label}", got,
                                     want, cs.KERNEL_RTOL, cs.KERNEL_ATOL)
                if not torch.equal(got, ops.flash_attention(q, k, v, True)):
                    cs.fail(f"flash {nm} {label}: two launches differ")
                ms = cs.median_ms(torch, lambda: ops.flash_attention(
                    q, k, v, True), reps=reps, launches=calls)
            row[nm if i < len(builds) - 1 else "change_again"] = {
                "ms": ms, "max_abs_err": err,
                "equal_to_change": bool(torch.equal(got, mine))}
            del got
        lib, how = cs.sdpa_yardstick(torch, q, k, v)
        row["sdpa"] = {"ms": cs.median_ms(torch, lib, reps=reps,
                                          launches=calls), "how": how,
                       "backend": cs.sdpa_backend(torch, lib)}
        row["plain"] = {"ms": cs.median_ms(
            torch, lambda: ref.flash_attention_plain(q, k, v, True),
            reps=3, launches=3)}
        if kvh < bh:
            kr, vr = (x.repeat_interleave(bh // kvh, dim=0) for x in (k, v))
            lib_r, _ = cs.sdpa_yardstick(torch, q, kr, vr)
            row["sdpa_repeated_heads"] = {
                "ms": cs.median_ms(torch, lib_r),
                "backend": cs.sdpa_backend(torch, lib_r)}
            del kr, vr, lib_r
        b_ms, b_by = cs.flash_bound(bh, t, t, d, True, 4,
                                    cs.PEAK_FP32_FLOP_S, kv_heads=kvh, dv=dv)
        row["bound_ms"] = b_ms
        out[label] = row
        del q, k, v, want, mine
        torch.cuda.empty_cache()
        log(f"flash fp32 {label} (BH={bh} over {kvh}, T={t}, d={d}, "
            f"dv={dv}, causal; {body}) ms: " + ", ".join(
                f"{nm} {r['ms']:.4f}" + ("" if r.get("equal_to_change", True)
                                         else " (bits differ)")
                for nm, r in row.items() if isinstance(r, dict))
            + f" (SDPA {how}, backend {row['sdpa']['backend']}; C = "
            f"{row['cluster']}); bound {b_ms:.4f} ({b_by})")
    return out


# The shapes the bf16 body at d <= 128 runs on the paths (chip_smoke.py's
# rows): (label, query heads, KV heads, Tq, Tk, d, causal, window).
FLASH_D128_SHAPES = [
    ("qwen3-0.6b prefill", 64, 32, 2048, 2048, 128, True, 0),
    ("granite-8b prefill", 128, 32, 2048, 2048, 128, True, 0),
    ("hymba-1.5b prefill", 100, 20, 2048, 2048, 64, True, 0),
    ("kimi-k2 prefill", 256, 32, 2048, 2048, 112, True, 0),
    ("whisper-base encoder", 32, 32, 1500, 1500, 64, False, 0),
    ("llama-3.2-vision cross", 128, 32, 2048, 1601, 128, False, 0),
    ("qwen3-0.6b train", 32, 16, 4096, 4096, 128, True, 0),
    ("hymba-1.5b train", 50, 10, 4096, 4096, 64, True, 2048)]
# The shapes the phase probes read (the heaviest query tile of head 0).
FLASH_D128_PROBED = ("qwen3-0.6b prefill", "hymba-1.5b prefill")
# Which clock64 marks bound each phase of a tile, per probe: (name, from,
# to); "busy" spans are the warpgroup's own products in flight, from
# their issue to the wait that sees them done.
PROBE_PHASES = {
    "parent_probe": {"phases": [("wait_full", 0, 1), ("qk", 1, 2),
                                ("softmax", 2, 3), ("pv", 3, 4)],
                     "busy": [(1, 2), (3, 4)], "first": 0, "last": 4},
    "d128_probe": {"phases": [("wait_full", 0, 1), ("wait_turn", 1, 2),
                              ("issue", 2, 3), ("qk_wait", 3, 4),
                              ("scores", 4, 5), ("pv_wait", 5, 6),
                              ("rescale_pack", 6, 7)],
                   "busy": [(2, 6)], "first": 0, "last": 7}}


def probe_read(build, name):
    """The clock64 stamps of the probe build ``name`` (its last call), as
    [3 warpgroups][PROBE_TILES][PROBE_MARKS] int64."""
    import ctypes

    import numpy as np
    lib = ctypes.CDLL(os.path.join(build.BUILD_DIR, "variants",
                                   f"libflash_d128_{name}.so"))
    buf = np.zeros(3 * PROBE_TILES * PROBE_MARKS, dtype=np.int64)
    rc = lib.flash_probe_read(ctypes.c_void_p(buf.ctypes.data))
    if rc != 0:
        raise RuntimeError(f"flash_probe_read: CUDA error {rc}")
    return buf.reshape(3, PROBE_TILES, PROBE_MARKS)


def probe_cta_read(build, name):
    """The grid probe's stamps of the probe build ``name``, as
    [PROBE_CTAS][CTA_MARKS] int64."""
    import ctypes

    import numpy as np
    lib = ctypes.CDLL(os.path.join(build.BUILD_DIR, "variants",
                                   f"libflash_d128_{name}.so"))
    buf = np.zeros(PROBE_CTAS * CTA_MARKS, dtype=np.int64)
    rc = lib.flash_probe_cta_read(ctypes.c_void_p(buf.ctypes.data))
    if rc != 0:
        raise RuntimeError(f"flash_probe_cta_read: CUDA error {rc}")
    return buf.reshape(PROBE_CTAS, CTA_MARKS)


def grid_shares(cta):
    """From the grid probe's stamps of a launch (its first PROBE_CTAS
    CTAs, each with a start stamp): the launch's span (first start to last store, ns),
    the SMs' summed idle share of it, split into before an SM's first CTA,
    between its CTAs and after its last; the share of the CTAs' time spent
    before their first K tile landed; the mean and largest CTA; and the SM
    clock (GHz) from clock64 against globaltimer."""
    import numpy as np
    c = cta[cta[:, 0] != 0]
    start, sm, ready = c[:, 0], c[:, 1], c[:, 2]
    end = c[:, 3:6].max(axis=1)
    t0, t1 = int(start.min()), int(end.max())
    span = float(t1 - t0)
    sms = np.unique(sm)
    head = gaps = tail = 0.0
    for s_ in sms:
        i = np.argsort(start[sm == s_])
        a, b = start[sm == s_][i], end[sm == s_][i]
        head += float(a[0] - t0)
        tail += float(t1 - b[-1])
        gaps += float(np.clip(a[1:] - b[:-1], 0, None).sum())
    dur = (end - start).astype(np.float64)
    whole = span * len(sms)
    ghz = (c[:, 7] - c[:, 6]) / np.maximum(c[:, 3] - start, 1)
    return {"ctas": int(len(c)), "sms": int(len(sms)), "span_us": span / 1e3,
            "sm_idle": 1.0 - float(dur.sum()) / whole,
            "sm_idle_head": head / whole, "sm_idle_between": gaps / whole,
            "sm_idle_tail": tail / whole,
            "before_first_k": float((ready - start).sum() / dur.sum()),
            "cta_mean_us": float(dur.mean()) / 1e3,
            "cta_max_us": float(dur.max()) / 1e3,
            "sm_clock_ghz": float(np.median(ghz))}


def probe_clear(build, name):
    import ctypes
    lib = ctypes.CDLL(os.path.join(build.BUILD_DIR, "variants",
                                   f"libflash_d128_{name}.so"))
    rc = lib.flash_probe_clear()
    if rc != 0:
        raise RuntimeError(f"flash_probe_clear: CUDA error {rc}")


def probe_shares(marks, kind):
    """Each phase's share of the probed CTA's tiles (clock64 cycles,
    summed over the tiles a warpgroup stamped), the share in which the
    warpgroup had no product of its own in flight, and the share of the
    span in which neither warpgroup had one (the CTA's tensor work
    idle)."""
    spec = PROBE_PHASES[kind]
    out, busy_all, span = {}, [], [None, None]
    for wg in range(3):
        rows = [r for r in marks[wg] if r[spec["first"]] > 0
                and r[spec["last"]] > 0]
        if not rows:
            continue
        t0, t1 = rows[0][spec["first"]], rows[-1][spec["last"]]
        total = float(t1 - t0)
        span[0] = t0 if span[0] is None else min(span[0], t0)
        span[1] = t1 if span[1] is None else max(span[1], t1)
        ph = {n: float(sum(r[b] - r[a] for r in rows)) / total
              for n, a, b in spec["phases"]}
        out[f"wg{wg}"] = {"tiles": len(rows), "cycles": total,
                          "cycles_a_tile": total / len(rows), **ph}
        if spec["busy"]:
            busy = [(int(r[a]), int(r[b])) for r in rows
                    for a, b in spec["busy"]]
            busy_all += busy
            out[f"wg{wg}"]["own_products_idle"] = \
                1.0 - sum(b - a for a, b in busy) / total
    merged, cur = 0, None
    for a, b in sorted(busy_all):
        if cur is None or a > cur[1]:
            if cur:
                merged += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur:
        merged += cur[1] - cur[0]
    if span[0] is not None and busy_all:
        out["cta_products_idle"] = 1.0 - merged / float(span[1] - span[0])
    return out


def flash_d128_phase(torch, cs, ops, ref, fns):
    """Each build of the bf16 body at d <= 128 (the variants; with
    ``--parent`` the old body and its phase probe) at
    ``FLASH_D128_SHAPES``: held by ``chip_smoke.check_rows`` against the
    plain version, its bits compared with the checkout's body and with a
    second launch of its own, timed (change, variants, parent, change)
    beside ``F.scaled_dot_product_attention`` and the bound; the probes'
    phase shares at ``FLASH_D128_PROBED``; the registers and spills of
    both bodies' instantiations.  The ``DIAGNOSTIC`` builds are timed
    only.  Fails if another build fails its check or two of its launches
    differ."""
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(32)
    names = [n for k, n in fns if k == "flash_d128"]
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {"nvcc": {"change": cs.ws_nvcc_report(
        build.build_log.get("flash_attention", ""))["instantiations"]}}
    if ("flash_d128", "parent") in REPORTS:
        def key_of(ln):
            m = re.search(r"flash_bf16_kernelILi(\d+)ELb(\d)E"
                          r"(13__nv_bfloat16|f)E", ln)
            return (f"flash_bf16_kernel<{m.group(1)}, "
                    f"{'true' if m.group(2) == '1' else 'false'}, "
                    f"{'bf16' if m.group(3) != 'f' else 'float'}>"
                    if m else None)
        out["nvcc"]["parent"] = cs.nvcc_rows(
            REPORTS[("flash_d128", "parent")], key_of)
    for who, rows in out["nvcc"].items():
        for key, r in sorted(rows.items()):
            log(f"nvcc flash d<=128 {who} {key}: {r.get('registers')} "
                f"registers a thread, {r.get('spill_stores')} / "
                f"{r.get('spill_loads')} bytes spill stores / loads")
    for label, bh, kvh, tq, tk, d, causal, w in FLASH_D128_SHAPES:
        if ops.flash_body(torch.bfloat16, d, d) != "bf16":
            cs.fail(f"flash {label}: d = {d} runs "
                    f"{ops.flash_body(torch.bfloat16, d, d)}")
        q = torch.randn(bh, tq, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(kvh, tk, d, generator=gen, device="cuda"
                            ).bfloat16() for _ in range(2))
        want = ref.flash_attention_plain(q, k, v, causal, w)
        with entry_as(ops, fns[("flash_d128", "change")]):
            mine = ops.flash_attention(q, k, v, causal, w)
        row = {}
        for i, nm in enumerate(order):
            with entry_as(ops, fns[("flash_d128", nm)]):
                got = ops.flash_attention(q, k, v, causal, w)
                if nm in DIAGNOSTIC:      # timed only
                    whole = worst = None
                else:
                    whole, worst = cs.check_rows(
                        torch, f"flash {nm} {label}", got, want)
                    if not torch.equal(got, ops.flash_attention(
                            q, k, v, causal, w)):
                        cs.fail(f"flash {nm} {label}: two launches differ")
                ms = cs.median_ms(torch, lambda: ops.flash_attention(
                    q, k, v, causal, w))
            row[nm if i < len(order) - 1 else "change_again"] = {
                "ms": ms, "rel_l2_whole": whole, "rel_l2_worst_row": worst,
                "equal_to_change": bool(torch.equal(got, mine))}
            del got
        lib, how = cs.sdpa_yardstick(torch, q, k, v, w, causal)
        row["sdpa"] = {"ms": cs.median_ms(torch, lib), "how": how}
        b_ms, b_by = cs.flash_bound(bh, tq, tk, d, causal, 2,
                                    cs.PEAK_BF16_FLOP_S, kv_heads=kvh,
                                    window=w)
        row["bound_ms"] = b_ms
        if label in FLASH_D128_PROBED:
            for nm in ("d128_probe", "parent_probe"):
                if ("flash_d128", nm) not in fns:
                    continue
                probe_clear(build, nm)
                with entry_as(ops, fns[("flash_d128", nm)]):
                    ops.flash_attention(q, k, v, causal, w)
                torch.cuda.synchronize()
                row[f"{nm}_shares"] = sh = probe_shares(
                    probe_read(build, nm), nm)
                if nm == "d128_probe":
                    sh["grid"] = grid_shares(probe_cta_read(build, nm))
                log(f"flash {nm} {label}: " + "; ".join(
                    f"{part} " + ", ".join(f"{n} {x:.4g}"
                                           for n, x in val.items())
                    if isinstance(val, dict) else f"{part} {val:.4g}"
                    for part, val in sh.items()))
        out[label] = row
        del q, k, v, want, mine
        torch.cuda.empty_cache()
        log(f"flash d<=128 {label} (BH={bh} over {kvh}, Tq={tq}, Tk={tk}, "
            f"d={d}, causal={causal}, window {w}) ms: " + ", ".join(
                f"{nm} {r['ms']:.4f}" + ("" if r.get("equal_to_change", True)
                                         else " (bits differ)")
                for nm, r in row.items() if isinstance(r, dict)
                and "ms" in r)
            + f" (SDPA {how}); bound {b_ms:.4f} ({b_by})")
    return out


_FL_TILE = []


def fl_widest_slice(torch):
    """cols / mask / vals of the widest ELL slice of full-scale Flickr at
    the engine's default geometry (n1 = 4096, n2 = 128), partitioned once
    a run."""
    if not _FL_TILE:
        from repro_torch.core import graph as G
        from repro_torch.core.passes.partition import (PartitionConfig,
                                                       partition_graph)
        t0 = time.perf_counter()
        fl = G.synthesize("FL").gcn_normalized()
        pg = partition_graph(fl, PartitionConfig(n1=4096, n2=128))
        tile = max((t for ts in pg.tiles.values() for t in ts),
                   key=lambda t: (t.width, t.nnz))
        log(f"FL partition in {time.perf_counter() - t0:.1f} s; widest "
            f"slice (j,k)=({tile.shard_row},{tile.shard_col}) "
            f"w={tile.width} nnz={tile.nnz}")
        _FL_TILE.append(tile)
    tile = _FL_TILE[0]
    return (torch.as_tensor(tile.cols, device="cuda").contiguous(),
            torch.as_tensor(tile.edge_pos >= 0, device="cuda").contiguous(),
            torch.as_tensor(tile.vals, device="cuda").contiguous())


def narrow_tile(torch, gen, w, n1=4096):
    """A narrow slice as most of a power-law program's are: row lengths
    uniform in [0, w], live slots packed at the front."""
    lens = torch.randint(0, w + 1, (n1,), generator=gen, device="cuda")
    mask = (torch.arange(w, device="cuda")[None] < lens[:, None]
            ).contiguous()
    cols = torch.where(mask, torch.randint(0, n1, (n1, w), generator=gen,
                                           device="cuda"), 0)
    return cols.to(torch.int32).contiguous(), mask


def hub_tile(torch, gen, n1=4096, w=512):
    lens = torch.full((n1,), 25, device="cuda")
    lens[torch.randperm(n1, generator=gen, device="cuda")[:256]] = w
    mask = (torch.arange(w, device="cuda")[None] < lens[:, None]
            ).contiguous()
    cols = torch.where(mask, torch.randint(0, n1, (n1, w), generator=gen,
                                           device="cuda"), 0)
    return cols.to(torch.int32).contiguous(), mask


# SDDMM variants whose bf16-operand sums take another order (held to
# tolerance there; their fp32 route is the checkout's).
SDDMM_BF16_OTHER_ORDER = ("bf16_load16",)


def sddmm_bf16_check(torch, cs, ops, ref, bf16_fns, hd, hs, cols, mask,
                     acc, label):
    """Every build's bf16-operand route on bf16 copies of ``hd`` / ``hs``
    (as given and off by one element: both routes), fp32 and bf16
    stores: bit for bit the checkout's fp32 kernel on the widened
    operands where the build keeps the sum order (the parent's only
    noted), else within the masked-step tolerance.  Returns the builds
    whose bits differ."""
    hd16, hs16 = hd.bfloat16(), hs.bfloat16()
    want = ops.sddmm(hd16.float(), hs16.float(), cols, mask, acc)
    differ = []
    for nm, fn in bf16_fns.items():
        for route, a, b in (("vector", hd16, hs16),
                            ("scalar", cs.off_by_one(torch, hd16),
                             cs.off_by_one(torch, hs16))):
            with entry_as(ops, fn, "sddmm_bf16"):
                got = ops.sddmm(a, b, cols, mask, acc)
            cs.check_close(torch, f"sddmm bf16 {nm} {route} {label}", got,
                           ref.sddmm_step_ref(a, b, cols, mask, acc),
                           cs.KERNEL_RTOL, cs.KERNEL_ATOL)
            if torch.equal(got, want):
                continue
            if nm == "parent" or nm in SDDMM_BF16_OTHER_ORDER:
                differ.append(f"{nm} {route} {label}")
            else:
                cs.fail(f"sddmm bf16 {nm} {route} {label}: not bit for bit "
                        "the fp32 kernel on the widened operands")
    for route, a, b in (("vector", hd16, hs16),
                        ("scalar", cs.off_by_one(torch, hd16),
                         cs.off_by_one(torch, hs16))):
        if not torch.equal(ops.sddmm(a, b, cols, mask, acc,
                                     out_dtype=torch.bfloat16),
                           want.bfloat16()):
            cs.fail(f"sddmm bf16 {route} {label}, bf16 store: not the fp32 "
                    "kernel's result rounded once")
    return differ


def sddmm_phase(torch, cs, ops, ref, fns):
    """The SDDMM builds (fp32 operands through ``sddmm_f32``, bf16 ones
    through ``sddmm_bf16`` of the same copy) held on ``chip_smoke``'s
    sweep and two ragged shapes, then timed on the widest FL slice, the
    hub tile and two narrow tiles: fp32 per build beside
    ``torch.sparse.sampled_addmm``; bf16 operands per build on the vector
    route, and the checkout's scalar route (rows off by one element)."""
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = [n for k, n in fns if k == "sddmm"]
    bf16_fns = {nm: (ops.entry("sddmm_bf16") if nm == "change" else
                     copy_entry(build, f"sddmm_{nm}", "sddmm_bf16"))
                for nm in names}
    # The parent's per-slot sum order may differ: held to tolerance only.
    same_order = [n for n in names if n != "parent"]
    sweep = cs.SDDMM_SWEEP + [(40, 200, 50, 256), (33, 77, 60, 33)]
    bf16_differ = []
    for n1, w, ns, f in sweep:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        hd = torch.randn(n1, 2 * f, generator=gen, device="cuda")[:, f:]
        hs = torch.randn(ns, f, generator=gen, device="cuda")
        mask = torch.rand(n1, w, generator=gen, device="cuda") < 0.5
        acc = torch.randn(n1, w, generator=gen, device="cuda")
        with entry_as(ops, fns[("sddmm", "change")]):
            mine = ops.sddmm(hd, hs, cols, mask, acc)
        for nm in names:
            with entry_as(ops, fns[("sddmm", nm)]):
                cs.check_close(torch, f"sddmm {nm} {n1}x{w} f={f}",
                               ops.sddmm(hd, hs, cols),
                               ref.sddmm_ref(hd, hs, cols), cs.SDDMM_RTOL,
                               cs.SDDMM_ATOL)
                got = ops.sddmm(hd, hs, cols, mask, acc)
            cs.check_close(torch, f"sddmm {nm} masked {n1}x{w} f={f}", got,
                           ref.sddmm_step_ref(hd, hs, cols, mask, acc),
                           cs.KERNEL_RTOL, cs.KERNEL_ATOL)
            if nm in same_order and not torch.equal(got, mine):
                cs.fail(f"sddmm {nm} {n1}x{w}: not bit-identical to the "
                        "checkout's kernel")
        bf16_differ += sddmm_bf16_check(torch, cs, ops, ref, bf16_fns, hd,
                                        hs, cols, mask, acc,
                                        f"{n1}x{w} f={f}")
    log(f"sddmm: {len(names)} builds within tolerance on {len(sweep)} "
        "shapes, fp32 and bf16 operands (both routes); bf16 bits that "
        f"differ from the widened fp32 call: {bf16_differ or 'none'}")
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {}
    for tname, (cols, mask) in (("FL", fl_widest_slice(torch)[:2]),
                                ("hub", hub_tile(torch, gen)),
                                ("w8", narrow_tile(torch, gen, 8)),
                                ("w64", narrow_tile(torch, gen, 64))):
        n1, w = cols.shape
        h = torch.randn(2 * n1, 128, generator=gen, device="cuda")
        hd, hs = h[:n1], h[n1:]
        acc = torch.randn(n1, w, generator=gen, device="cuda")
        want = ref.sddmm_step_ref(hd, hs, cols, mask, acc)
        with entry_as(ops, fns[("sddmm", "change")]):
            mine = ops.sddmm(hd, hs, cols, mask, acc)
        row = {}
        for i, nm in enumerate(order):
            with entry_as(ops, fns[("sddmm", nm)]):
                got = ops.sddmm(hd, hs, cols, mask, acc)
                cs.check_close(torch, f"sddmm {nm} {tname}", got, want,
                               cs.KERNEL_RTOL, cs.KERNEL_ATOL)
                if nm in same_order and not torch.equal(got, mine):
                    cs.fail(f"sddmm {nm} {tname}: not bit-identical")
                t = cs.median_ms(torch, lambda: ops.sddmm(hd, hs, cols,
                                                          mask, acc))
            row[nm if i < len(order) - 1 else "change_again"] = t
        rows, slots = torch.nonzero(mask, as_tuple=True)
        crow = torch.zeros(n1 + 1, dtype=torch.int64, device="cuda")
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n1), 0)
        csr = torch.sparse_csr_tensor(crow, cols[rows, slots].long(),
                                      acc[rows, slots], size=(n1, n1))
        hdc, hst = hd.contiguous(), hs.t().contiguous()
        row["sampled_addmm"] = cs.median_ms(
            torch, lambda: torch.sparse.sampled_addmm(csr, hdc, hst))
        bf16_differ += sddmm_bf16_check(torch, cs, ops, ref, bf16_fns, hd,
                                        hs, cols, mask, acc, tname)
        hd16, hs16 = hd.bfloat16(), hs.bfloat16()
        hdu = cs.off_by_one(torch, hd16)
        hsu = cs.off_by_one(torch, hs16)
        row16 = {}
        for i, nm in enumerate(order):
            with entry_as(ops, bf16_fns[nm], "sddmm_bf16"):
                t = cs.median_ms(torch, lambda: ops.sddmm(hd16, hs16, cols,
                                                          mask, acc))
            row16[nm if i < len(order) - 1 else "change_again"] = t
        row16["change_scalar_route"] = cs.median_ms(
            torch, lambda: ops.sddmm(hdu, hsu, cols, mask, acc))
        row16["change_fp32"] = cs.median_ms(
            torch, lambda: ops.sddmm(hd, hs, cols, mask, acc))
        nnz = int(rows.numel())
        src_rows = int(torch.unique(cols[rows, slots]).numel())
        dst_rows = int(torch.unique(rows).numel())
        b16 = cs.bound_ms(9 * n1 * w + 4 * nnz + 2 * 128 * (dst_rows
                                                            + src_rows),
                          2.0 * nnz * 128)
        out[tname] = {"live": nnz, "ms": row, "bf16_ms": row16,
                      "bf16_bound_ms": b16[0], "bf16_bound_by": b16[1]}
        log(f"sddmm {tname} tile n1={n1} w={w} f=128 live={nnz} "
            "ms: " + ", ".join(f"{nm} {t:.4f}" for nm, t in row.items()))
        log(f"sddmm bf16 operands, {tname} tile ms (vector route per "
            "build; the checkout's scalar route and fp32 operands in the "
            "same call): " + ", ".join(f"{nm} {t:.4f}"
                                       for nm, t in row16.items())
            + f"; bound {b16[0]:.4f} ({b16[1]})")
    out["bf16_bits_differ"] = bf16_differ
    out["ptxas"] = {}
    for nm in names:
        report = (build.build_log.get("sddmm", "") if nm == "change"
                  else REPORTS.get(("sddmm", nm), ""))
        out["ptxas"][nm] = cs.nvcc_rows(report, cs.sddmm_nvcc_key)
        log(f"nvcc sddmm {nm}: " + "; ".join(
            f"{k} {r.get('registers')} registers, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spilled"
            for k, r in sorted(out["ptxas"][nm].items())))
    return out


def densify_phase(torch, cs, ops, ref, fns):
    """Each densify build (the checkout's kernel, the variants and the
    parent's) held bit for bit to ``ref.densify_ref``, twice alike, on the
    widest FL slice and ``chip_smoke.densify_cases`` (unaligned n_src,
    duplicates over quads and segments, full rows, out-of-range columns,
    the hub-heavy tile); then timed on the FL slice and the hub-heavy
    tile (change, variants, parent, change) beside
    ``index_put_(accumulate=True)``, a ``zero_`` of the block and the
    bound; and each build's ptxas registers and spills."""
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(7)
    names = [n for k, n in fns if k == "densify"]
    cols, _, vals = fl_widest_slice(torch)
    cases = [("FL widest slice", cols, vals, cols.shape[0])] + \
        cs.densify_cases(torch, gen)
    for label, c, v, n_src in cases:
        for nm in names:
            if nm in DIAGNOSTIC:      # timed only
                continue
            with entry_as(ops, fns[("densify", nm)], "densify"):
                cs.densify_same_bits(torch, ops, ref, f"{nm}, {label}", c, v,
                                     n_src)
    log(f"densify: {len([n for n in names if n not in DIAGNOSTIC])} builds "
        f"bit for bit the plain version, twice alike, on {len(cases)} tiles")
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {"ptxas": {}}
    for tname, (label, c, v, n_src) in (("FL", cases[0]),
                                        ("hub", cases[-1])):
        n1, w = c.shape
        row = {}
        for i, nm in enumerate(order):
            with entry_as(ops, fns[("densify", nm)], "densify"):
                t = cs.median_ms(torch, lambda: ops.densify(c, v, n_src))
            row[nm if i < len(order) - 1 else "change_again"] = t
        rr = torch.arange(n1, device="cuda")[:, None].expand(n1, w)
        cl = c.long()
        row["index_put_"] = cs.median_ms(
            torch, lambda: torch.zeros(n1, n_src, device="cuda").index_put_(
                (rr, cl), v, accumulate=True))
        # The write rate a library call reaches on the same block.
        blk = torch.empty(n1, n_src, device="cuda")
        row["zero_"] = cs.median_ms(torch, blk.zero_)
        del blk
        b_ms, b_by, live = cs.densify_bound(torch, v, n_src)
        out[tname] = {"n1": n1, "w": w, "n_src": n_src, "live": live,
                      "ms": row, "bound_ms": b_ms, "bound_by": b_by}
        log(f"densify {tname} ({label}) n1={n1} w={w} n_src={n_src} "
            f"live={live} ms: " + ", ".join(f"{nm} {t:.4f}"
                                              for nm, t in row.items())
            + f"; bound {b_ms:.4f} ({b_by})")
    for nm in names:
        report = (build.build_log.get("gemm", "") if nm == "change"
                  else REPORTS.get(("densify", nm), ""))
        got = cs.nvcc_rows(report, lambda ln: "ell_densify_kernel"
                           if "ell_densify_kernel" in ln else None)
        out["ptxas"][nm] = got.get("ell_densify_kernel", "no report")
        log(f"nvcc ell_densify_kernel, {nm}: {out['ptxas'][nm]}")
    return out


def copy_entry(build, tag, name):
    """Entry ``name`` of the variant copy ``tag`` (built by
    ``build_variants``), argtypes set."""
    import ctypes
    fn_name, argtypes = build._ARGTYPES[name]
    fn = getattr(ctypes.CDLL(os.path.join(build.BUILD_DIR, "variants",
                                          f"lib{tag}.so")), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


class spdmm_as:
    """While open, the SpDMM wrappers launch one build: ``single`` for
    ``ops.spdmm`` and ``steps`` for ``ops.spdmm_steps``; a build without a
    step-list entry (``steps`` None: the parent's) runs each list as
    ``ops.spdmm`` calls chained through acc, one launch a step, as the
    parent's executor did."""

    def __init__(self, ops, single, steps):
        self.ops, self.single, self.steps = ops, single, steps

    def __enter__(self):
        ops = self.ops
        self.real = ops.entry, ops.spdmm_steps
        real_entry, table = ops.entry, {"spdmm": self.single,
                                        "spdmm_steps": self.steps}
        ops.entry = lambda name: table.get(name) or real_entry(name)
        if self.steps is None:
            def chained(steps, h, acc=None, out_dtype=None):
                for cols, vals, row_len, off in steps.steps:
                    acc = ops.spdmm(cols, vals, h[off:off + steps.n_src],
                                    acc, row_len)
                return acc
            ops.spdmm_steps = chained

    def __exit__(self, *exc):
        self.ops.entry, self.ops.spdmm_steps = self.real


def spread_slice(torch, gen, n1, walked, n_src):
    """A synthetic [n1, 64] slice holding ``walked`` live slots spread
    evenly over its rows (at most 64 a row, live slots packed at the
    front): the widest FL slice's gathers without its hub rows."""
    lens = torch.full((n1,), walked // n1, device="cuda")
    lens[:walked % n1] += 1
    w = int(lens.max())
    live = torch.arange(w, device="cuda")[None] < lens[:, None]
    cols = torch.where(live, torch.randint(0, n_src, (n1, w), generator=gen,
                                           device="cuda"), 0)
    vals = torch.where(live, torch.randn(n1, w, generator=gen,
                                         device="cuda"), 0.0)
    return (cols.to(torch.int32).contiguous(), vals.contiguous(),
            lens.to(torch.int32).contiguous())


def spdmm_phase(torch, cs, ops, ref, fns):
    """The SpDMM builds on full-scale Flickr's b2 program (n1 = 4096, n2 =
    128): the widest slice as a one-step call, a synthetic slice with its
    walked slots spread at <= 64 a row, and the widest slice's whole row
    block as one step list, each timed per build in turns (change, the
    others, change) beside the plain version, ``torch.sparse.mm`` /
    ``torch.addmm`` on the CSR and the bound, held to the plain version
    and (same-order builds) to the checkout's bits; then a replayed b2@FL
    hit per route (the checkout's step lists, the parent's launch a step)
    under the profiler, its SpDMM launches binned by walked slots and
    longest row."""
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    from repro_torch.engine.executor import _staged
    from repro_torch.kernels import build
    gen = torch.Generator(device="cuda").manual_seed(3)
    t0 = time.perf_counter()
    fl = G.synthesize("FL").gcn_normalized()
    eng = Engine()
    prog = eng.compile("b2", fl)
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, vals_d = st.tiles("cols"), st.tiles("vals")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, vals, row_len = cols_d[key], vals_d[key], st.tiles("row_len")[key]
    n1, w = cols.shape
    f = pg.config.n2
    nnz, walked = pg.tiles[key[:2]][key[2]].nnz, int(row_len.sum())
    h_full = torch.randn(pg.n_blocks * n1, 4 * f, generator=gen,
                         device="cuda")[:, f:2 * f]
    h = h_full[key[1] * n1:(key[1] + 1) * n1]
    acc = torch.randn(n1, f, generator=gen, device="cuda")
    sc, sv, sl = spread_slice(torch, gen, n1, walked, n1)
    steps, b_nnz, b_walked, b_blocks = cs.row_block_steps(torch, prog,
                                                          key[0])
    log(f"FL b2 program in {time.perf_counter() - t0:.1f} s; widest slice "
        f"{key} w={w} nnz={nnz} walked={walked}; spread slice w="
        f"{sc.shape[1]}; row block {key[0]}: {len(steps)} steps, "
        f"{b_nnz} edges, {b_walked} slots walked, {b_blocks} source blocks")
    want = acc + ref.spdmm_ref(cols, vals, h)
    want_s = acc + ref.spdmm_ref(sc, sv, h)
    want_b = ref.spdmm_steps_ref(steps.steps, h_full, acc, steps.n_src)
    # "per_step" is the checkout's build called a step at a time (one
    # launch a step, chained through acc, as PR 30's executor called it).
    names = [n for k, n in fns if k == "spdmm"] + ["per_step"]
    single, many = {}, {}
    for nm in names:
        if nm in ("parent", "per_step"):
            single[nm] = (fns[("spdmm", nm)] if nm == "parent"
                          else ops.entry("spdmm"))
            many[nm] = None
        else:
            single[nm] = (ops.entry("spdmm") if nm == "change" else
                          copy_entry(build, f"spdmm_{nm}", "spdmm"))
            many[nm] = fns[("spdmm", nm)]
    with spdmm_as(ops, single["change"], many["change"]):
        mine = (ops.spdmm(cols, vals, h, acc, row_len),
                ops.spdmm_steps(steps, h_full, acc))
    order = ["change"] + [n for n in names if n != "change"] + ["change"]
    rows = {}
    for i, nm in enumerate(order):
        with spdmm_as(ops, single[nm], many[nm]):
            got = ops.spdmm(cols, vals, h, acc, row_len)
            cs.check_close(torch, f"spdmm {nm} widest slice", got, want,
                           cs.KERNEL_RTOL, cs.KERNEL_ATOL)
            got_b = ops.spdmm_steps(steps, h_full, acc)
            cs.check_close(torch, f"spdmm {nm} row block", got_b, want_b,
                           cs.KERNEL_RTOL, cs.KERNEL_ATOL)
            cs.check_close(torch, f"spdmm {nm} spread slice",
                           ops.spdmm(sc, sv, h, acc, sl), want_s,
                           cs.KERNEL_RTOL, cs.KERNEL_ATOL)
            same = nm == "change" or nm in SPDMM_SAME_BITS
            if same and not (torch.equal(got, mine[0])
                             and torch.equal(got_b, mine[1])):
                cs.fail(f"spdmm {nm}: not bit-identical to the checkout")
            row = {
                "slice_ms": cs.median_ms(torch, lambda: ops.spdmm(
                    cols, vals, h, acc, row_len)),
                "spread_ms": cs.median_ms(torch, lambda: ops.spdmm(
                    sc, sv, h, acc, sl)),
                "row_block_ms": cs.median_ms(torch, lambda: ops.spdmm_steps(
                    steps, h_full, acc)),
                "equal_to_change": bool(torch.equal(got, mine[0])
                                        and torch.equal(got_b, mine[1]))}
        rows[nm if i < len(order) - 1 else "change_again"] = row
        log(f"spdmm {nm}: widest slice {row['slice_ms']:.4f} ms, spread "
            f"slice {row['spread_ms']:.4f} ms, row block "
            f"{row['row_block_ms']:.4f} ms"
            + ("" if row["equal_to_change"] else " (bits differ)"))
    # The checkout's build on the row block with other hub thresholds:
    # the same bits, other times.
    hub_rows = {}
    with spdmm_as(ops, single["change"], many["change"]):
        for k in (None, 64, 256, 512, 1024, ops.SPDMM_HUB_SLOTS):
            alt = ops.SpdmmSteps(steps.steps, steps.n_src, hub_slots=k)
            if not torch.equal(ops.spdmm_steps(alt, h_full, acc), mine[1]):
                cs.fail(f"spdmm row block, hub_slots={k}: other bits")
            hub_rows[str(k)] = {
                "hub_entries": alt.n_hub, "hub_walked": alt.hub_walked,
                "ms": cs.median_ms(torch, lambda: ops.spdmm_steps(
                    alt, h_full, acc))}
            log(f"spdmm change row block, hub_slots={k}: {alt.n_hub} hub "
                f"entries walking {alt.hub_walked} slots, "
                f"{hub_rows[str(k)]['ms']:.4f} ms")
    live = vals != 0
    sp, hc = cs._ell_to_csr(torch, cols, vals, live, n1), h.contiguous()
    lib = {"slice_sparse_mm_ms": cs.median_ms(
        torch, lambda: torch.sparse.mm(sp, hc))}
    csr_b = cs.steps_to_csr(torch, steps, h_full.shape[0])
    hfc = h_full.contiguous()
    cs.check_close(torch, "torch.addmm row block", torch.addmm(acc, csr_b,
                                                               hfc),
                   want_b, 2e-2, 1e-2)
    lib["row_block_addmm_ms"] = cs.median_ms(
        torch, lambda: torch.addmm(acc, csr_b, hfc))
    lib["slice_plain_ms"] = cs.median_ms(
        torch, lambda: acc + ref.spdmm_ref(cols, vals, h), reps=3,
        launches=5)
    lib["row_block_plain_ms"] = cs.median_ms(
        torch, lambda: ref.spdmm_steps_ref(steps.steps, h_full, acc,
                                           steps.n_src), reps=3, launches=3)
    b_s = cs._spdmm_bound(n1, w, n1, f, nnz, walked)
    b_b = cs._spdmm_steps_bound(n1, len(steps), b_walked, b_blocks * n1, f,
                                b_nnz)
    log(f"spdmm yardsticks: widest slice torch.sparse.mm "
        f"{lib['slice_sparse_mm_ms']:.4f} ms, plain "
        f"{lib['slice_plain_ms']:.4f} ms, bound {b_s[0]:.4f} ms ({b_s[1]});"
        f" row block torch.addmm {lib['row_block_addmm_ms']:.4f} ms, plain "
        f"{lib['row_block_plain_ms']:.4f} ms, bound {b_b[0]:.4f} ms "
        f"({b_b[1]})")
    # Replayed b2@FL and gat-dot@FL hits (gat-dot's dynamic edge weights
    # run the one-step route): the SpDMM launches of one hit under the
    # profiler, binned.  Each route runs on an Engine of its own (its own
    # capture of the same program).
    from repro_torch.core import gnn_builders as TB
    x = G.random_features(fl, seed=50)
    gat = eng.compile(cs.build_gat_dot(TB, fl), fl)
    hist = {}
    routes = ["change", "per_step"] + (["parent"] if "parent" in names
                                        else [])
    for model, pr in (("b2@FL", prog), ("gat-dot@FL", gat)):
        for nm in routes:
            if model != "b2@FL" and nm == "per_step":
                continue            # gat-dot's steps are one-step calls
            with spdmm_as(ops, single[nm], many[nm]):
                rep = Engine()
                with cs.StepLog(torch, ops, pr,
                                lists=many[nm] is not None) as rec:
                    for _ in range(3):
                        rec.next_pass()
                        rep.run(pr, x)
                descs = [p for p in rec.passes if p][-1]
                ev = cs.spdmm_events(torch, lambda: (rep.run(pr, x),
                                                     rep._sync()))
            tag = f"replay {model} hit {nm}"
            if ev is None:
                log(f"{tag}: no device events (not measured)")
                continue
            hist[f"{model} {nm}"] = {
                "launches": len(ev), "ms": sum(ev) / 1e3,
                "bins": cs.launch_histogram(tag, ev, descs)}
    return {"slice": {"key": list(key), "w": w, "nnz": nnz,
                      "walked": walked, "bound_ms": b_s[0],
                      "bound_by": b_s[1]},
            "row_block": {"steps": len(steps), "nnz": b_nnz,
                          "walked": b_walked, "bound_ms": b_b[0],
                          "bound_by": b_b[1]},
            "ms": rows, "hub_slots": hub_rows, "library": lib,
            "replay": hist}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose gemm.cu (fp32 kernel, "
                         "densify and bf16 body) / spdmm.cu / sddmm.cu / "
                         "flash_attention.cu to build and time as the "
                         "variant 'parent'")
    ap.add_argument("--only", action="append", choices=list(VARIANTS),
                    help="build and time only this kernel's variants "
                         "(repeatable; default: every kernel)")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    import warnings

    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse")
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    card = cs.card_line()
    log(card)
    kernels = args.only or list(VARIANTS)
    fns = build_variants(build, args.parent, kernels)
    phases = {"gemm": gemm_phase, "gemm_bf16": gemm_bf16_phase,
              "densify": densify_phase, "sddmm": sddmm_phase,
              "flash_attention": flash_phase,
              "flash_wide": flash_wide_phase, "flash_f32": flash_f32_phase,
              "flash_d128": flash_d128_phase, "spdmm": spdmm_phase}
    result = {"card": card,
              "variants": {k: {n: d for n, (d, _) in v.items()}
                           for k, v in VARIANTS.items() if k in kernels}}
    for kern in kernels:
        fns[(kern, "change")] = ops.entry(ENTRY.get(kern, kern))
        result[kern] = phases[kern](torch, cs, ops, ref, fns)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump(result, fh, indent=1)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
