#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases (any failure exits non-zero; nothing is caught):

1. Card and build: the card's name and power limit (``nvidia-smi``), then
   every hand kernel built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once), with the build time and ``ptxas``
   report.
2. Kernels: each kernel against its plain torch version on the card, at
   the executor's tile shapes (GEMM 4096x128xN, N in {128, 64, 8},
   without and with the accumulator, against torch.matmul / torch.addmm;
   GEMM rows [r0, r1) of a call bit-identical to the same rows passed
   alone, an unaligned view to its aligned copy, and acc aliasing C
   through the C entry to the wrapper's result; SpDMM n1=4096, f=128,
   w in {8, 64, 512}, strided views as the executor passes them) and at
   the ragged sweep shapes of ``tests/test_kernels.py``, fp32 tolerance
   rtol 1e-5 / atol 1e-4 (SDDMM's unmasked sweep: rtol 1e-4 / atol 1e-4,
   the JAX sweep's).  SpDMM also with a live length per row (``row_len``:
   rows of length 0, 1, w - 1 and w, pads between live slots, f in {8,
   128, 200}, strided h), bit-identical to the full-width walk and to the
   same call with acc aliasing out.  Median times of kernel, plain
   version and the PyTorch library call, and the bound (bytes over 3.35
   TB/s or flops over 67 TFLOP/s fp32, the H100 SXM data-sheet peaks).
3. Engine.serve path: ``Engine(device="cuda").serve`` answers b1-b8 on
   Cora (CO) and three b2 (GCN, hidden 128) requests on full-scale Flickr
   (FL, 89,250 vertices, 989,006 edges with self loops), weights random
   from seed 0.  Every output is held against the port's plain torch
   reference (``run_reference``, index_add_ / scatter_reduce) in float64
   on the card at rtol 2e-4 / atol 2e-5; the FL repeats must be cache
   hits; the kernels' launch counts over the serve loop must be > 0 and
   equal the executor's GEMM and SUM/MEAN SpDMM tile ops.  One more FL
   request (a cache hit) under ``torch.profiler``: device time by kernel
   (each hand kernel's sum on a line of its own) and the device's busy
   share.  Then the SpDMM kernel timed again on the
   widest real ELL slice of the FL program with the executor's
   ``row_len`` (beside the full-width walk of the same slice), which is
   the kernel's entry in the ``kernels`` line.
4. Host-streaming and remap paths.  (a) b2@FL with ``residency="host"``
   on a fresh ``Engine(resident_budget_bytes=B)``, B halfway between the
   largest double-buffered shard window plus the weights (from the plan,
   before any run) and the device path's liveness-aware peak: a
   device-resident run is refused with advice to re-run with
   ``residency='host'``; ``compile(..., residency="host")`` and three runs
   (the first pins the graph's tiles in host memory), each bit-identical
   to phase 3's b2@FL#0 output and held to the float64 reference; the
   rise of ``max_memory_allocated`` stays under B; T_LoH, H2D bytes and
   rate, shards streamed, the peak staged window, per-layer wall time and
   H2D bytes; one hit under ``torch.profiler`` (busy share, and how long
   the H2D copies overlapped kernels); GEMM and SpDMM launches equal the
   executor's tile ops.  (b) b1, b3 and b6 on CO remapped with
   ``force="gemm"``, each run device-resident and host-streamed: equal
   bits, the float64 reference, ``tiles_remapped`` equal to the flipped
   steps, GEMM launches up (and SpDMM down) by exactly those steps, the
   densify kernel launched.  (c) b2@FL, one profiled hit, then
   ``Engine.remap`` with the default constants (the H100 data sheet) over its
   ``exec_profile`` densities and with ``probe=True`` (this card's
   kernels timed): decision counts, predicted gain, a device-resident
   hit's T_LoH and the float64 reference.  (d) The densify kernel on the
   widest real FL slice, bit-identical to its plain version, timed beside
   it and ``index_put_(accumulate=True)`` (its ``kernels`` entry), and the
   GEMM kernel at the remapped shape 4096x4096x128 (C = A.B and + acc),
   bit-identical on a copy of the densified block and to
   ``ACK.gemm_agg``, timed beside torch.matmul / torch.addmm.
5. Runtime path: ``ServeLoop(OverlayPool(engines=[<the Engine above>,
   Engine()]), max_batch=4)`` with a worker thread per overlay serves 11
   requests: gat-dot (a dot-product-attention GAT, hidden 64, 2 layers)
   and b2 on FL, gat-dot on CO, in batches of 4, 4 and 3
   (``Engine.submit_batch`` -> ``BinaryExecutor.run_batch``).  Checks:
   admission order, batch sizes, b2@FL hits on the overlay that compiled
   it, every output against the float64 reference, lane 0 of each batch
   bit-identical to the same request served alone, and launches of each
   kernel equal to lanes x the pass's tile ops of its mode.  One gat-dot
   FL hit under ``torch.profiler``, and the SDDMM kernel timed on the
   widest real ELL slice of the gat-dot FL program (with its real mask
   and an accumulator), the kernel's entry in the ``kernels`` line, and
   on a synthetic hub tile of the same shape (256 rows with all 512
   slots live, the rest 25); on both, masked slots equal acc and two runs
   are equal.
6. Sampled serving: ``SamplingService`` (``repro_torch.sampling``) over
   ``OverlayPool(2 overlays)``, ``PartitionConfig(n1=256, n2=32)`` (the
   full-mode geometry of ``benchmarks/bench_sample.py``), max_batch 8, gcn
   normalization, on the full-scale synthesized Flickr graph (89,250
   vertices, 899,756 drawn edges, features of width 500 from seed 3).
   ``warm`` compiles the programs of a disjoint stream of 384 requests;
   then 64 requests (1-16 targets each from seed 0, fanouts (25, 10),
   GraphSAGE's published two-hop sizes, b1 / b3 / b6 round-robin) are
   served as graph-as-data lanes of bucket programs.  Checks: every
   response within rtol 2e-4 / atol 2e-5 of a float64 ``run_reference``
   of its own sampled subgraph; at least 8 (each model's first two and
   largest bucket, and every response of the largest bucket) bit-identical
   to the unpadded subgraph served through ``Engine.submit``; the
   program-cache hit rate after warm-up >= 0.9; GEMM and SpDMM launches
   equal to the sum over batches of lanes x the bucket program's tile
   steps.  Printed: p50 / p99 latency, throughput, the bucket census, the
   mean batch size, ``graph_data`` H2D bytes per batch, the tile steps of
   each bucket program, and one profiled batch of 8 lanes.
7. Conformance (``repro_torch.obs``): ``build_report`` of b1-b8 on CO
   and b2@FL device-resident (per-layer CUDA-event times) and of b2@FL
   host-streamed under phase 4's budget (synchronized wall times, a
   traced and profiled hit), each program recompiled with
   ``use_cache=False`` so it carries its source: per-mode model error
   before and after calibration (calibrated <= uncalibrated checked), the
   fitted constants beside the card's name and power limit,
   ``fit_stage_bw`` (the stage spans' copy device time) within 15% of the
   copy-engine rate ``torch.profiler`` reads for the same hit, and the
   decisions of ``Engine.remap`` priced by the b2@FL report beside phase
   4's (data-sheet defaults, probe).
8. Live graphs (``repro_torch.livegraph``) with verification on: a
   ``GraphVersionStore`` of full-scale FL (n1=4096, n2=128, 22 blocks)
   served through ``OverlayPool(2 overlays, verify=True)``.  v0 is FL;
   v1 and v2 are content deltas of 32 removals of distinct existing pairs
   and 32 additions between existing vertices (seeds 1 and 2; a draw
   that would change the tile structure is drawn again); v3 adds 1,024
   vertices, each with one in- and one out-edge (23 blocks).  Each
   version's b2 first pass and two hits through ``Engine.submit``, held
   bit for bit to a cold compile of ``version.as_graph()`` on a second
   Engine and within rtol 2e-4 / atol 2e-5 of float64; v1 and v2 must be
   cache hits (no compile, T_LoC 0), v3 one miss; ``_Staged.uploaded`` of
   v1, v2 and v3 must equal the bytes of their patched tiles (from
   ``PatchStats.patched`` and the tiles' shapes) plus ``inv_in_degree``.
   b2 host-streamed on v0 and v1 under phase 4's budget logic, bit for
   bit to the device path, v1's pinned bytes equal to the shards that
   hold a patched tile, and ``verify.check_trace`` over a traced host hit
   of v1 (0 violations; its spans are host issue times, so it proves
   issue order only).  gat-dot on v1 (SDDMM over the version's edge ids,
   holes included), held the same way.  A cutover stream:
   ``ServeLoop(max_batch=4)``, 24 b2 requests on the live handle, cut
   over to v1 after the 8th admission and to v2 after the 16th; none
   dropped, each bit-identical to a solo serve of its pinned version,
   v0 and v1 reclaimed, and device memory falling by at least v1's
   copies no live version holds.  v3 compiled with ``GAGI_EXPORT_DIR``
   set, and ``python -m repro_torch.verify``'s ``main`` run over the
   exported bundle (exit 0).  Last, b1 on a live CO (n1=1024) remapped
   with ``force="gemm"`` and rebound after a delta that drains one tile
   and adds an edge to another: only those two tiles re-priced (the
   drained one skip), the binary changed only in their words, device and
   host runs equal, within the float64 tolerance (densify and GEMM
   kernels).  Every verification's time is printed.
9. LM serving path, qwen3-0.6b at full width (28 layers, d_model 1024, 16
   query / 8 KV heads of 128, vocab 151,936), weights random from
   ``torch.Generator`` seed 0 with the JAX initializers' scales:
   the flash kernel against its plain version (the sweep of
   ``tests/test_kernels.py`` in fp32 at atol 2e-5, its bf16 case at
   rtol / atol 3e-2, ragged causal Tq = Tk = 200, grouped KV heads with
   G = 2 and 8, and the path shape BH=64, T=2048, d=128 in fp32 and bf16
   with the prefill's 32 KV heads (G=2) and with one KV head per query
   head, timed beside the plain version and
   ``F.scaled_dot_product_attention(is_causal=True)`` (with
   ``enable_gqa=True`` for G=2 where torch takes it), a yardstick the
   port never calls; every bf16 case also within relative L2 2^-8 over
   the whole output and 2^-7 over each query row, ``check_rows``; at
   gemma3's head dims 168, 240 and 256 and under sliding windows 1, 5,
   64, 1024 and >= T, with ragged T, G in {1, 2} and windows that end
   inside a KV tile, in fp32 and bf16; at gemma3-12b's prefill shape,
   BH=64 over 32 KV heads, T=2048, d=240, bf16, without and with its
   window of 1024, timed beside the plain version and SDPA, which takes
   the window as a boolean ``attn_mask``);
   ``make_prefill_step`` in bf16 at B=4, T=2048 (a warm-up and 3 timed
   prefills, 28 flash launches each, last-position logits within
   relative L2 2e-2 of the same model run with plain attention, the
   reading of the same model with ``_sdpa_chunked`` attention beside it,
   one more prefill under ``torch.profiler``); fp32 decode
   against forward at B=2, T=64 (every position within 2e-4 of max
   |logit|, the JAX test's tolerance); and the serving loop
   ``repro_torch.launch.serve.main`` at its defaults (8 requests, prompt
   32, 16 generated tokens, bf16).

10. Mesh (``mesh=``, the placement-scheduled multi-device path) on
   virtual shards of the card, ``DeviceMesh([cuda:0] * D)``: b1-b8 on CO
   at D = 2, 3 and 4, each bit for bit the device path, launches equal to
   the pass's tile ops and per-device tile ops summing to the device
   path's; b2 and gat-dot on full-scale FL at D = 4 (a mesh miss, then
   four hits in turns with four device-path hits on the same shared
   tiles, which share the shards' copies): bit for bit,
   within rtol 2e-4 / atol 2e-5 of float64, ``halo_bytes`` equal to the
   manifest's ``halo_bytes_total``, with ``halo_gather_bytes``,
   ``device_imbalance``, per-device records, per-layer gather bytes and
   the hit times beside the device path's; ``run_batch`` of 3 b2@FL lanes
   on the mesh, each lane bit for bit its solo run; a traced b2@FL hit
   through ``verify.check_trace`` (0 violations) and ``build_report``'s
   halo section; b1 on CO remapped with ``force="gemm"`` at D = 2 (densify
   and GEMM on the mesh); a live CO (n1=1024) version after a content
   delta on D = 2, a cache hit bit for bit to a cold compile.  It prints
   how many times the distinct-card path ran (0 on a one-card machine;
   with more cards, b2@FL on ``make_device_mesh(min(4, count))``).
11. granite-8b at full width (36 layers, d_model 4096, 32 query / 8 KV
   heads of 128, d_ff 14336, vocab 49,152, an untied head; 8.25 B
   parameters, bf16, random from seed 0): the flash kernel at its prefill
   shape (BH=128 over 32 KV heads, G=4, T=2048, d=128, bf16, causal) by
   ``check_rows`` against its plain version, timed beside the plain
   version, SDPA and the bound; ``make_prefill_step`` at B=4, T=2048 (a
   warm-up and 2 timed, 36 flash launches each), last-position logits
   within relative L2 2e-2 of plain attention; fp32 decode against
   forward at full width and 4 layers (B=2, T=64, 2e-4 of max |logit|);
   ``launch.serve --arch granite-8b`` with 4 requests of 16 tokens.
12. gemma3 at full width (``repro_torch.configs``; random from seed 0):
   gemma3-12b's 48 layers (40 windowed of 1024 and 8 global, d_model
   3840, 16 query / 8 KV heads of 240, vocab 262,144; 11.62 B
   parameters, 21.65 GiB of bf16) prefilled at B=4, T=2048 (a warm-up
   and 2 timed, 48 flash launches each, one more under
   ``torch.profiler``), last-position logits within relative L2 2e-2 of
   plain attention; fp32 decode against forward at 6 layers (5 windowed,
   1 global) over T = 1,088, past the window, so every local layer's
   ring buffer of 1,024 slots wraps (2e-4 of max |logit|);
   ``launch.serve --arch gemma3-12b`` with 4 requests of 16 tokens;
   gemma3-27b (d = 168) at 8 layers, its 2-layer remainder segment and a
   superblock, prefilled at 4x2048 against plain attention.
13. The train step: qwen3-0.6b at full width in bf16 (596 M parameters;
   params, fp32 master, mu and nu on the card), B=2, T=4096: the loss and
   every gradient of ``steps.value_and_grad`` through the kernel route
   (the flash kernel's forward, the chunked plain recompute backward)
   against the plain route (autograd through ``flash_attention_plain``,
   checkpointed per layer) within relative L2 2e-2, and in fp32 at 2
   layers within 1e-4; 10 steps of ``make_train_step`` on
   ``synthetic_batches`` (synchronized step ms, tokens/s, peak memory,
   every loss finite, 28 flash launches a step), one under
   ``torch.profiler``; ``checkpoint.save`` / ``restore`` of the whole
   train state onto a fresh model on the card, bit for bit; and
   ``python -m repro_torch.launch.train`` at 2x4096, crashed after step
   4 (exit 42) and resumed from its own checkpoint of step 3 to step 5.

``launches`` in the ``kernels`` line is a kernel's count over the driven
paths (the Engine.serve path, the host and remap runs of phase 4, the
runtime path, the sampled stream, the reported runs of phase 7, the live
path's runs of phase 8 (cold-compile comparisons excluded), the prefill
and forward runs of phase 9, the mesh runs of phase 10 (device-path
comparisons excluded), the prefill and forward runs of phases 11 and
12, and the 10 train steps of phase 13),
each counted from zero just before the path runs and read just after.

Kernel times are device times: each trial queues a spin kernel first, so
the host enqueues 20 back-to-back calls while the device is busy, and a
CUDA event pair around them is divided by 20 (median of 5 trials).

The last lines are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``.  TF32 is off throughout
(``torch.backends.cuda.matmul.allow_tf32 = False``), so every fp32 product
here, the plain versions' included, is IEEE fp32.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12        # H100 SXM fp32, CUDA cores
PEAK_BF16_FLOP_S = 989e12       # H100 SXM bf16 tensor cores, dense
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
PATH_RTOL, PATH_ATOL = 2e-4, 2e-5

GEMM_SWEEP = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
              (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258)]
SPDMM_SWEEP = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
               (32, 64, 32, 8), (8, 8, 8, 8)]
# SpDMM with a live length per row: (n1, w, n_src, f).
SPDMM_ROW_LEN = [(64, 16, 50, 8), (100, 96, 70, 128), (128, 33, 100, 200),
                 (4096, 512, 4096, 128)]
SDDMM_SWEEP = [(128, 16, 128, 128), (64, 8, 96, 256), (56, 24, 70, 33),
               (8, 8, 8, 8)]
SDDMM_RTOL, SDDMM_ATOL = 1e-4, 1e-4
# tests/test_kernels.py's flash sweep: (tq, tk, heads, d, causal).
FLASH_SHAPES = [(128, 128, 2, 64, True), (256, 256, 4, 32, True),
                (128, 256, 1, 64, False), (256, 128, 2, 128, True)]
FLASH_ATOL = 2e-5                # the JAX sweep's fp32 tolerance
FLASH_BF16_TOL = 3e-2            # its bf16 case's rtol and atol
# bf16 flash outputs are also held at limits scaled to bf16 rounding (unit
# roundoff u = 2^-8): relative L2 over the whole output <= u and over each
# query row <= 2u.  Both sides round the output to bf16 (each within
# half an ulp) and the kernel also rounds P to bf16 for the tensor cores,
# so a right kernel reads about u/2 whole; a dropped KV tile or a 1%
# error in the score scale reads several u.
BF16_U = 2.0 ** -8
FLASH_BF16_WHOLE, FLASH_BF16_ROW = BF16_U, 2 * BF16_U
LM_ARCH, LM_B, LM_T = "qwen3-0.6b", 4, 2048
LM_REL_L2 = 2e-2                 # bf16 prefill against plain attention
DECODE_B, DECODE_T, DECODE_TOL = 2, 64, 2e-4
# Kernel names of the hand kernels, as the profiler reports them.
HAND_KERNELS = ("gemm_f32_kernel", "spdmm_f32_kernel", "sddmm_f32_kernel",
                "flash_", "ell_densify_kernel")


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(nbytes: float, flops: float, peak_flop_s=PEAK_FP32_FLOP_S):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = flops / peak_flop_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def median_ms(torch, fn, reps: int = 5, launches: int = 20) -> float:
    """Device time of one ``fn()`` call: the median over ``reps`` trials of
    (event pair around ``launches`` back-to-back calls) / ``launches``.
    Each trial first queues a ~10 ms spin kernel, so the host enqueues
    the calls while the device is busy and the pair times the device
    work, not the host's launch path."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        per.append(a.elapsed_time(b) / launches)
    return statistics.median(per)


def check_close(torch, name, got, want, rtol, atol) -> float:
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    if bool((err > lim).any()):
        fail(f"{name}: max |err| {float(err.max()):.3e} exceeds "
             f"atol {atol} + rtol {rtol} * |want|")
    return float(err.max()) if err.numel() else 0.0


def rows_rel(got, want):
    """(relative L2 of ``got - want`` over the whole output, the largest
    over one row (the last dim)); inf where ``got`` is not finite."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return float("inf"), float("inf")
    err = got - want
    return (float(err.norm() / want.norm()),
            float((err.norm(dim=-1)
                   / want.norm(dim=-1).clamp_min(1e-30)).max()))


def check_rows(torch, name, got, want, whole=FLASH_BF16_WHOLE,
               row=FLASH_BF16_ROW):
    """``rows_rel`` within ``whole`` and ``row``, else fail.  Unlike an
    elementwise atol, the limit follows the rows' own scale, which in
    causal attention falls with the row's position.  Returns (whole,
    worst row)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    r_whole, r_row = rows_rel(got, want)
    if not (r_whole <= whole and r_row <= row):
        fail(f"{name}: relative L2 {r_whole:.3e} whole (limit {whole:.3e}),"
             f" {r_row:.3e} worst row (limit {row:.3e})")
    return r_whole, r_row


# --------------------------------------------------------------------------- #
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def kernel_phase(torch, ops, ref):
    """Hold both kernels against their plain versions; returns the GEMM
    entry of the kernels line (its path shape)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    # Ragged sweep shapes (correctness only).
    for m, k, n in GEMM_SWEEP:
        x, w, acc = randn(m, k), randn(k, n), randn(m, n)
        check_close(torch, f"gemm {m}x{k}x{n}", ops.gemm(x, w, acc),
                    acc + ref.gemm_ref(x, w), KERNEL_RTOL, KERNEL_ATOL)
    for n1, w, ns, f in SPDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        vals = randn(n1, w) * (torch.rand(n1, w, generator=gen,
                                          device="cuda") > 0.4)
        h = randn(ns, f)
        check_close(torch, f"spdmm {n1}x{w} ns={ns} f={f}",
                    ops.spdmm(cols, vals, h), ref.spdmm_ref(cols, vals, h),
                    KERNEL_RTOL, KERNEL_ATOL)
    spdmm_row_len_cases(torch, ops, ref, gen)
    zero = ops.spdmm(torch.zeros(16, 8, dtype=torch.int32, device="cuda"),
                     torch.zeros(16, 8, device="cuda"), randn(16, 16))
    torch.cuda.synchronize()
    if float(zero.abs().max()) != 0.0:
        fail("spdmm: zero padding is not inert")
    for n1, w, ns, f in SDDMM_SWEEP:
        cols = torch.randint(0, ns, (n1, w), generator=gen, device="cuda",
                             dtype=torch.int32)
        hd, hs = randn(n1, 2 * f)[:, f:], randn(ns, f)
        check_close(torch, f"sddmm {n1}x{w} ns={ns} f={f}",
                    ops.sddmm(hd, hs, cols), ref.sddmm_ref(hd, hs, cols),
                    SDDMM_RTOL, SDDMM_ATOL)
    log("kernels: ragged sweeps within tolerance "
        f"({len(GEMM_SWEEP)} gemm, {len(SPDMM_SWEEP)} + "
        f"{len(SPDMM_ROW_LEN)} spdmm, {len(SDDMM_SWEEP)} sddmm shapes)")

    # GEMM at the executor's tile shape: a [4096, 128] sub-fiber view of a
    # padded [4096, 512] layer tensor times a [128, 128] weight block view,
    # in both forms the executor issues: the first K step of an output
    # tile (C = A.B, the kernels-line entry, against torch.matmul) and the
    # later ones (C = acc + A.B, against torch.addmm); then the narrower
    # widths N = 64 and 8 (the n2 that choose_partition picks for feature
    # widths under 128; the paths driven here all have n2 = 128).
    m, k = 4096, 128
    gemm_entry = None
    for n in (128, 64, 8):
        h_full, w_full = randn(m, 4 * k), randn(4 * k, 2 * n)
        x, w = h_full[:, k:2 * k], w_full[k:2 * k, n:2 * n]
        acc = randn(m, n)
        for with_acc in (False, True):
            a = acc if with_acc else None
            want = ref.gemm_ref(x, w) + (acc if with_acc else 0.0)
            err = check_close(torch, f"gemm path shape N={n}",
                              ops.gemm(x, w, a), want, KERNEL_RTOL,
                              KERNEL_ATOL)
            t_k = median_ms(torch, lambda: ops.gemm(x, w, a))
            if with_acc:
                t_p = median_ms(torch, lambda: acc + ref.gemm_ref(x, w))
                t_l = median_ms(torch, lambda: torch.addmm(acc, x, w))
                lib = "torch.addmm"
            else:
                t_p = median_ms(torch, lambda: ref.gemm_ref(x, w))
                t_l = median_ms(torch, lambda: torch.matmul(x, w))
                lib = "torch.matmul"
            nbytes = 4 * (m * k + k * n + (2 if with_acc else 1) * m * n)
            b_ms, b_by = bound_ms(nbytes, 2.0 * m * n * k)
            log(f"kernel gemm {m}x{k}x{n} (strided views"
                f"{', +acc' if with_acc else ''}): kernel {t_k:.4f} ms, "
                f"plain {t_p:.4f} ms, {lib} {t_l:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")
            if gemm_entry is None:
                gemm_entry = {
                    "name": "gemm", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/gemm.cu",
                    "replaces": "src/repro/kernels/gemm.py:38",
                    "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l}
    gemm_bits_cases(torch, ops, randn)

    # SpDMM at the executor's tile shape, synthetic ELL tiles of width w
    # (60% of slots carry an edge, the rest are pad slots: cols 0, vals 0).
    n1, f = 4096, 128
    h_full = randn(n1, 4 * f)
    h = h_full[:, f:2 * f]
    for w in (8, 64, 512):
        live = torch.rand(n1, w, generator=gen, device="cuda") > 0.4
        cols = torch.where(live, torch.randint(0, n1, (n1, w), generator=gen,
                                               device="cuda"),
                           0).to(torch.int32).contiguous()
        vals = torch.where(live, randn(n1, w), 0.0).contiguous()
        acc = randn(n1, f)
        err = check_close(torch, f"spdmm path shape w={w}",
                          ops.spdmm(cols, vals, h, acc),
                          acc + ref.spdmm_ref(cols, vals, h),
                          KERNEL_RTOL, KERNEL_ATOL)
        sp, hc = _ell_to_csr(torch, cols, vals, live, n1), h.contiguous()
        t_k = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc))
        t_p = median_ms(torch, lambda: acc + ref.spdmm_ref(cols, vals, h))
        t_l = median_ms(torch, lambda: torch.sparse.mm(sp, hc))
        b_ms, b_by = _spdmm_bound(n1, w, n1, f, int(live.sum()))
        log(f"kernel spdmm n1={n1} w={w} f={f} (strided h, +acc): "
            f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, torch.sparse.mm "
            f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"max|err| {err:.2e}")
    return gemm_entry


def gemm_bits_cases(torch, ops, randn):
    """GEMM results that must be bit-identical: rows [r0, r1) of a call
    against the same rows passed alone (r0 unaligned to any tile), an
    unaligned view (4-byte staging) against its aligned copy (16-byte
    staging), and acc aliasing C through the C entry point (the wrapper
    always allocates C), on the path shape and a ragged one."""
    for m, k, n, r0, r1 in ((4096, 128, 128, 37, 1001),
                            (130, 70, 258, 3, 129)):
        xf, w, acc = randn(m, k + 1), randn(k, n), randn(m, n)
        x = xf[:, 1:]                      # 4-byte aligned only
        xa = x.contiguous()
        name = f"gemm {m}x{k}x{n}"
        full = ops.gemm(xa, w, acc)
        if not torch.equal(full[r0:r1], ops.gemm(xa[r0:r1], w,
                                                 acc[r0:r1])):
            fail(f"{name}: rows [{r0}, {r1}) differ from the same rows of "
                 "the whole call")
        if not torch.equal(full, ops.gemm(x, w, acc)):
            fail(f"{name}: the unaligned view differs from its aligned copy")
        inout = acc.clone()
        rc = ops.entry("gemm")(
            xa.data_ptr(), w.data_ptr(), inout.data_ptr(), inout.data_ptr(),
            m, n, k, ops._ld(xa), ops._ld(w), ops._ld(inout),
            ops._ld(inout), ops._stream(xa))
        torch.cuda.synchronize()
        if rc != 0 or not torch.equal(inout, full):
            fail(f"{name}: acc aliasing C differs (rc {rc})")
    log("gemm: row slices, unaligned views and acc aliasing C bit-identical")


def spdmm_row_len_cases(torch, ops, ref, gen):
    """SpDMM with a live length per row: rows of length 0, 1, w - 1, w and
    random, pads between live slots (vals 0) and after the last; strided
    h, an accumulator, f in {8, 128, 200}.  Each is held against the plain
    version, is bit-identical to the walk over all w slots, and to the
    same call with acc aliasing out (through the C entry point, as the
    wrapper always allocates out)."""
    for n1, w, ns, f in SPDMM_ROW_LEN:
        lens = torch.randint(0, w + 1, (n1,), generator=gen, device="cuda")
        lens[:4] = torch.tensor([0, 1, w - 1, w], device="cuda")
        slot = torch.arange(w, device="cuda")
        live = (slot[None] < lens[:, None]) & (
            torch.rand(n1, w, generator=gen, device="cuda") > 0.3)
        live[torch.arange(n1, device="cuda"), (lens - 1).clamp_min(0)] |= \
            lens > 0
        cols = torch.where(live, torch.randint(
            0, ns, (n1, w), generator=gen, device="cuda"), 0).to(
            torch.int32).contiguous()
        vals = torch.where(live, torch.randn(n1, w, generator=gen,
                                             device="cuda"), 0.0)
        row_len = (live * (slot + 1)).amax(1).to(torch.int32).contiguous()
        if row_len[:4].tolist() != [0, 1, w - 1, w]:
            fail(f"spdmm row_len case {n1}x{w}: lengths "
                 f"{row_len[:4].tolist()}")
        h = torch.randn(ns, 2 * f + 4, generator=gen, device="cuda"
                        )[:, 4:4 + f]
        acc = torch.randn(n1, f, generator=gen, device="cuda")
        name = f"spdmm row_len {n1}x{w} ns={ns} f={f}"
        got = ops.spdmm(cols, vals, h, acc, row_len)
        check_close(torch, name, got, acc + ref.spdmm_ref(cols, vals, h),
                    KERNEL_RTOL, KERNEL_ATOL)
        if not torch.equal(got, ops.spdmm(cols, vals, h, acc)):
            fail(f"{name}: not bit-identical to the full-width walk")
        inout = acc.clone()
        rc = ops.entry("spdmm")(
            cols.data_ptr(), vals.data_ptr(), h.data_ptr(), inout.data_ptr(),
            inout.data_ptr(), row_len.data_ptr(), n1, w, f, ops._ld(h),
            ops._ld(inout), ops._ld(inout), ops._stream(h))
        torch.cuda.synchronize()
        if rc != 0 or not torch.equal(inout, got):
            fail(f"{name}: acc aliasing out differs (rc {rc})")


def _ell_to_csr(torch, cols, vals, live, n_src):
    """The true edges of an ELL tile as a CSR matrix [n1, n_src]
    (duplicate columns summed), for the library yardstick."""
    rows, slots = torch.nonzero(live, as_tuple=True)
    idx = torch.stack([rows, cols[rows, slots].long()])
    coo = torch.sparse_coo_tensor(idx, vals[rows, slots],
                                  (cols.shape[0], n_src)).coalesce()
    return coo.to_sparse_csr()


def _spdmm_bound(n1, w, n_src, f, nnz, walked=None):
    """Bytes: the cols + vals of the slots walked (``walked``; all n1 w
    when None, the full-width walk), row_len [n1] when given, h
    [n_src, f], acc + out [n1, f], each once; operations: 2 flops per
    true edge and feature (pad slots are work the data does not need)."""
    slot_bytes = 8 * n1 * w if walked is None else 8 * walked + 4 * n1
    nbytes = slot_bytes + 4 * (n_src * f + 2 * n1 * f)
    return bound_ms(nbytes, 2.0 * nnz * f)


# --------------------------------------------------------------------------- #
def path_phase(torch):
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS
    from repro_torch.core.ir import AggOp, LayerType
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    co = G.synthesize("CO").gcn_normalized()
    fl = G.synthesize("FL").gcn_normalized()
    log(f"graphs: CO |V|={co.n_vertices} |E|={co.n_edges} f={co.feat_dim}; "
        f"FL |V|={fl.n_vertices} |E|={fl.n_edges} f={fl.feat_dim} "
        f"({time.perf_counter() - t0:.2f} s)")
    reqs = [InferenceRequest(model=name, graph=co,
                             features=G.random_features(co, seed=1),
                             request_id=f"{name}@CO")
            for name in BENCHMARKS]
    reqs += [InferenceRequest(model="b2", graph=fl,
                              features=G.random_features(fl, seed=10 + i),
                              request_id=f"b2@FL#{i}")
             for i in range(3)]

    engine = Engine()                      # device="cuda", default geometry
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    exp = {"gemm": 0, "spdmm": 0, "spdmm_sum_mean": 0}
    responses, layer_times = [], []
    # ---- the main path: counts are zeroed just above, read just below.
    for req in reqs:
        resp = engine.serve([req])[0]
        st = engine.exec_stats
        modes = st.tile_ops_by_mode or {}
        exp["gemm"] += modes.get("gemm", 0)
        exp["spdmm"] += modes.get("spdmm", 0)
        prog = engine.cache.get(resp.cache_key)
        for lp in prog.plan().layers:
            if lp.layer_type == LayerType.AGGREGATE and AggOp(lp.mode) in (
                    AggOp.SUM, AggOp.MEAN):
                exp["spdmm_sum_mean"] += sum(len(tp.compute)
                                             for tp in lp.tiles)
        responses.append(resp)
        layer_times.append([(r["layer"], r["kernel"], r["tile_ops"],
                             r["wall_s"] * 1e3) for r in st.per_layer])
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path.

    for req, resp, lt in zip(reqs, responses, layer_times):
        log(f"request {resp.request_id}: model {resp.model_name}, "
            f"T_LoC {resp.t_loc * 1e3:.2f} ms, T_LoH {resp.t_loh * 1e3:.2f} "
            f"ms, cache_hit {resp.cache_hit}")
        log("  per-layer CUDA-event ms: " + ", ".join(
            f"L{lid}:{k}x{n}={ms:.3f}" for lid, k, n, ms in lt))
    log(f"serve: {engine.stats.requests} requests, "
        f"{engine.stats.cache_hits} cache hits, {engine.stats.compiles} "
        f"compiles; max_memory_allocated {peak / 2**30:.3f} GiB")
    log(f"launches on the main path: gemm {launches['gemm']}, spdmm "
        f"{launches['spdmm']}; executor tile ops: gemm {exp['gemm']}, "
        f"spdmm {exp['spdmm']} (SUM/MEAN {exp['spdmm_sum_mean']})")
    hits = [r.t_loh * 1e3 for r in responses[-3:] if r.cache_hit]
    log("b2@FL cache hits: T_LoH " + ", ".join(f"{ms:.2f}" for ms in hits)
        + " ms")
    if [r.cache_hit for r in responses[-3:]] != [False, True, True]:
        fail("FL requests: expected one cache miss then two hits, got "
             f"{[r.cache_hit for r in responses[-3:]]}")
    if not (launches["gemm"] > 0 and launches["spdmm"] > 0):
        fail(f"a kernel was not launched on the main path: {launches}")
    if launches["gemm"] != exp["gemm"]:
        fail(f"gemm launches {launches['gemm']} != tile ops {exp['gemm']}")
    if not (launches["spdmm"] == exp["spdmm_sum_mean"] == exp["spdmm"]):
        fail(f"spdmm launches {launches['spdmm']} != SUM/MEAN tile ops "
             f"{exp['spdmm_sum_mean']} / all {exp['spdmm']}")

    worst = hold_against_reference(torch, reqs, responses)
    log(f"path: {len(responses)} outputs within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of run_reference in float64 (worst max|err| "
        f"{worst:.3e})")
    profile_call(torch, lambda: engine.serve([reqs[-1]]), "b2@FL hit")
    fl_prog = engine.cache.get(responses[-1].cache_key)
    return launches, fl_prog, responses, peak, engine, co, fl


def hold_against_reference(torch, reqs, responses) -> float:
    """Every output against the port's plain reference on the card, run
    in float64 so that the reference's own rounding does not count; the
    fp32 reference's distance is printed beside it for comparison.
    Returns the worst max|err|; fails past rtol 2e-4 / atol 2e-5."""
    from repro_torch.core.gnn_builders import build
    from repro_torch.core.reference import run_reference
    worst, bad = 0.0, []
    for req, resp in zip(reqs, responses):
        g = req.graph
        model = build(req.model, g, req.seed) if isinstance(
            req.model, str) else req.model
        x = torch.as_tensor(req.features, device="cuda")
        y64 = run_reference(model, g, x, dtype=torch.float64)
        y32 = run_reference(model, g, x)
        got = resp.output.double()
        if tuple(got.shape) != (g.n_vertices, g.n_classes) or not bool(
                torch.isfinite(got).all()):
            fail(f"{resp.request_id}: output shape {tuple(got.shape)} "
                 "or non-finite values")
        err = (got - y64).abs()
        over = err > PATH_ATOL + PATH_RTOL * y64.abs()
        r = int(err.max(dim=1).values.argmax())
        indeg = int((torch.as_tensor(g.dst, device="cuda") == r).sum())
        err32 = float((y32.double() - y64).abs().max())
        log(f"  {resp.request_id}: shape {tuple(got.shape)}, max|y - "
            f"ref64| {float(err.max()):.3e} at row {r} (in-degree {indeg},"
            f" |ref64| {float(y64[r].abs().max()):.3e}), {int(over.sum())}"
            f" entries over tolerance; fp32 reference: max|ref32 - ref64| "
            f"{err32:.3e}, max|y - ref32| "
            f"{float((got - y32.double()).abs().max()):.3e}")
        worst = max(worst, float(err.max()))
        if bool(over.any()):
            bad.append(resp.request_id)
    if bad:
        fail(f"outputs outside rtol {PATH_RTOL} / atol {PATH_ATOL} of the "
             f"float64 reference: {bad}")
    return worst


def _busy_us(ivs) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_call(torch, fn, label: str, split=None, out=None):
    """``fn()`` under torch.profiler: device time by kernel name (with
    each kernel's launches and their median and longest duration) and the
    device's busy share of the call's wall time; returns the device ms by
    kernel name.  When the profiler yields no device events it says "not
    measured" (and returns None); a profiler that raises fails the run.
    With ``split`` (a substring of event names, e.g. "HtoD") it also
    reports the busy time of the matching events, of the others, and how
    long the two overlapped, into the dict ``out`` when one is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log(f"profile {label}: no device events; device busy share not "
            "measured")
        return None
    by_name, ivs = {}, []
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
        ivs.append((e.time_range.start, e.time_range.end))
    busy = _busy_us(ivs)
    log(f"profile {label}: wall {wall_us / 1e3:.2f} ms under the "
        f"profiler, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), {len(kern)} device events")
    if split is not None:
        mine = [(e.time_range.start, e.time_range.end) for e in kern
                if split in e.name]
        rest = [(e.time_range.start, e.time_range.end) for e in kern
                if split not in e.name]
        a, b = _busy_us(mine), _busy_us(rest)
        both = a + b - busy
        log(f"  {split} events busy {a / 1e3:.2f} ms ({len(mine)} events), "
            f"the rest {b / 1e3:.2f} ms, both at once {both / 1e3:.2f} ms "
            f"({100 * both / max(min(a, b), 1e-9):.1f}% of the shorter)")
        if out is not None:
            out.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                       busy_share=busy / wall_us, split_ms=a / 1e3,
                       rest_ms=b / 1e3, overlap_ms=both / 1e3)
    total = {name: sum(us) for name, us in by_name.items()}
    hand = []
    for kern in HAND_KERNELS:
        runs = [u for name, us in by_name.items() if kern in name
                for u in us]
        if runs:
            hand.append(f"{kern} {sum(runs) / 1e3:.3f} ms x {len(runs)}")
    log("  hand kernels: " + (", ".join(hand) or "none"))
    for name, us in sorted(total.items(), key=lambda kv: -kv[1])[:10]:
        each = by_name[name]
        log(f"  {us / 1e3:9.3f} ms  {len(each):5d} x (median "
            f"{statistics.median(each):8.2f} us, max {max(each):8.2f} us)  "
            f"{name[:70]}")
    return {name: us / 1e3 for name, us in total.items()}


def fl_spdmm_entry(torch, ops, ref, prog):
    """The SpDMM kernel on the widest real ELL slice of the FL program,
    with the source view and the live lengths the executor passes it
    (timed beside the full-width walk of the same slice)."""
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, vals_d = st.tiles("cols"), st.tiles("vals")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, vals = cols_d[key], vals_d[key]
    row_len = st.tiles("row_len")[key]
    n1, w = cols.shape
    f = pg.config.n2
    nnz = pg.tiles[key[:2]][key[2]].nnz
    walked = int(row_len.sum())
    gen = torch.Generator(device="cuda").manual_seed(1)
    h_full = torch.randn(pg.n_blocks * n1, 4 * f, generator=gen,
                         device="cuda")
    k = key[1]
    h = h_full[k * n1:(k + 1) * n1, f:2 * f]
    acc = torch.randn(n1, f, generator=gen, device="cuda")
    got = ops.spdmm(cols, vals, h, acc, row_len)
    err = check_close(torch, "spdmm FL tile", got,
                      acc + ref.spdmm_ref(cols, vals, h), KERNEL_RTOL,
                      KERNEL_ATOL)
    if not torch.equal(got, ops.spdmm(cols, vals, h, acc)):
        fail("spdmm FL tile: row_len walk not bit-identical to the "
             "full-width walk")
    live = vals != 0
    sp, hc = _ell_to_csr(torch, cols, vals, live, n1), h.contiguous()
    t_k = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc, row_len))
    t_full = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc))
    t_p = median_ms(torch, lambda: acc + ref.spdmm_ref(cols, vals, h))
    t_l = median_ms(torch, lambda: torch.sparse.mm(sp, hc))
    b_ms, b_by = _spdmm_bound(n1, w, n1, f, nnz, walked)
    b_pad, b_pad_by = _spdmm_bound(n1, w, n1, f, nnz)
    slots = sum(t.cols.size for ts in pg.tiles.values() for t in ts)
    log(f"FL program: {sum(len(ts) for ts in pg.tiles.values())} ELL "
        f"slices, {slots} padded slots for {pg.total_nnz()} edges "
        f"({slots / max(pg.total_nnz(), 1):.1f}x)")
    log(f"kernel spdmm on FL slice (j,k,s)={key} n1={n1} w={w} f={f} "
        f"nnz={nnz}, {walked} slots walked (sum of row_len): kernel "
        f"{t_k:.4f} ms (full-width walk {t_full:.4f} ms), plain "
        f"{t_p:.4f} ms, torch.sparse.mm {t_l:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; the padded slots' bound {b_pad:.4f} ms, {b_pad_by}), "
        f"L2 gather volume {walked * 4 * f / 1e6:.1f} MB, max|err| "
        f"{err:.2e}")
    return {"name": "spdmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spdmm.cu",
            "replaces": "src/repro/kernels/spdmm.py:44",
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l,
            "full_walk_ms": t_full, "padded_bound_ms": b_pad}


# --------------------------------------------------------------------------- #
def _resp(rid, y):
    """A response-like record for ``hold_against_reference``."""
    import types
    return types.SimpleNamespace(request_id=rid, output=y)


def host_phase(torch, engine, fl, fl_prog, fl_out):
    """b2@FL host-streamed (``residency="host"``) on a fresh Engine whose
    budget refuses the device path; see the module docstring."""
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.engine import ResidentBudgetError
    from repro_torch.engine.executor import _host_tiles
    from repro_torch.core import graph as G
    from repro_torch.kernels import ops

    x = G.random_features(fl, seed=10)
    ex = engine.executor
    window = ex.estimate_host_window_bytes(fl_prog, x.shape[1])
    weights = sum(int(w.nbytes) for w in fl_prog.weights.values())
    dev_peak = ex.estimate_device_peak_bytes(fl_prog, x.shape[1])
    if not window + weights < dev_peak:
        fail(f"host window {window} + weights {weights} is not below the "
             f"device peak {dev_peak}")
    budget = (window + weights + dev_peak) // 2
    log(f"host path b2@FL: largest double-buffered window {window} B + "
        f"weights {weights} B = {window + weights} B; device path's "
        f"liveness-aware peak {dev_peak} B; resident_budget_bytes "
        f"{budget} B")

    heng = Engine(resident_budget_bytes=budget)
    t0 = time.perf_counter()
    prog = heng.compile("b2", fl, residency="host")
    t_loc = time.perf_counter() - t0
    try:
        heng.run(prog, x, residency="device")
    except ResidentBudgetError as e:
        msg = str(e)
    else:
        fail("a device-resident b2@FL run under the budget was not refused")
    if "residency='host'" not in msg:
        fail(f"the refusal does not name residency='host': {msg}")
    log(f"device-resident run refused: {msg}")

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    exp = {"gemm": 0, "spdmm": 0}
    runs = []
    # ---- the host path: counts are zeroed just above, read just below.
    for i in range(3):
        if i:
            t0 = time.perf_counter()
            prog = heng.compile("b2", fl, residency="host")
            t_loc = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = heng.run(prog, x)
        heng._sync()
        t_loh = time.perf_counter() - t0
        st = heng.exec_stats
        modes = st.tile_ops_by_mode or {}
        for k in exp:
            exp[k] += modes.get(k, 0)
        runs.append({"t_loc_s": t_loc, "t_loh_s": t_loh,
                     "h2d_bytes": st.h2d_bytes,
                     "shards_streamed": st.shards_streamed,
                     "peak_stage_bytes": st.peak_stage_bytes,
                     "layers": [(r["layer"], r["kernel"], r["tile_ops"],
                                 r["wall_s"], r["h2d_bytes"])
                                for r in st.per_layer],
                     "y": y})
    launches = dict(ops.LAUNCHES)
    rise = torch.cuda.max_memory_allocated() - base
    # ---- end of the host path.

    ht = _host_tiles(prog.pgraph, True)
    log(f"host tiles pinned once for the graph: {ht.nbytes} B "
        f"({ht.nbytes / 2**30:.3f} GiB) of host buffers")
    for i, r in enumerate(runs):
        log(f"host b2@FL#{i} ({'miss, pins the tiles' if i == 0 else 'hit'})"
            f": T_LoC {r['t_loc_s'] * 1e3:.2f} ms, T_LoH "
            f"{r['t_loh_s'] * 1e3:.2f} ms, h2d_bytes {r['h2d_bytes']}, "
            f"{r['h2d_bytes'] / r['t_loh_s'] / 1e9:.2f} GB/s over T_LoH, "
            f"shards_streamed {r['shards_streamed']}, peak_stage_bytes "
            f"{r['peak_stage_bytes']}")
        log("  per layer (host wall ms around the synchronized layer, H2D "
            "MB, GB/s): " + ", ".join(
                f"L{lid}:{k}x{n}={s * 1e3:.2f} ms/{b / 1e6:.1f} MB/"
                f"{b / max(s, 1e-9) / 1e9:.2f}"
                for lid, k, n, s, b in r["layers"]))
        if not torch.equal(r["y"], fl_out):
            fail(f"host b2@FL#{i} differs from the device path's b2@FL#0 "
                 f"by {float((r['y'] - fl_out).abs().max()):.3e}")
    if runs[0]["peak_stage_bytes"] != window:
        fail(f"peak_stage_bytes {runs[0]['peak_stage_bytes']} != the "
             f"plan's window {window}")
    log(f"host path: max_memory_allocated rose {rise} B "
        f"({rise / 2**30:.3f} GiB) over the three runs (budget {budget} B)")
    if rise > budget:
        fail(f"device memory rose {rise} B over the budget {budget} B")
    log(f"launches on the host path: gemm {launches['gemm']}, spdmm "
        f"{launches['spdmm']}; executor tile ops: {exp}")
    for k in exp:
        if not (launches[k] == exp[k] > 0):
            fail(f"host path {k} launches {launches[k]} != tile ops "
                 f"{exp[k]}")
    req = InferenceRequest(model="b2", graph=fl, features=x)
    worst = hold_against_reference(
        torch, [req] * 3, [_resp(f"host b2@FL#{i}", r["y"])
                           for i, r in enumerate(runs)])
    log(f"host path: 3 outputs bit-identical to the device path's and "
        f"within rtol {PATH_RTOL} / atol {PATH_ATOL} of the float64 "
        f"reference (worst max|err| {worst:.3e})")
    prof = {}
    profile_call(torch, lambda: (heng.run(prog, x), heng._sync()),
                 "b2@FL host hit", split="HtoD", out=prof)
    summary = {"budget": budget, "window": window, "weights": weights,
               "device_peak_estimate": dev_peak, "memory_rise": rise,
               "host_tile_bytes": ht.nbytes, "launches": launches,
               "profile": prof,
               "runs": [{k: v for k, v in r.items() if k != "y"}
                        for r in runs]}
    return launches, heng, x, summary


def remap_co_phase(torch, co):
    """b1, b3 and b6 on CO remapped with force="gemm", run device-resident
    and host-streamed: equal bits, the float64 reference, tiles_remapped
    and GEMM launches up by exactly the flipped steps."""
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    eng = Engine()
    total = {k: 0 for k in ops.LAUNCHES}
    out = []
    for name in ("b1", "b3", "b6"):
        x = G.random_features(co, seed=1)
        prog = eng.compile(name, co)
        ops.reset_launches()
        eng.run(prog, x)                    # the canonical binary
        canon = dict(ops.LAUNCHES)
        rp = eng.remap(prog, force="gemm")
        rec = rp.manifest["remap"]
        flipped = rec["remapped_ops"]
        ys = {}
        for residency in ("device", "host"):
            ops.reset_launches()
            # ---- a remapped run: counts zeroed above, read below.
            t0 = time.perf_counter()
            ys[residency] = eng.run(rp, x, residency=residency)
            eng._sync()
            t = time.perf_counter() - t0
            got = dict(ops.LAUNCHES)
            # ----
            for k in total:
                total[k] += got[k]
            st = eng.exec_stats
            log(f"remap {name}@CO force=gemm {residency}: {flipped} steps "
                f"flipped ({rec['counts']}), tiles_remapped "
                f"{st.tiles_remapped}, launches gemm {got['gemm']} (canonical"
                f" {canon['gemm']}), spdmm {got['spdmm']} (canonical "
                f"{canon['spdmm']}), densify {got['densify']}; T_LoH "
                f"{t * 1e3:.2f} ms")
            if not (st.tiles_remapped == flipped > 0):
                fail(f"{name}@CO: tiles_remapped {st.tiles_remapped} != "
                     f"flipped steps {flipped}")
            if got["gemm"] != canon["gemm"] + flipped or \
                    got["spdmm"] != canon["spdmm"] - flipped:
                fail(f"{name}@CO {residency}: GEMM launches {got['gemm']} "
                     f"!= {canon['gemm']} + {flipped} or SpDMM "
                     f"{got['spdmm']} != {canon['spdmm']} - {flipped}")
            if got["densify"] < 1:
                fail(f"{name}@CO {residency}: the densify kernel was not "
                     "launched")
        if not torch.equal(ys["device"], ys["host"]):
            fail(f"{name}@CO forced gemm: host differs from device by "
                 f"{float((ys['device'] - ys['host']).abs().max()):.3e}")
        req = InferenceRequest(model=name, graph=co, features=x)
        worst = hold_against_reference(
            torch, [req], [_resp(f"{name}@CO gemm", ys["device"])])
        out.append({"model": name, "flipped": flipped,
                    "counts": rec["counts"], "worst_err": worst})
    log("remap CO: forced-GEMM outputs bit-identical across residencies and "
        f"within rtol {PATH_RTOL} / atol {PATH_ATOL} of the reference")
    return total, out


def remap_fl_phase(torch, heng, fl, x):
    """b2@FL: one profiled hit, then remap priced by the default constants
    (the H100 data sheet) over the exec_profile densities and by probing
    this card's kernels; each run once device-resident (its T_LoH
    printed)."""
    from repro_torch.engine import InferenceRequest
    from repro_torch.kernels import ops
    heng.executor.resident_budget_bytes = None    # device-resident hits
    prog = heng.compile("b2", fl)
    heng.executor.profile_tiles = True
    heng.run(prog, x)
    heng._sync()
    heng.executor.profile_tiles = False
    t0 = time.perf_counter()
    heng.run(prog, x)
    heng._sync()
    t_canon = time.perf_counter() - t0
    log(f"remap FL: canonical b2@FL device-resident hit T_LoH "
        f"{t_canon * 1e3:.2f} ms; exec_profile kernel modes "
        f"{prog.manifest['exec_profile']['kernel_modes']}")
    total = {k: 0 for k in ops.LAUNCHES}
    out = {"canonical_t_loh_s": t_canon}
    req = InferenceRequest(model="b2", graph=fl, features=x)
    for label, kw in (("h100-default", {"source": "exec_profile"}),
                      ("probe", {"probe": True})):
        t0 = time.perf_counter()
        rp = heng.remap(prog, **kw)
        t_remap = time.perf_counter() - t0
        rec = rp.manifest["remap"]
        ops.reset_launches()
        # ---- a remapped run: counts zeroed above, read below.
        t0 = time.perf_counter()
        y = heng.run(rp, x)
        heng._sync()
        t = time.perf_counter() - t0
        got = dict(ops.LAUNCHES)
        # ----
        for k in total:
            total[k] += got[k]
        st = heng.exec_stats
        log(f"remap FL {label} (source {rec['source']}, probe "
            f"{rec['probe']}, constants {rec['constants']}): counts "
            f"{rec['counts']}, predicted_gain_s {rec['predicted_gain_s']:.6e},"
            f" remap {t_remap:.2f} s; hit T_LoH {t * 1e3:.2f} ms, "
            f"tiles_remapped {st.tiles_remapped}, launches {got}")
        worst = hold_against_reference(torch, [req],
                                       [_resp(f"b2@FL {label}", y)])
        out[label] = {"counts": rec["counts"],
                      "predicted_gain_s": rec["predicted_gain_s"],
                      "remap_s": t_remap, "t_loh_s": t,
                      "tiles_remapped": st.tiles_remapped,
                      "worst_err": worst}
    return total, out


def remap_gemm_entry(torch, ops, ref, prog):
    """GEMM at the remapped shape, dense [4096, 4096] @ [4096, 128] with the
    block densified from the widest real FL slice (C = A.B and + acc),
    beside torch.matmul / torch.addmm; and the densify kernel on that
    slice against its plain version (bit for bit) and a library
    scatter."""
    from repro_torch.core.ack import ACK
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, vals_d = st.tiles("cols"), st.tiles("vals")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, vals = cols_d[key], vals_d[key]
    n1, w = cols.shape
    f = pg.config.n2
    nnz = pg.tiles[key[:2]][key[2]].nnz
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.randn(n1, 4 * f, generator=gen, device="cuda")[:, f:2 * f]
    acc = torch.randn(n1, f, generator=gen, device="cuda")

    dense = ops.densify(cols, vals, n1)
    d_err = check_close(torch, "densify FL slice", dense,
                        ref.densify_ref(cols, vals, n1), 0.0, 0.0)
    if not torch.equal(dense.view(torch.int32),
                       ref.densify_ref(cols, vals, n1).view(torch.int32)):
        fail("densify FL slice: not bit-identical to the plain version")
    rows = torch.arange(n1, device="cuda")[:, None].expand(n1, w)
    cl = cols.long()

    def library():
        return torch.zeros(n1, n1, device="cuda").index_put_(
            (rows, cl), vals, accumulate=True)
    t_dk = median_ms(torch, lambda: ops.densify(cols, vals, n1))
    t_dp = median_ms(torch, lambda: ref.densify_ref(cols, vals, n1),
                     reps=3, launches=3)
    t_dl = median_ms(torch, library)
    db_ms, db_by = bound_ms(8 * n1 * w + 4 * n1 * n1, float(n1 * w))
    log(f"kernel densify on FL slice (j,k,s)={key} n1={n1} w={w} nnz={nnz}"
        f": kernel {t_dk:.4f} ms, plain {t_dp:.4f} ms, index_put_"
        f"(accumulate) {t_dl:.4f} ms, bound {db_ms:.4f} ms ({db_by}), "
        "bit-identical to the plain version")
    densify_entry = {
        "name": "densify", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gemm.cu",
        "replaces": "src/repro/core/ack.py:95",
        "max_abs_err": d_err, "ms": t_dk, "plain_ms": t_dp,
        "bound_ms": db_ms, "bound_by": db_by, "library_ms": t_dl}

    info = {"slice": list(key), "w": w, "nnz": nnz}
    for with_acc in (False, True):
        a = acc if with_acc else None
        got = ops.gemm(dense, h, a)
        want = ref.gemm_ref(dense, h) + (acc if with_acc else 0.0)
        err = check_close(torch, f"gemm remapped shape{' +acc' * with_acc}",
                          got, want, KERNEL_RTOL, KERNEL_ATOL)
        if not torch.equal(got, ops.gemm(dense.clone(), h, a)):
            fail("gemm remapped shape: the densified block and its copy "
                 "give different bits")
        if with_acc and not torch.equal(
                got, ACK("cuda").gemm_agg(cols, vals, h, acc)):
            fail("gemm_agg on the FL slice differs from densify + gemm")
        t_k = median_ms(torch, lambda: ops.gemm(dense, h, a))
        if with_acc:
            t_l = median_ms(torch, lambda: torch.addmm(acc, dense, h))
            lib = "torch.addmm"
        else:
            t_l = median_ms(torch, lambda: torch.matmul(dense, h))
            lib = "torch.matmul"
        nbytes = 4 * (n1 * n1 + n1 * f + (2 if with_acc else 1) * n1 * f)
        b_ms, b_by = bound_ms(nbytes, 2.0 * n1 * n1 * f)
        log(f"kernel gemm {n1}x{n1}x{f} (densified FL slice, strided h"
            f"{', +acc' if with_acc else ''}): kernel {t_k:.4f} ms, {lib} "
            f"{t_l:.4f} ms (TF32 off), bound {b_ms:.4f} ms ({b_by}), "
            f"{t_k / b_ms:.2f}x the bound, max|err| {err:.2e}; bits equal "
            "on a copy of the block")
        info["acc" if with_acc else "plain"] = {
            "ms": t_k, "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err}
    return densify_entry, info


# --------------------------------------------------------------------------- #
def build_gat_dot(B, g, hidden: int = 64, n_layers: int = 2, seed: int = 0):
    """gat-dot: a single-head dot-product-attention GAT (the DP attention
    of SuperGAT, Kim & Oh, ICLR 2021; PyG ``SuperGATConv(attention_type=
    "DP")``, negative slope 0.2; b6's widths, paper Table 5) built from the
    builder module ``B``'s primitives.  A copy of ``build_gat_dot`` in
    ``tests/_torch_models.py``."""
    b = B._B(g, f"gatdot{n_layers}x{hidden}", seed)
    f, prev = g.feat_dim, None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else g.n_classes
        h = b.linear(prev, f, fo)
        e = b.vector_inner(h, fo, mode="dot")
        e = b.activation(e, 1, B.Activation.LRELU, on_edges=True)
        e = b.activation(e, 1, B.Activation.EDGE_SOFTMAX, on_edges=True)
        prev = b.aggregate(h, fo, B.AggOp.SUM, edge_weight_layer=e)
        if i < n_layers - 1:
            prev = b.activation(prev, fo, B.Activation.RELU)
        f = fo
    return b.m


def plan_tile_ops(prog) -> dict:
    """Tile ops of one pass of ``prog`` that launch each kernel: GEMM
    steps of LINEAR layers, SUM/MEAN SpDMM steps, dot-mode SDDMM steps."""
    from repro_torch.core.ir import AggOp, LayerType
    out = {"gemm": 0, "spdmm": 0, "sddmm": 0}
    for lp in prog.plan().layers:
        steps = sum(len(tp.compute) for tp in lp.tiles)
        if lp.layer_type == LayerType.LINEAR:
            out["gemm"] += steps
        elif lp.layer_type == LayerType.AGGREGATE and AggOp(lp.mode) in (
                AggOp.SUM, AggOp.MEAN):
            out["spdmm"] += steps
        elif lp.layer_type == LayerType.VECTOR_INNER and lp.mode == 0:
            out["sddmm"] += steps
    return out


def runtime_phase(torch, engine, co, fl):
    """ServeLoop over OverlayPool(engines=[engine, Engine()]): gat-dot and
    b2 on FL, gat-dot on CO, batched; see the module docstring."""
    from repro_torch.core import gnn_builders as TB
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.runtime import OverlayPool, ServeLoop

    gat_fl, gat_co = build_gat_dot(TB, fl), build_gat_dot(TB, co)
    reqs = []
    for i in range(4):
        reqs.append(InferenceRequest(
            model=gat_fl, graph=fl, features=G.random_features(
                fl, seed=20 + i), request_id=f"gat-dot@FL#{i}"))
        reqs.append(InferenceRequest(
            model="b2", graph=fl, features=G.random_features(
                fl, seed=30 + i), request_id=f"b2@FL#{i}"))
        if i < 3:
            reqs.append(InferenceRequest(
                model=gat_co, graph=co, features=G.random_features(
                    co, seed=40 + i), request_id=f"gat-dot@CO#{i}"))
    home = 0                                # engine compiled b2@FL above
    pool = OverlayPool(engines=[engine, Engine()])
    loop = ServeLoop(pool, max_batch=4, max_wait_us=1e9)
    # Record each batch's pass (per-layer CUDA-event times, tile ops by
    # mode) in the overlay's worker thread, right after its pass: an
    # overlay runs its batches FIFO, so its exec_stats are that batch's.
    batches = []
    execute_on = pool.execute_on

    def recorded(idx, batch):
        resps = execute_on(idx, batch)
        st = pool.engines[idx].exec_stats
        batches.append({
            "overlay": idx, "indices": list(batch.indices),
            "size": len(batch), "key": batch.key,
            "modes": dict(st.tile_ops_by_mode or {}),
            "layers": [(r["layer"], r["kernel"], r["tile_ops"],
                        r["wall_s"] * 1e3) for r in st.per_layer]})
        return resps
    pool.execute_on = recorded

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the runtime path: counts are zeroed just above, read below.
    t0 = time.perf_counter()
    try:
        resps = loop.serve(reqs)
    finally:
        loop.shutdown()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the runtime path.

    batches.sort(key=lambda b: b["indices"][0])
    for req, r in zip(reqs, resps):
        log(f"runtime {r.request_id}: T_LoC {r.t_loc * 1e3:.2f} ms, T_LoH "
            f"{r.t_loh * 1e3:.2f} ms, batch {r.batch_size}, overlay "
            f"{r.overlay}, cache_hit {r.cache_hit}")
    exp = {"gemm": 0, "spdmm": 0, "sddmm": 0}
    for b in batches:
        prog = pool.engines[b["overlay"]].cache.get(
            pool.engine_key(b["key"]))
        per_pass = plan_tile_ops(prog)
        for k in exp:
            exp[k] += b["size"] * per_pass[k]
        if per_pass["gemm"] != b["modes"].get("gemm", 0) or \
                per_pass["sddmm"] != b["modes"].get("sddmm", 0):
            fail(f"batch {b['indices']}: executor tile ops {b['modes']} "
                 f"disagree with the plan's {per_pass}")
        log(f"batch {reqs[b['indices'][0]].request_id} x{b['size']} on "
            f"overlay {b['overlay']}: tile ops per pass {per_pass}; "
            "per-layer CUDA-event ms: " + ", ".join(
                f"L{lid}:{k}x{n}={ms:.3f}" for lid, k, n, ms in b["layers"]))
    log(f"runtime: {len(resps)} responses in {wall:.2f} s; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB")
    log("pool stats: " + json.dumps(pool.stats_snapshot()))
    log("metrics: " + json.dumps(pool.metrics.snapshot(max_batch=4)))
    log(f"launches on the runtime path: {launches}; expected lanes x tile "
        f"ops: {exp}")

    if [r.request_id for r in resps] != [r.request_id for r in reqs]:
        fail("runtime responses are not in admission order: "
             f"{[r.request_id for r in resps]}")
    want_sizes = {"gat-dot@FL": 4, "b2@FL": 4, "gat-dot@CO": 3}
    sizes = [r.batch_size for r in resps]
    if sizes != [want_sizes[r.request_id.split("#")[0]] for r in resps] \
            or sorted(b["size"] for b in batches) != [3, 4, 4]:
        fail(f"runtime batch sizes {sizes} / "
             f"{[b['size'] for b in batches]}, expected 4, 4 and 3")
    b2 = [r for r in resps if r.request_id.startswith("b2@FL")]
    if not all(r.cache_hit and r.overlay == home for r in b2):
        fail("b2@FL must hit on overlay 0, got "
             f"{[(r.cache_hit, r.overlay) for r in b2]}")
    for k in exp:
        if not (launches[k] == exp[k] > 0):
            fail(f"{k} launches {launches[k]} != lanes x tile ops {exp[k]}")
    worst = hold_against_reference(torch, reqs, resps)
    log(f"runtime: {len(resps)} outputs within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of run_reference in float64 (worst max|err| "
        f"{worst:.3e})")
    # Lane 0 of each batch against the same request served alone on the
    # same overlay (after the launch counts were read).
    for b in batches:
        i = b["indices"][0]
        solo = pool.engines[b["overlay"]].submit(reqs[i])
        if not torch.equal(solo.output, resps[i].output):
            diff = float((solo.output - resps[i].output).abs().max())
            fail(f"{reqs[i].request_id}: batched lane 0 differs from the "
                 f"solo serve by {diff:.3e}")
        st = pool.engines[b["overlay"]].exec_stats
        log(f"solo {reqs[i].request_id} on overlay {b['overlay']}: "
            f"bit-identical to lane 0 of its batch; T_LoH "
            f"{solo.t_loh * 1e3:.2f} ms, cache_hit {solo.cache_hit}; "
            "per-layer CUDA-event ms: " + ", ".join(
                f"L{r['layer']}:{r['kernel']}x{r['tile_ops']}="
                f"{r['wall_s'] * 1e3:.3f}" for r in st.per_layer))
    gat_eng = pool.engines[resps[0].overlay]
    profile_call(torch, lambda: gat_eng.serve([reqs[0]]),
                 "gat-dot@FL hit")
    gat_prog = gat_eng.cache.get(resps[0].cache_key)
    return launches, gat_prog, resps, peak, wall


def fl_sddmm_entry(torch, ops, ref, prog):
    """The SDDMM kernel on the widest real ELL slice of the gat-dot FL
    program, with its real mask, an accumulator, and the source / target
    views the executor passes it (the kernels-line entry); then on a
    synthetic hub tile of the same shape.  Returns (entry, hub tile
    summary)."""
    from repro_torch.engine.executor import _staged
    pg = prog.pgraph
    st = _staged(pg, torch.device("cuda"))
    cols_d, mask_d = st.tiles("cols"), st.tiles("mask")
    key = max(cols_d, key=lambda k3: (cols_d[k3].shape[1],
                                      pg.tiles[k3[:2]][k3[2]].nnz))
    cols, mask = cols_d[key], mask_d[key]
    n1, w = cols.shape
    f = pg.config.n2
    j, k = key[0], key[1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    h = torch.randn(pg.n_blocks * n1, f, generator=gen, device="cuda")
    hd, hs = h[j * n1:(j + 1) * n1], h[k * n1:(k + 1) * n1]
    acc = torch.randn(n1, w, generator=gen, device="cuda")
    fl = sddmm_tile(torch, ops, ref, f"gat-dot FL slice (j,k,s)={key}", hd,
                    hs, cols, mask, acc)
    # Hub tile: n1 = 4096, w = 512, 256 rows with all 512 slots live, the
    # rest with their first 25 (the FL slice's median), live slots packed
    # at the front of each row as the partitioner packs them.
    lens = torch.full((n1,), 25, device="cuda")
    lens[torch.randperm(n1, generator=gen, device="cuda")[:256]] = w
    hub_mask = (torch.arange(w, device="cuda")[None] < lens[:, None]
                ).contiguous()
    hub_cols = torch.where(hub_mask, torch.randint(
        0, n1, (n1, w), generator=gen, device="cuda"), 0).to(
        torch.int32).contiguous()
    hub = sddmm_tile(torch, ops, ref, "synthetic hub tile", hd, hs, hub_cols,
                     hub_mask, acc)
    return ({"name": "sddmm", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/sddmm.cu",
             "replaces": "src/repro/kernels/sddmm.py:46",
             "max_abs_err": fl["max_abs_err"], "ms": fl["ms"],
             "plain_ms": fl["plain_ms"], "bound_ms": fl["bound_ms"],
             "bound_by": fl["bound_by"], "library_ms": fl["library_ms"],
             "padded_bound_ms": fl["padded_bound_ms"]},
            hub)


def sddmm_tile(torch, ops, ref, label, hd, hs, cols, mask, acc):
    """One [n1, w] SDDMM tile with a mask and an accumulator: held against
    the plain version, masked slots equal to acc, two runs equal; times
    of kernel, plain version and torch.sparse.sampled_addmm, and the
    bound."""
    n1, w = cols.shape
    f = hd.shape[1]
    want = ref.sddmm_step_ref(hd, hs, cols, mask, acc)
    got = ops.sddmm(hd, hs, cols, mask, acc)
    err = check_close(torch, f"sddmm {label}", got, want, KERNEL_RTOL,
                      KERNEL_ATOL)
    if not torch.equal(got[~mask], acc[~mask]):
        fail(f"sddmm {label}: a masked slot does not keep its accumulator")
    if not torch.equal(got, ops.sddmm(hd, hs, cols, mask, acc)):
        fail(f"sddmm {label}: two runs on the same inputs differ")
    # Library yardstick: torch.sparse.sampled_addmm on the CSR pattern of
    # the live slots (acc + h_dst @ h_src^T sampled there).
    rows, slots = torch.nonzero(mask, as_tuple=True)
    counts = torch.bincount(rows, minlength=n1)
    crow = torch.zeros(n1 + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(counts, 0)
    live_cols = cols[rows, slots].long()
    csr = torch.sparse_csr_tensor(crow, live_cols, acc[rows, slots],
                                  size=(n1, hs.shape[0]))
    hdc, hst = hd.contiguous(), hs.t().contiguous()
    lib = torch.sparse.sampled_addmm(csr, hdc, hst)
    check_close(torch, f"sampled_addmm yardstick, {label}", lib.values(),
                want[rows, slots], KERNEL_RTOL, KERNEL_ATOL)
    t_k = median_ms(torch, lambda: ops.sddmm(hd, hs, cols, mask, acc))
    t_p = median_ms(torch, lambda: ref.sddmm_step_ref(hd, hs, cols, mask,
                                                      acc))
    t_l = median_ms(torch, lambda: torch.sparse.sampled_addmm(csr, hdc,
                                                              hst))
    nnz = int(rows.numel())
    src_rows = int(torch.unique(live_cols).numel())
    dst_rows = int(torch.unique(rows).numel())
    # Bytes the function needs: mask (1) + acc in (4) + out (4) per slot,
    # the column (4) of each live slot only (a masked slot's output is acc
    # whatever its column holds), and once each the h_dst rows that have a
    # live slot and the live source rows; operations: 2 f per live slot.
    b_ms, b_by = bound_ms(9 * n1 * w + 4 * nnz + 4 * f * (dst_rows
                                                          + src_rows),
                          2.0 * nnz * f)
    # The padded count: every slot's column and every h_dst row read.
    b_pad, _ = bound_ms(13 * n1 * w + 4 * f * (n1 + src_rows),
                        2.0 * nnz * f)
    log(f"kernel sddmm on {label} n1={n1} w={w} f={f} live={nnz} "
        f"({src_rows} source rows, L2 gather volume "
        f"{nnz * 4 * f / 1e6:.1f} MB): kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, torch.sparse.sampled_addmm {t_l:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; padded {b_pad:.4f} ms), max|err| "
        f"{err:.2e}; masked slots keep acc, two runs equal")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l,
            "live": nnz, "padded_bound_ms": b_pad}


# --------------------------------------------------------------------------- #
SAMPLE_GEOM = (256, 32)          # bench_sample.py's full-mode (n1, n2)
SAMPLE_FANOUTS = (25, 10)        # GraphSAGE's published two-hop sizes
SAMPLE_MODELS = ("b1", "b3", "b6")
SAMPLE_N, SAMPLE_WARM, SAMPLE_MAX_BATCH = 64, 384, 8
SAMPLE_MIN_HIT_RATE, SAMPLE_MIN_BITWISE = 0.9, 8


def sample_stream(np, n_vertices, n, seed, tag):
    """``n`` per-user requests: 1-16 distinct targets each (drawn from
    ``seed``), fanouts (25, 10), models b1 / b3 / b6 round-robin, and a
    sampling seed per request."""
    from repro_torch.sampling import TargetRequest
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = rng.choice(n_vertices, size=int(rng.integers(1, 17)),
                       replace=False)
        out.append(TargetRequest(
            targets=[int(v) for v in t], model=SAMPLE_MODELS[i % 3],
            fanouts=SAMPLE_FANOUTS, request_id=f"{tag}{i}",
            seed=int(rng.integers(1 << 30))))
    return out


def sampled_phase(torch, fl_raw):
    """Per-user ego-network serving through ``SamplingService`` on the
    full-scale synthesized Flickr graph; see the module docstring.
    Returns (launches of the served stream, a summary dict)."""
    import numpy as np

    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import build
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.core.reference import run_reference
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.runtime import Batch, request_cost
    from repro_torch.sampling import SamplingService, sample_ego

    n1, n2 = SAMPLE_GEOM
    geom = PartitionConfig(n1=n1, n2=n2)
    X = G.random_features(fl_raw, seed=3)
    svc = SamplingService(fl_raw, X, n_overlays=2, geometry=geom,
                          max_batch=SAMPLE_MAX_BATCH)
    reqs = sample_stream(np, fl_raw.n_vertices, SAMPLE_N, 0, "u")
    warm = sample_stream(np, fl_raw.n_vertices, SAMPLE_WARM, 1, "w")
    t0 = time.perf_counter()
    n_prog = svc.warm(warm)
    torch.cuda.synchronize()
    log(f"sampled: warmed {n_prog} programs from a disjoint stream of "
        f"{len(warm)} requests in {time.perf_counter() - t0:.2f} s")

    # Each batch's pass, recorded in the overlay's worker thread right
    # after it (an overlay runs its batches FIFO).
    batches = []
    execute_on = svc.pool.execute_on

    def recorded(idx, batch):
        resps = execute_on(idx, batch)
        st = svc.pool.engines[idx].exec_stats
        batches.append({"overlay": idx, "key": batch.key,
                        "size": len(batch),
                        "modes": dict(st.tile_ops_by_mode or {}),
                        "h2d_bytes": st.h2d_bytes,
                        "t_loh_s": resps[0].t_loh})
        return resps
    svc.pool.execute_on = recorded
    h0 = sum(e.stats.cache_hits for e in svc.pool.engines)
    r0 = sum(e.stats.requests for e in svc.pool.engines)
    torch.cuda.synchronize()
    ops.reset_launches()
    # ---- the sampled path: counts are zeroed just above, read below.
    t0 = time.perf_counter()
    try:
        resps = svc.serve(reqs)
    finally:
        svc.shutdown()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # ---- end of the sampled path.
    svc.pool.execute_on = execute_on
    hits = sum(e.stats.cache_hits for e in svc.pool.engines) - h0
    served = sum(e.stats.requests for e in svc.pool.engines) - r0
    hit_rate = hits / served

    snap = svc.pool.metrics.snapshot(max_batch=SAMPLE_MAX_BATCH)["global"]
    census = dict(sorted(svc.bucket_counts.items(),
                         key=lambda kv: -kv[1]))
    log(f"sampled: {len(resps)} responses in {wall:.3f} s "
        f"({len(resps) / wall:.2f} requests/s), latency p50 "
        f"{snap['p50_latency_ms']:.3f} ms, p99 {snap['p99_latency_ms']:.3f}"
        f" ms (of {snap['requests']} requests), {len(batches)} batches, "
        f"mean batch size {snap['mean_batch_size']:.3f}; program-cache hit "
        f"rate after warm-up {hit_rate:.4f} ({hits}/{served})")
    log(f"sampled: bucket census ({len(census)} buckets) {census}")
    # Tile steps of each bucket program and its expected launches.
    exp = {"gemm": 0, "spdmm": 0}
    steps = {}
    for b in batches:
        eng = svc.pool.engines[b["overlay"]]
        prog = eng.cache.get(svc.pool.engine_key(b["key"]))
        if prog is None:
            fail(f"sampled: a served program left overlay {b['overlay']}'s "
                 "cache")
        per_pass = plan_tile_ops(prog)
        label = f"{prog.model_name}@{prog.graph_name}"
        steps[label] = {"tile_steps": per_pass, "n_blocks":
                        prog.pgraph.n_blocks}
        for k in exp:
            exp[k] += b["size"] * per_pass[k]
        if per_pass["gemm"] != b["modes"].get("gemm", 0):
            fail(f"sampled batch {label}: executor GEMM steps "
                 f"{b['modes']} != the plan's {per_pass}")
    for label, s in sorted(steps.items()):
        log(f"  program {label}: nb {s['n_blocks']}, tile steps per lane "
            f"{s['tile_steps']}")
    h2d = [b["h2d_bytes"] for b in batches]
    log(f"sampled: graph_data H2D bytes per batch: mean "
        f"{statistics.mean(h2d):.0f}, max {max(h2d)}, total {sum(h2d)}; "
        f"launches {launches}; expected lanes x tile steps {exp}")
    for k in exp:
        if not (launches[k] == exp[k] > 0):
            fail(f"sampled {k} launches {launches[k]} != lanes x tile steps"
                 f" {exp[k]}")
    if hit_rate < SAMPLE_MIN_HIT_RATE:
        fail(f"sampled: cache hit rate {hit_rate:.4f} < "
             f"{SAMPLE_MIN_HIT_RATE}")
    if [r.request_id for r in resps] != [r.request_id for r in reqs]:
        fail("sampled responses are not in request order")

    # Every response against a float64 reference of its own subgraph;
    # the largest bucket of each model and more against the unpadded
    # subgraph served through Engine.submit, bit for bit.
    size = {r.bucket: tuple(int(p[1:]) for p in r.bucket.split("-")[:3])
            for r in resps}
    chosen = set()
    for m in SAMPLE_MODELS:
        mine = [i for i, q in enumerate(reqs) if q.model == m]
        chosen.add(max(mine, key=lambda i: size[resps[i].bucket]))
        chosen.update(mine[:2])
    largest = max(size.values())
    chosen.update(i for i, r in enumerate(resps) if size[r.bucket] ==
                  largest)
    solo = Engine(geometry=geom)
    worst, bitwise = 0.0, 0
    for i, (q, r) in enumerate(zip(reqs, resps)):
        ego = sample_ego(fl_raw, q.targets, q.fanouts, seed=q.seed)
        sub = ego.graph.gcn_normalized()
        xs = torch.as_tensor(X[ego.vertices], device="cuda")
        nt = ego.n_targets
        if tuple(r.logits.shape) != (nt, fl_raw.n_classes) or not bool(
                torch.isfinite(r.logits).all()):
            fail(f"sampled {r.request_id}: logits {tuple(r.logits.shape)} "
                 "or non-finite values")
        y64 = run_reference(build(q.model, sub, q.model_seed), sub, xs,
                            dtype=torch.float64)[:nt]
        err = (r.logits.double() - y64).abs()
        if bool((err > PATH_ATOL + PATH_RTOL * y64.abs()).any()):
            fail(f"sampled {r.request_id} ({q.model}, {r.bucket}): max|err| "
                 f"{float(err.max()):.3e} past rtol {PATH_RTOL} / atol "
                 f"{PATH_ATOL} of the float64 reference")
        worst = max(worst, float(err.max()))
        if i in chosen:
            y = solo.submit(InferenceRequest(q.model, sub, X[ego.vertices],
                                             seed=q.model_seed)).output
            if not torch.equal(r.logits, y[:nt]):
                fail(f"sampled {r.request_id} ({q.model}, {r.bucket}): "
                     "padded logits differ from the unpadded subgraph's by "
                     f"{float((r.logits - y[:nt]).abs().max()):.3e}")
            bitwise += 1
    if bitwise < SAMPLE_MIN_BITWISE:
        fail(f"sampled: only {bitwise} responses held bit for bit")
    log(f"sampled: {len(resps)} responses within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of float64 references of their subgraphs (worst "
        f"max|err| {worst:.3e}); {bitwise} (each model, the largest bucket "
        f"{largest}) bit-identical to the unpadded subgraph through "
        "Engine.submit")

    # One batch of the most populated key, profiled.
    key = max({b["key"] for b in batches},
              key=lambda k: sum(b["size"] for b in batches
                                if b["key"] == k))
    infs = [svc.prepare(q, count=False)[0] for q in reqs]
    same = [inf for inf in infs if svc.pool.cache_key(inf) == key]
    same = (same * SAMPLE_MAX_BATCH)[:SAMPLE_MAX_BATCH]
    batch = Batch(key=key, requests=same, indices=list(range(len(same))),
                  created_at=0.0, cost=len(same) * request_cost(same[0]))
    prof = {}
    profile_call(torch, lambda: svc.pool.submit_batch(batch),
                 f"sampled batch of {len(same)} ({same[0].graph.name})",
                 split="HtoD", out=prof)
    return launches, {
        "wall_s": wall, "requests_per_s": len(resps) / wall,
        "hit_rate": hit_rate, "warmed_programs": n_prog, "metrics": snap,
        "buckets": census, "batches": len(batches),
        "h2d_bytes_per_batch": h2d, "tile_steps": steps,
        "launches": launches, "worst_err": worst, "bitwise": bitwise,
        "profile": prof}


def _report_line(label, rep) -> str:
    modes = ", ".join(f"{m} {rep.model_error[m]:.4f} -> "
                      f"{rep.model_error_calibrated[m]:.4f} (scale "
                      f"{rep.scales[m]:.4g})" for m in sorted(rep.model_error))
    return (f"conformance {label}: predicted {rep.predicted_s * 1e3:.4f} ms, "
            f"measured {rep.measured_s * 1e3:.4f} ms; model error "
            f"{rep.model_error_overall:.4f} -> "
            f"{rep.model_error_overall_calibrated:.4f} calibrated; per mode "
            f"{modes}")


def _checked_report(label, rep):
    for m, e in rep.model_error.items():
        if not rep.model_error_calibrated[m] <= e + 1e-12:
            fail(f"conformance {label}: calibrated error "
                 f"{rep.model_error_calibrated[m]} > uncalibrated {e} "
                 f"({m})")
    if rep.model_error_overall_calibrated > rep.model_error_overall + 1e-12:
        fail(f"conformance {label}: calibrated overall error above the "
             "uncalibrated one")
    log(_report_line(label, rep))
    return rep


def conformance_phase(torch, co, fl, card, budget, fl_remap):
    """Conformance reports on the card (b1-b8 on CO and b2@FL device-
    resident, b2@FL host-streamed under phase 4's budget), fitted
    constants, fit_stage_bw against the profiler's copy rate, and the
    remap decisions a fitted report makes on FL; see the module
    docstring.  Returns (launches of the reported runs, a summary)."""
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS
    from repro_torch.core.perfmodel import DEFAULT_CONSTANTS
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.kernels import ops
    from repro_torch.obs import build_report, fit_stage_bw, tracing

    out = {"co": {}, "card": card}
    launches = {k: 0 for k in ops.LAUNCHES}

    def counted(fn):
        ops.reset_launches()
        # ---- a reported run: counts zeroed above, read below.
        y = fn()
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        # ----
        return y

    ceng = Engine()
    for name in BENCHMARKS:
        prog = ceng.compile(name, co, use_cache=False)
        x = G.random_features(co, seed=1)
        ceng.run(prog, x)                                  # warm
        counted(lambda: ceng.run(prog, x))
        rep = _checked_report(f"{name}@CO device",
                              build_report(prog, ceng.exec_stats))
        out["co"][name] = rep.to_dict()

    t0 = time.perf_counter()
    prog = ceng.compile("b2", fl, use_cache=False)
    log(f"conformance: b2@FL recompiled with its source in "
        f"{time.perf_counter() - t0:.2f} s")
    x = G.random_features(fl, seed=10)
    ceng.run(prog, x)                                      # uploads tiles
    y_dev = counted(lambda: ceng.run(prog, x))
    dev = _checked_report("b2@FL device", build_report(prog,
                                                       ceng.exec_stats))
    ceng.executor.resident_budget_bytes = budget
    y_host = ceng.run(prog, x, residency="host")           # pins tiles
    prof = {}
    with tracing() as t:
        profile_call(torch, lambda: counted(
            lambda: ceng.run(prog, x, residency="host")),
            "b2@FL host hit, traced", split="HtoD", out=prof)
    events = t.events()
    host_stats = ceng.exec_stats
    host = _checked_report("b2@FL host", build_report(
        prog, host_stats, residency="host", events=events))
    ceng.executor.resident_budget_bytes = None
    if not torch.equal(y_host, y_dev):
        fail("conformance: b2@FL host output differs from the device path")
    stages = [e for e in events if e.get("name") == "stage"]
    if not stages or any("copy_us" not in e["args"] for e in stages):
        fail("conformance: host stage spans without the copies' device "
             "time")
    bw = fit_stage_bw(events)
    host_dur_bw = sum(e["args"]["bytes"] ** 2 for e in stages) / sum(
        e["args"]["bytes"] * e["dur"] / 1e6 for e in stages)
    prof_bw = (host_stats.h2d_bytes / (prof["split_ms"] / 1e3)
               if prof.get("split_ms") else None)
    if prof_bw is None:
        fail("conformance: the profiler read no HtoD copies; the copy-"
             "engine rate was not measured")
    gap = abs(bw - prof_bw) / prof_bw
    log(f"conformance: fit_stage_bw {bw / 1e9:.3f} GB/s from {len(stages)} "
        f"stage spans' copy time, the profiler's copy-engine rate "
        f"{prof_bw / 1e9:.3f} GB/s ({host_stats.h2d_bytes} B over "
        f"{prof['split_ms']:.3f} ms of HtoD copies), {100 * gap:.2f}% apart;"
        f" the spans' host durations would fit {host_dur_bw / 1e9:.3f} GB/s"
        f" ({card})")
    if gap > 0.15:
        fail(f"conformance: fit_stage_bw {bw:.4g} B/s is {100 * gap:.1f}% "
             f"from the profiler's copy rate {prof_bw:.4g} B/s (limit 15%)")

    fitted = dict(dev.calibrated_constants, stage_bw=bw)
    for k, v in DEFAULT_CONSTANTS.to_dict().items():
        run = "b2@FL host stage spans" if k == "stage_bw" else "b2@FL device"
        got = f"{fitted[k]:.4g}" if k in fitted else "not fitted"
        log(f"  constant {k}: data sheet {v:.4g}, fitted {got} from {run} "
            f"({card})")
    rp = ceng.remap(prog, report=dev)
    rec = rp.manifest["remap"]
    log(f"conformance: remap of b2@FL priced by the fitted constants: counts "
        f"{rec['counts']}, predicted gain {rec['predicted_gain_s']:.6e} s; "
        f"by the H100 data sheet {fl_remap['h100-default']['counts']}, "
        f"by probe {fl_remap['probe']['counts']} (phase 4)")
    if rp.binary != prog.binary:
        y = ceng.run(rp, x)
        hold_against_reference(torch, [InferenceRequest("b2", fl, x)],
                               [_resp("b2@FL fitted remap", y)])
    out.update(fl_device=dev.to_dict(), fl_host=host.to_dict(),
               fitted_constants=fitted, fit_stage_bw=bw,
               profiler_copy_bw=prof_bw, stage_host_duration_bw=host_dur_bw,
               fitted_remap={"counts": rec["counts"],
                             "predicted_gain_s": rec["predicted_gain_s"]},
               host_profile=prof)
    return launches, out


# --------------------------------------------------------------------------- #
LIVE_GEOM = (4096, 128)         # (n1, n2): the compiler's pick for FL
# CO in blocks of 1024 (3 x 3 tiles): draining one tile leaves the others
# (the compiler's pick, n1 = 4096, puts CO in one tile).
LIVE_REMAP_GEOM = (1024, 128)
LIVE_DELTA_EDGES = 32           # removals and additions of a content delta
LIVE_NEW_VERTICES = 1024        # the structural delta: one in-, one out-edge
LIVE_STREAM, LIVE_CUTS = 24, {8: 1, 16: 2}   # admission index -> version
HOST_ALIGN = 16                 # elements: a host buffer's slice alignment
# Bytes per element of each staged tile kind, and what it spans: the
# [n1, w] slots, one entry a row, or the live slots.
KIND_BYTES = {"cols": (4, "slots"), "vals": (4, "slots"),
              "mask": (1, "slots"), "row_len": (4, "rows"),
              "live_pos": (8, "nnz"), "live_epos": (8, "nnz")}


def kind_bytes(t, kind, align=1) -> int:
    """Bytes of an ELL slice's staged ``kind`` (its element count rounded
    up to ``align``), from the slice's shape and nnz alone."""
    item, over = KIND_BYTES[kind]
    n = {"slots": t.cols.size, "rows": t.cols.shape[0], "nnz": t.nnz}[over]
    return item * ((int(n) + align - 1) // align * align)


def live_delta(np, GraphDelta, version, seed):
    """A content delta on ``version``: LIVE_DELTA_EDGES removals of
    distinct existing (src, dst) pairs (drawn uniformly over the pairs; a
    pair's multi-edges go together), then as many additions between
    existing vertices, from ``seed``.  A draw that would change the tile
    structure (a new tile, or a slice more or less where a row crosses a
    multiple of the width cap) is not a content delta and is drawn again
    from (seed, attempt); returns (delta, attempt)."""
    g = version.as_graph()
    nv = g.n_vertices
    pairs = np.unique(g.src.astype(np.int64) * nv + g.dst)
    for attempt in range(16):
        rng = np.random.default_rng([seed, attempt])
        d = GraphDelta(nv)
        for p in rng.choice(pairs, LIVE_DELTA_EDGES, replace=False):
            d.remove_edge(int(p // nv), int(p % nv))
        for _ in range(LIVE_DELTA_EDGES):
            u, v = (int(a) for a in rng.integers(0, nv, 2))
            d.add_edge(u, v, float(rng.uniform(0.1, 1.0)))
        if not version.store.apply(d.coalesce())[1].structural_change:
            return d, attempt
    fail(f"live: no content delta in 16 draws from seed {seed}")


def structural_delta(np, GraphDelta, g, seed):
    """LIVE_NEW_VERTICES new vertices (zero features), each with one
    in-edge from and one out-edge to a random existing vertex."""
    rng = np.random.default_rng(seed)
    d = GraphDelta(g.n_vertices, feat_dim=g.feat_dim)
    for _ in range(LIVE_NEW_VERTICES):
        w = d.add_vertex()
        a, b = (int(v) for v in rng.integers(0, g.n_vertices, 2))
        d.add_edge(a, w, float(rng.uniform(0.1, 1.0)))
        d.add_edge(w, b, float(rng.uniform(0.1, 1.0)))
    return d


def host_rss() -> str:
    """This process's resident host memory, and its peak (getrusage)."""
    import resource
    rss = 0
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return (f"host RSS {rss / 2**30:.2f} GiB (peak {peak / 2**30:.2f} "
            "GiB)")


def patched_tiles(v):
    return [tuple(int(a) for a in k.split(":")) for k in v.stats.patched]


def live_phase(torch, card):
    """Live full-scale FL (``repro_torch.livegraph``) with verification on;
    see the module docstring.  Returns (launches of the live path, a
    summary)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import gnn_builders as TB
    from repro_torch.core import graph as G
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.engine import (Engine, InferenceRequest,
                                    ResidentBudgetError)
    from repro_torch.engine.executor import (_host_tiles, _staged,
                                             release_staging)
    from repro_torch.kernels import ops
    from repro_torch.livegraph import (GraphDelta, GraphVersionStore,
                                       LiveGraphServer)
    from repro_torch.obs import tracing
    from repro_torch.runtime import OverlayPool, ServeLoop
    from repro_torch.verify import check_trace
    from repro_torch.verify.__main__ import main as verify_main

    out = {"card": card, "versions": {}}
    launches = {k: 0 for k in ops.LAUNCHES}

    def counted(fn):
        ops.reset_launches()
        # ---- a run of the live path: counts zeroed above, read below.
        y = fn()
        torch.cuda.synchronize()
        for k, n in ops.LAUNCHES.items():
            launches[k] += n
        # ----
        return y

    fl = G.synthesize("FL").gcn_normalized()
    geom = PartitionConfig(n1=LIVE_GEOM[0], n2=LIVE_GEOM[1])
    t0 = time.perf_counter()
    store = GraphVersionStore(fl, geometry=geom)
    log(f"live: tile store of FL built in {time.perf_counter() - t0:.2f} s "
        f"({len(store.head.pgraph.tiles)} tiles, "
        f"{sum(len(ts) for ts in store.head.pgraph.tiles.values())} slices, "
        f"{store.head.pgraph.tile_bytes()} B of ELL on the host); "
        + host_rss())
    pool = OverlayPool(2, geometry=geom, verify=True)
    eng = pool.engines[0]
    live = LiveGraphServer(store, metrics=pool.metrics)
    verify_s = []

    def timed_verify(e, idx):
        real = e._verify_program

        def run(prog):
            t = time.perf_counter()
            real(prog)
            verify_s.append((f"overlay {idx} {prog.model_name}"
                             f"@{prog.graph_name}",
                             time.perf_counter() - t))
        e._verify_program = run
    for idx, e in enumerate(pool.engines):
        timed_verify(e, idx)
    xs = [G.random_features(fl, seed=60 + i) for i in range(4)]

    def cold(model, gv, x):
        """The same graph as a plain Graph, cold-compiled and run on a
        second Engine (not counted: a comparison, not the live path)."""
        e = Engine(geometry=geom)
        p = e.compile(model, dataclasses.replace(gv, name=gv.name + "-cold"))
        y = e.run(p, x)
        release_staging(p.pgraph)
        del e, p
        gc.collect()
        return y

    def hold(label, model, gv, x, y):
        """y against the cold compile (bits) and float64 (tolerance)."""
        yc = cold(model, gv, x)
        if not torch.equal(y, yc):
            fail(f"live {label}: differs from a cold compile of the version "
                 f"by {float((y - yc).abs().max()):.3e}")
        worst = hold_against_reference(
            torch, [InferenceRequest(model, gv, x)], [_resp(label, y)])
        log(f"live {label}: bit-identical to a cold compile, within rtol "
            f"{PATH_RTOL} / atol {PATH_ATOL} of float64 (max|err| "
            f"{worst:.3e})")

    def serve(v, model, label, x):
        """A first pass and two hits of ``model`` on version ``v`` through
        Engine.submit (the program rebound to v's tiles)."""
        gv = v.as_graph()
        resps = [counted(lambda: eng.submit(InferenceRequest(
            model, gv, x, request_id=f"{label}#{i}"))) for i in range(3)]
        st = _staged(v.pgraph, eng.device)
        for r in resps[1:]:
            if not torch.equal(r.output, resps[0].output):
                fail(f"live {label}: a hit differs from the first pass")
        rec = {"t_loc_s": resps[0].t_loc, "cache_hit": resps[0].cache_hit,
               "first_t_loh_s": resps[0].t_loh,
               "hit_t_loh_s": [r.t_loh for r in resps[1:]],
               "uploaded": st.uploaded, "kinds": st.kinds()}
        log(f"live {label}: T_LoC {resps[0].t_loc * 1e3:.2f} ms (cache_hit "
            f"{resps[0].cache_hit}), first pass T_LoH "
            f"{resps[0].t_loh * 1e3:.2f} ms, hits "
            + ", ".join(f"{r.t_loh * 1e3:.2f}" for r in resps[1:])
            + f" ms; uploaded {st.uploaded} B ({', '.join(st.kinds())}); "
            + host_rss())
        return resps[0].output, rec

    def expect_uploaded(v, rec, kinds, label):
        want = v.pgraph.inv_in_degree.nbytes + sum(
            kind_bytes(t, kind) for jk in patched_tiles(v)
            for t in v.pgraph.tiles[jk] for kind in kinds)
        log(f"live {label}: {len(v.stats.patched)} of "
            f"{len(v.pgraph.tiles)} tiles patched "
            f"({v.stats.tiles_created} created); uploaded {rec['uploaded']} "
            f"B, the patched tiles' {', '.join(kinds)} plus inv_in_degree "
            f"{want} B (a full upload: {out['versions']['v0']['uploaded']} "
            "B)")
        if rec["uploaded"] != want:
            fail(f"live {label}: uploaded {rec['uploaded']} B != the patched "
                 f"tiles' {want} B")
        rec["uploaded_expected"] = want

    # ---- v0: the first compile, host-streamed under PR 16's budget ----- #
    v0 = store.head
    c0 = eng.stats.compiles
    y0, rec0 = serve(v0, "b2", "b2@FL v0", xs[0])
    out["versions"]["v0"] = rec0
    if rec0["cache_hit"] or eng.stats.compiles != c0 + 1:
        fail("live v0: expected one compile")
    kinds = rec0["kinds"]
    hold("b2@FL v0", "b2", v0.as_graph(), xs[0], y0)
    ex = eng.executor
    prog0 = eng.compile("b2", v0.as_graph())
    window = ex.estimate_host_window_bytes(prog0, xs[0].shape[1])
    weights = sum(int(w.nbytes) for w in prog0.weights.values())
    dev_peak = ex.estimate_device_peak_bytes(prog0, xs[0].shape[1])
    budget = (window + weights + dev_peak) // 2
    ex.resident_budget_bytes = budget
    try:
        eng.run(prog0, xs[0], residency="device")
    except ResidentBudgetError:
        pass
    else:
        fail("live: a device-resident run under the budget was not refused")
    ex.resident_budget_bytes = None

    def host_run(prog, v, label):
        """A host-streamed pass under the budget that refuses the device
        path."""
        ex.resident_budget_bytes = budget
        t = time.perf_counter()
        y = counted(lambda: eng.run(prog, xs[0], residency="host"))
        ex.resident_budget_bytes = None
        ht = _host_tiles(v.pgraph, eng.device.type == "cuda")
        log(f"live {label} host-streamed: T_LoH "
            f"{(time.perf_counter() - t) * 1e3:.2f} ms, pinned {ht.nbytes} "
            f"B for this version, h2d {eng.exec_stats.h2d_bytes} B; "
            + host_rss())
        return y, ht

    yh0, ht0 = host_run(prog0, v0, "b2@FL v0")
    if not torch.equal(yh0, y0):
        fail("live v0: the host path differs from the device path")
    host_kinds = sorted(ht0._rows)
    rec0["pinned"] = ht0.nbytes

    # ---- v1, v2: content deltas ---------------------------------------- #
    applied = []
    for seed in (1, 2):
        d, attempt = live_delta(np, GraphDelta, store.head, seed)
        t = time.perf_counter()
        applied.append((store.apply(d), time.perf_counter() - t, attempt))
    (v1, _, _), (v2, _, _) = applied
    for v, ta, attempt in applied:
        holes = v.store.eid_capacity - v.store.live_edges
        log(f"live v{v.vid}: delta (draw {attempt}) applied in {ta:.2f} s: "
            f"{json.dumps(v.stats.as_dict())}; {v.store.live_edges} live "
            f"edges, edge-id capacity {v.store.eid_capacity} ({holes} "
            "holes)")
        if v.stats.structural_change:
            fail(f"live v{v.vid}: a content delta changed the structure")
    for v in (v1, v2):
        c = eng.stats.compiles
        y, rec = serve(v, "b2", f"b2@FL v{v.vid}", xs[0])
        out["versions"][f"v{v.vid}"] = rec
        if not rec["cache_hit"] or rec["t_loc_s"] != 0.0 or \
                eng.stats.compiles != c:
            fail(f"live v{v.vid}: expected a cache hit with T_LoC 0 and no "
                 "compile")
        expect_uploaded(v, rec, kinds, f"b2@FL v{v.vid}")
        hold(f"b2@FL v{v.vid}", "b2", v.as_graph(), xs[0], y)
        if v is v1:
            y1 = y
    prog1 = eng.compile("b2", v1.as_graph())
    yh1, ht1 = host_run(prog1, v1, "b2@FL v1")
    if not torch.equal(yh1, y1):
        fail("live v1: the host path differs from the device path")
    rows = sorted({j for j, _ in patched_tiles(v1)})
    want = sum(kind_bytes(t, kind, HOST_ALIGN) for j in rows
               for (jj, _), ts in v1.pgraph.tiles.items() if jj == j
               for t in ts for kind in host_kinds)
    if ht1._inv_deg is not None:        # pinned only if a MEAN layer ran
        want += v1.pgraph.inv_in_degree.nbytes
    log(f"live b2@FL v1 host: pinned {ht1.nbytes} B for the {len(rows)} of "
        f"{v1.pgraph.n_blocks} shards that hold a patched tile "
        f"(expected {want} B; v0 pinned {ht0.nbytes} B)")
    if ht1.nbytes != want:
        fail(f"live v1: pinned {ht1.nbytes} B != {want} B")
    out["versions"]["v1"].update(pinned=ht1.nbytes, pinned_expected=want,
                                 pinned_shards=len(rows))
    ex.resident_budget_bytes = budget
    with tracing() as tr:
        counted(lambda: eng.run(prog1, xs[0], residency="host"))
    ex.resident_budget_bytes = None
    race = check_trace(tr.to_dict(), prog1)
    log(f"live b2@FL v1 traced host hit: check_trace overlap_pairs "
        f"{race.stats.get('overlap_pairs')}, {len(race.violations)} "
        f"violations, checks {race.checks_run} (spans are host issue "
        "times: issue order only)")
    if not race.ok:
        fail("live: race check failed: " + race.to_markdown())
    out["race"] = {"overlap_pairs": race.stats.get("overlap_pairs"),
                   "violations": len(race.violations)}

    gat = build_gat_dot(TB, fl)
    c = eng.stats.compiles
    t = time.perf_counter()
    gprog = eng.compile(gat, v1.as_graph())
    t_gc = time.perf_counter() - t
    t = time.perf_counter()
    yg = counted(lambda: eng.run(gprog, xs[0]))
    log(f"live gat-dot@FL v1: compiled and bound in {t_gc:.2f} s, a pass in "
        f"{(time.perf_counter() - t) * 1e3:.2f} ms, over "
        f"{v1.store.eid_capacity - v1.store.live_edges} edge-id holes")
    if eng.stats.compiles != c + 1:
        fail("live: gat-dot on v1 should compile once")
    hold("gat-dot@FL v1", gat, v1.as_graph(), xs[0], yg)

    # ---- the cutover stream --------------------------------------------- #
    solo = {}
    for v in (v0, v1, v2):
        p = eng.compile("b2", v.as_graph())
        for i, x in enumerate(xs):
            solo[(v.vid, i)] = counted(lambda: eng.run(p, x))
    compiles = sum(e.stats.compiles for e in pool.engines)
    held = {}
    for v in (v1, v2):
        st = _staged(v.pgraph, eng.device)
        held[v.vid] = (st.kinds(), set(st.kinds()) | st._reserved)
    v2_ids = {id(t) for ts in v2.pgraph.tiles.values() for t in ts}
    v1_free = sum(kind_bytes(t, kind) for ts in v1.pgraph.tiles.values()
                  for t in ts for kind in held[1][0]
                  if not (id(t) in v2_ids and kind in held[2][1]))
    v1_own = sum(kind_bytes(t, kind) for jk in patched_tiles(v1)
                 for t in v1.pgraph.tiles[jk] for kind in held[1][0])
    loop = ServeLoop(pool, max_batch=4, max_wait_us=1e9)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    expected = {}
    ops.reset_launches()
    # ---- the cutover stream: counts zeroed above, read below.
    t = time.perf_counter()
    try:
        for i in range(LIVE_STREAM):
            if i in LIVE_CUTS:
                live.cutover(v1 if LIVE_CUTS[i] == 1 else v2)
            rid = f"live#{i}"
            loop.submit(InferenceRequest("b2", live, xs[i % 4],
                                         request_id=rid))
            expected[rid] = (live.active.vid, i % 4)
        resps = loop.drain()
    finally:
        loop.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    for k, n in ops.LAUNCHES.items():
        launches[k] += n
    # ---- end of the cutover stream.
    mem1 = torch.cuda.memory_allocated()
    outs = {r.output.untyped_storage().data_ptr():
            r.output.untyped_storage().nbytes() for r in resps}
    freed = mem0 - (mem1 - sum(outs.values()))
    by_rid = {r.request_id: r for r in resps}
    if sorted(by_rid) != sorted(expected):
        fail(f"live stream: {len(resps)} responses for {len(expected)} "
             "requests")
    for rid, (vid, fi) in expected.items():
        r = by_rid[rid]
        if not r.graph_name.endswith(f"@v{vid}"):
            fail(f"live stream: {rid} admitted on v{vid}, served on "
                 f"{r.graph_name}")
        if not torch.equal(r.output, solo[(vid, fi)]):
            fail(f"live stream: {rid} differs from a solo serve of v{vid}")
    if live.reclaimed != [0, 1] or \
            sum(e.stats.compiles for e in pool.engines) != compiles:
        fail(f"live stream: reclaimed {live.reclaimed}, compiles changed")
    log(f"live stream: {len(resps)} b2@FL requests, cutovers at admissions "
        f"{sorted(LIVE_CUTS)}, served in {wall:.2f} s; none dropped, each "
        "bit-identical to a solo serve of its pinned version; batches "
        + ", ".join(f"{r.request_id}:{r.batch_size}@{r.graph_name}"
                    for r in resps[::4]))
    log(f"live stream: device memory fell {freed} B when v0 and v1 were "
        f"reclaimed (outputs held: {sum(outs.values())} B); v1's copies no "
        f"live version holds: {v1_free} B (v1's own patched tiles: "
        f"{v1_own} B); " + host_rss())
    if freed < v1_free:
        fail(f"live: reclaiming v1 freed {freed} B < its {v1_free} B")
    lg = pool.metrics.snapshot(max_batch=4)["livegraph"]
    log("live metrics: " + json.dumps(lg))
    out["stream"] = {"wall_s": wall, "freed": freed, "v1_free": v1_free,
                     "v1_own_patched": v1_own, "livegraph": lg}

    # ---- v3: a structural delta; the exported bundle verified ---------- #
    t = time.perf_counter()
    v3 = live.apply(structural_delta(np, GraphDelta, v2.as_graph(), 3))
    log(f"live v3: structural delta applied in {time.perf_counter() - t:.2f}"
        f" s: {json.dumps(v3.stats.as_dict())}; {v3.pgraph.n_blocks} blocks")
    nb = -(-v3.n_vertices // geom.n1)
    if not v3.stats.structural_change or \
            not v3.pgraph.n_blocks == nb > v0.pgraph.n_blocks:
        fail(f"live v3: expected a structural change to {nb} blocks")
    x3 = G.random_features(v3.as_graph(), seed=64)
    export = tempfile.mkdtemp(prefix="gagi-export-")
    os.environ["GAGI_EXPORT_DIR"] = export
    c = eng.stats.compiles
    try:
        y3, rec3 = serve(v3, "b2", "b2@FL v3", x3)
    finally:
        del os.environ["GAGI_EXPORT_DIR"]
    out["versions"]["v3"] = rec3
    if rec3["cache_hit"] or eng.stats.compiles != c + 1:
        fail("live v3: expected a cache miss and one compile")
    expect_uploaded(v3, rec3, kinds, "b2@FL v3")
    hold("b2@FL v3", "b2", v3.as_graph(), x3, y3)
    t = time.perf_counter()
    rc = verify_main([export, "--json", os.path.join(export, "r.json")])
    log(f"live: python -m repro_torch.verify over {len(os.listdir(export))-1}"
        f" exported bundle(s): exit {rc} in {time.perf_counter() - t:.2f} s")
    shutil.rmtree(export)
    if rc != 0:
        fail(f"live: repro_torch.verify exited {rc}")

    # ---- densify: a forced-GEMM program rebound after a delta (CO) ------ #
    out["remap_rebind"] = live_remap_rebind(torch, counted)

    log("live: verification times: " + ", ".join(
        f"{label} {s * 1e3:.1f} ms" for label, s in verify_s))
    out["verify_s"] = verify_s
    log(f"live phase launches: {launches}")
    for k in ("gemm", "spdmm", "sddmm", "densify"):
        if not launches[k] > 0:
            fail(f"live: {k} was not launched on the live path")
    del store, live, pool, eng, v0, v1, v2, v3, prog0, prog1, gprog
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def live_remap_rebind(torch, counted):
    """b1 on a live CO graph remapped with force="gemm", then a delta that
    drains the smallest tile and adds an edge to the largest: the rebind
    re-prices only the two patched tiles (the drained one becomes skip),
    the binary differs only in their words, and the rebound program runs
    device-resident and host-streamed with the same bits, within the
    float64 tolerance, on the densify and GEMM kernels."""
    import numpy as np

    from repro_torch.core import graph as G
    from repro_torch.core.isa import HEADER_BYTES, Instr
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.core.passes.remap import _scan_groups
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.livegraph import GraphDelta, GraphVersionStore

    co = G.synthesize("CO").gcn_normalized()
    geom = PartitionConfig(n1=LIVE_REMAP_GEOM[0], n2=LIVE_REMAP_GEOM[1])
    store = GraphVersionStore(co, geometry=geom)
    eng = Engine(geometry=geom, verify=True)
    prog = eng.compile("b1", store.head.as_graph())
    rp0 = eng.remap(prog, force="gemm")
    s0 = store.head.store
    jk_empty = min(s0.edges, key=lambda k: s0.edges[k].n)
    jk_big = max(s0.edges, key=lambda k: s0.edges[k].n)
    d = GraphDelta(co.n_vertices)
    te = s0.edges[jk_empty]
    for u, w in sorted(set(zip(te.src.tolist(), te.dst.tolist()))):
        d.remove_edge(u, w)             # a pair's multi-edges go together
    o = s0.edges[jk_big]
    d.add_edge(int(o.src[0]), int(o.dst[0]), 0.5)
    v1 = store.apply(d)
    patched = set(v1.stats.patched)
    p1 = eng.compile("b1", v1.as_graph())
    rec = p1.manifest["remap"]
    if rec["tiles"][f"{jk_empty[0]}:{jk_empty[1]}"]["mode"] != "skip":
        fail("live remap: the drained tile was not re-priced to skip")
    kept = [jk for jk, e in rec["tiles"].items()
            if jk not in patched and e != rp0.manifest["remap"]["tiles"][jk]]
    words = [np.frombuffer(b, "<u4", offset=HEADER_BYTES).reshape(-1, 4)
             for b in (rp0.binary, p1.binary)]
    owner = {}
    for grp in _scan_groups([Instr.decode(w) for w in words[0]]):
        for idx in (grp.compute, *grp.mem):
            owner[idx] = f"{grp.j}:{grp.k}"
    stray = [r for r in np.nonzero((words[0] != words[1]).any(axis=1))[0]
             if owner.get(int(r)) not in patched]
    if kept or stray:
        fail(f"live remap: untouched tiles re-priced {kept} or words changed "
             f"outside the patched tiles {stray[:4]}")
    x = G.random_features(co, seed=1)
    y = counted(lambda: eng.run(p1, x))
    st = eng.exec_stats
    yh = counted(lambda: eng.run(p1, x, residency="host"))
    if not torch.equal(y, yh):
        fail("live remap: host and device runs of the rebound program "
             "differ")
    worst = hold_against_reference(
        torch, [InferenceRequest("b1", v1.as_graph(), x)],
        [_resp("b1@CO live remap", y)])
    log(f"live remap: b1@CO forced GEMM, rebound after a delta patching "
        f"{sorted(patched)}: counts {rec['counts']}, {st.tiles_remapped} "
        f"GEMM steps and {st.tiles_skipped} skipped a pass, host = device "
        f"bits, max|err| {worst:.3e} against float64")
    return {"patched": sorted(patched), "counts": rec["counts"],
            "tiles_remapped": st.tiles_remapped,
            "tiles_skipped": st.tiles_skipped}


# --------------------------------------------------------------------------- #
MESH_CO_DEVICES = (2, 3, 4)     # virtual shards of the card, b1-b8 on CO
MESH_FL_DEVICES = 4             # b2 and gat-dot on full-scale FL
MESH_LANES = 3                  # run_batch lanes on the mesh
MESH_LIVE_GEOM = (1024, 128)    # live CO on the mesh: 3 x 3 tiles


def mesh_phase(torch, card):
    """The placement-scheduled multi-device path on virtual shards of the
    card (``DeviceMesh([cuda:0] * D)``); see the module docstring.
    Returns (launches of the mesh path, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.core import gnn_builders as TB
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS
    from repro_torch.core.passes.partition import PartitionConfig
    from repro_torch.engine import Engine, InferenceRequest
    from repro_torch.engine.executor import _staged
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh, make_device_mesh
    from repro_torch.livegraph import (GraphDelta, GraphVersionStore,
                                       LiveGraphServer)
    from repro_torch.obs import build_report, tracing
    from repro_torch.verify import check_trace

    out = {"card": card, "co": {}, "fl": {}}
    launches = {k: 0 for k in ops.LAUNCHES}
    eng = Engine()
    dev0 = DeviceMesh([eng.device]).devices[0]      # cuda:<current>

    def mesh(d):
        return DeviceMesh([dev0] * d)

    def counted(fn):
        ops.reset_launches()
        # ---- a run of the mesh path: counts zeroed above, read below.
        y = fn()
        torch.cuda.synchronize()
        got = dict(ops.LAUNCHES)
        # ----
        for k, n in got.items():
            launches[k] += n
        return y, got

    def expect(label, got, want, passes=1):
        for k in ("gemm", "spdmm", "sddmm"):
            if got[k] != passes * want[k]:
                fail(f"mesh {label}: {k} launches {got[k]} != {passes} x "
                     f"{want[k]} tile ops")

    def same(label, got, want):
        if not torch.equal(got, want):
            err = float((got - want).abs().max())
            fail(f"mesh {label}: differs from the device path (max|d| "
                 f"{err:.3e})")

    co = G.synthesize("CO").gcn_normalized()
    fl = G.synthesize("FL").gcn_normalized()
    t0 = time.perf_counter()
    for name in BENCHMARKS:
        prog = eng.compile(name, co, mesh=max(MESH_CO_DEVICES))
        x = G.random_features(co, seed=1)
        y = eng.run(prog, x)
        dev_ops = eng.exec_stats.tile_ops
        rec = {}
        for d in MESH_CO_DEVICES:
            ym, got = counted(lambda: eng.run(prog, x, mesh=mesh(d)))
            st = eng.exec_stats
            same(f"{name}@CO D={d}", ym, y)
            expect(f"{name}@CO D={d}", got, plan_tile_ops(prog))
            if sum(r["tile_ops"] for r in st.per_device) != dev_ops:
                fail(f"mesh {name}@CO D={d}: per-device tile ops "
                     f"{[r['tile_ops'] for r in st.per_device]} do not sum "
                     f"to the device path's {dev_ops}")
            rec[d] = {"halo_gather_bytes": st.halo_gather_bytes,
                      "halo_bytes": st.halo_bytes,
                      "device_imbalance": st.device_imbalance}
        out["co"][name] = rec
    log(f"mesh: b1-b8 on CO at D = {MESH_CO_DEVICES} virtual shards of "
        f"{dev0}, each bit for bit the device path, launches equal to the "
        f"tile ops ({time.perf_counter() - t0:.1f} s)")

    # b2 and gat-dot on full-scale FL at D = 4: a mesh miss (compile and
    # the tile upload) and two hits, then the device path on the same
    # (shared) tiles.
    fl_progs = {}
    for label in ("b2", "gat-dot"):
        model = "b2" if label == "b2" else build_gat_dot(TB, fl)
        x = G.random_features(fl, seed=20)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        prog = eng.compile(model, fl, mesh=MESH_FL_DEVICES)
        t_loc = time.perf_counter() - t0
        fl_progs[label] = (prog, model, x)
        walls, ys, dev_walls = [], [], []
        # The mesh miss, then hits of the two paths in turns (device,
        # mesh, mesh, device, twice), so that both see the same host.
        for which in ("mesh",) + ("device", "mesh", "mesh", "device") * 2:
            t0 = time.perf_counter()
            if which == "mesh":
                ym, got = counted(lambda: eng.run(
                    prog, x, mesh=mesh(MESH_FL_DEVICES)))
                walls.append((time.perf_counter() - t0) * 1e3)
                ys.append(ym)
                st = eng.exec_stats
                expect(f"{label}@FL", got, plan_tile_ops(prog))
                if len(walls) == 1:
                    staged = torch.cuda.memory_allocated() - mem0
            else:
                y = eng.run(prog, x)
                torch.cuda.synchronize()
                dev_walls.append((time.perf_counter() - t0) * 1e3)
                dev_ops = eng.exec_stats.tile_ops
                dev_layers = [r["wall_s"] * 1e3
                              for r in eng.exec_stats.per_layer]
        for i, ym in enumerate(ys):
            same(f"{label}@FL run {i}", ym, y)
        # The device path's staging shares the virtual shards' tile
        # copies: it uploaded its inverse in-degree and nothing else.
        full = _staged(prog.pgraph, eng.device)
        if full.uploaded != full.inv_deg.numel() * 4:
            fail(f"mesh {label}@FL: the device path uploaded "
                 f"{full.uploaded} B beside the shards' copies")
        pl = prog.manifest["placement"]
        if sum(r["tile_ops"] for r in st.per_device) != dev_ops:
            fail(f"mesh {label}@FL: per-device tile ops do not sum to the "
                 f"device path's {dev_ops}")
        if st.halo_bytes != pl["halo_bytes_total"]:
            fail(f"mesh {label}@FL: halo_bytes {st.halo_bytes} != the "
                 f"manifest's {pl['halo_bytes_total']}")
        worst = hold_against_reference(
            torch, [InferenceRequest(model, fl, x)],
            [_resp(f"{label}@FL mesh D={MESH_FL_DEVICES}", ys[-1])])
        layers = [(r["layer"], r["kernel"], r["halo_gather_bytes"],
                   r["wall_s"] * 1e3) for r in st.per_layer]
        log(f"mesh {label}@FL D={MESH_FL_DEVICES}: T_LoC {t_loc:.2f} s; "
            f"mesh passes (the miss, then hits) "
            f"{', '.join(f'{w:.2f}' for w in walls)} ms; device-path hits "
            f"on the same tiles, in turns with the mesh's "
            f"{', '.join(f'{w:.2f}' for w in dev_walls)} ms;"
            f" {staged} B staged by the mesh miss; halo_gather_bytes "
            f"{st.halo_gather_bytes}, halo_bytes (placement estimate) "
            f"{st.halo_bytes}, device_imbalance {st.device_imbalance:.4f}, "
            f"peak_device_bytes {st.peak_device_bytes}; per device "
            f"{st.per_device}; max|err| {worst:.3e} against float64")
        log(f"  mesh {label}@FL per layer of the last mesh hit (id, "
            "kernel, halo_gather_bytes, CUDA-event ms; the last device-path"
            " hit's ms): " + ", ".join(
                f"L{a}:{k}:{b}:{ms:.3f}:{dms:.3f}"
                for (a, k, b, ms), dms in zip(layers, dev_layers)))
        out["fl"][label] = {
            "t_loc_s": t_loc, "mesh_ms": walls, "device_ms": dev_walls,
            "device_layer_ms": dev_layers,
            "staged_bytes": staged,
            "halo_gather_bytes": st.halo_gather_bytes,
            "halo_bytes": st.halo_bytes,
            "device_imbalance": st.device_imbalance,
            "peak_device_bytes": st.peak_device_bytes,
            "per_device": st.per_device, "per_layer": layers,
            "max_abs_err": worst}

    # run_batch of lanes on the mesh, each lane equal to its solo run.
    prog, model, x = fl_progs["b2"]
    xs = np.stack([G.random_features(fl, seed=30 + i)
                   for i in range(MESH_LANES)])
    t0 = time.perf_counter()
    ys, got = counted(lambda: eng.run_batch(prog, xs,
                                            mesh=mesh(MESH_FL_DEVICES)))
    batch_ms = (time.perf_counter() - t0) * 1e3
    expect("b2@FL batch", got, plan_tile_ops(prog), passes=MESH_LANES)
    if eng.exec_stats.runs != 1:
        fail("mesh batch: stats do not merge the lanes into one pass")
    for i in range(MESH_LANES):
        solo, _ = counted(lambda: eng.run(prog, xs[i],
                                          mesh=mesh(MESH_FL_DEVICES)))
        same(f"b2@FL lane {i}", ys[i], solo)
    log(f"mesh: run_batch of {MESH_LANES} b2@FL lanes in {batch_ms:.2f} ms,"
        " each lane bit for bit its solo run")

    # A traced mesh hit: the race detector and the conformance report's
    # halo section (the miss's program carries its source).
    with tracing() as tr:
        counted(lambda: eng.run(prog, x, mesh=mesh(MESH_FL_DEVICES)))
    trace = tr.to_dict()
    rep = check_trace(trace, prog)
    if not rep.ok:
        fail(f"mesh: check_trace over a traced b2@FL hit: "
             f"{rep.to_markdown()}")
    halos = [e for e in trace["traceEvents"]
             if e.get("name") == "halo_exchange"]
    report = build_report(prog, eng.exec_stats, events=tr.events())
    if report.halo is None or report.halo["gathered_bytes"] != \
            eng.exec_stats.halo_gather_bytes:
        fail(f"mesh: build_report's halo section {report.halo}")
    copy_us = [e["args"].get("copy_us") for e in halos]
    log(f"mesh: check_trace over a traced b2@FL hit: 0 violations "
        f"({', '.join(rep.checks_run)} ran); {len(halos)} halo_exchange "
        f"spans, copy_us {copy_us}; build_report halo section "
        f"{report.halo}")
    out["trace"] = {"checks_run": rep.checks_run, "halo_spans": len(halos),
                    "copy_us": copy_us, "halo": report.halo}

    # A forced-GEMM remap of b1 on CO at D = 2 (densify on the mesh).
    rp = eng.remap(eng.compile("b1", co), force="gemm")
    x = G.random_features(co, seed=1)
    y = eng.run(rp, x)
    ym, got = counted(lambda: eng.run(rp, x, mesh=mesh(2)))
    same("remapped b1@CO D=2", ym, y)
    st = eng.exec_stats
    if not (got["densify"] > 0 and got["gemm"] == st.tile_ops_by_mode[
            "gemm"] and st.tiles_remapped == rp.manifest["remap"][
                "remapped_ops"] > 0):
        fail(f"mesh remap: launches {got}, tiles_remapped "
             f"{st.tiles_remapped}")
    log(f"mesh: forced-GEMM b1@CO at D=2: {st.tiles_remapped} GEMM steps, "
        f"launches {got}, bit for bit the device path")
    del eng, rp, fl_progs, prog, model, ys, xs
    gc.collect()
    torch.cuda.empty_cache()

    # A live CO version after a content delta, on the mesh.
    geom = PartitionConfig(n1=MESH_LIVE_GEOM[0], n2=MESH_LIVE_GEOM[1])
    store = GraphVersionStore(co, geometry=geom)
    live = LiveGraphServer(store)
    leng = Engine(geometry=geom, verify=True)
    leng.compile("b2", live, mesh=2)
    d, attempt = live_delta(np, GraphDelta, store.head, seed=5)
    live.apply(d)
    x = G.random_features(co, seed=4)
    prog = leng.compile("b2", live, mesh=2)
    ym, got = counted(lambda: leng.run(prog, x, mesh=mesh(2), graph=live))
    if leng.stats.compiles != 1:
        fail("mesh live: a content delta recompiled")
    g1 = store.head.as_graph()
    cold = Engine(geometry=geom)
    yc = cold.run(cold.compile("b2", dataclasses.replace(g1, name="cold")),
                  x)
    same("live b2@CO v1 D=2 (against a cold compile)", ym, yc)
    worst = hold_against_reference(torch, [InferenceRequest("b2", g1, x)],
                                   [_resp("b2@CO live v1 mesh", ym)])
    log(f"mesh: live CO v1 (content delta, draw {attempt}) on D=2: a cache "
        f"hit, bit for bit a cold compile, max|err| {worst:.3e} against "
        f"float64; launches {got}")
    del leng, cold, live, store

    # Distinct cards, where the machine has them.
    n_cards = torch.cuda.device_count()
    out["distinct_card_runs"] = 0
    if n_cards > 1:
        d = min(MESH_FL_DEVICES, n_cards)
        deng = Engine()
        prog = deng.compile("b2", fl, mesh=d)
        x = G.random_features(fl, seed=20)
        y = deng.run(prog, x)
        ym, _ = counted(lambda: deng.run(prog, x,
                                         mesh=make_device_mesh(d)))
        same(f"b2@FL on {d} distinct cards", ym.to(y.device), y)
        out["distinct_card_runs"] = 1
        del deng, prog
    log(f"mesh: the distinct-card path ran {out['distinct_card_runs']} "
        f"time(s) ({n_cards} card(s) on this machine)")
    log("mesh: launches on the mesh path: " + ", ".join(
        f"{k} {n}" for k, n in launches.items()))
    out["launches"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


# --------------------------------------------------------------------------- #
GRANITE_ARCH = "granite-8b"
GRANITE_B, GRANITE_T = 4, 2048
GRANITE_DECODE_LAYERS = 4       # the fp32 witness: weights near 5 GB


def granite_phase(torch, ops, ref):
    """granite-8b at full width: the flash kernel at its prefill shape
    (GQA group 4), the bf16 prefill of all 36 layers against plain
    attention, the fp32 decode witness at 4 layers, and ``launch.serve``;
    see the module docstring.  Returns (flash launches over the counted
    runs, the flash kernel's row at the granite shape, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.steps import build_model

    cfg = get_config(GRANITE_ARCH)
    g = cfg.n_heads // cfg.n_kv_heads
    bh, kvh, t, d = (GRANITE_B * cfg.n_heads, GRANITE_B * cfg.n_kv_heads,
                     GRANITE_T, cfg.hd)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(bh, t, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(kvh, t, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    name = f"flash granite prefill shape BH={bh} KV heads={kvh} G={g}"
    got = ops.flash_attention(q, k, v, True)
    want = ref.flash_attention_plain(q, k, v, True)
    r_whole, r_row = check_rows(torch, name, got, want)
    err = float((got.float() - want.float()).abs().max())
    del got, want
    t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v, True))
    t_p = median_ms(torch, lambda: ref.flash_attention_plain(q, k, v, True),
                    reps=3, launches=3)
    lib, how = sdpa_yardstick(torch, q, k, v)
    t_l = median_ms(torch, lib)
    b_ms, b_by = flash_bound(bh, t, t, d, True, 2, PEAK_BF16_FLOP_S,
                             kv_heads=kvh)
    log(f"kernel flash_attention {name} T={t} d={d} causal bf16: kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, F.scaled_dot_product_attention "
        f"({how}) {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}); relative L2 "
        f"{r_whole:.3e} whole, {r_row:.3e} worst row, max|err| {err:.2e}")
    flash_row = {"shape": f"BH={bh} over {kvh} KV heads, T={t}, d={d}, "
                          "bf16, causal", "max_abs_err": err, "ms": t_k,
                 "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": t_l, "rel_l2_whole": r_whole,
                 "rel_l2_worst_row": r_row}
    del q, k, v
    torch.cuda.empty_cache()

    n_flash, pre = lm_prefill(torch, ops, ref, cfg, GRANITE_B, GRANITE_T,
                              seed=1, timed=2)
    rng = np.random.default_rng(2)

    # fp32 decode against forward at full width, 4 layers.
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=GRANITE_DECODE_LAYERS)
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (DECODE_B, DECODE_T)
                                        ).astype(np.int32), device="cuda")
    ops.reset_launches()
    # ---- the granite forward run: counts zeroed above, read below.
    fwd, _ = model(toks)
    torch.cuda.synchronize()
    fwd_launches = ops.LAUNCHES["flash_attention"]
    # ---- end of the granite forward run.
    if fwd_launches != cfg32.n_layers:
        fail(f"granite forward: flash launches {fwd_launches} != "
             f"{cfg32.n_layers}")
    cache = model.init_cache(DECODE_B, DECODE_T)
    worst, scale = 0.0, float(fwd.abs().max())
    t0 = time.perf_counter()
    for i in range(DECODE_T):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        worst = max(worst, float((lg[:, 0] - fwd[:, i]).abs().max()))
    log(f"granite decode against forward, fp32, {cfg32.n_layers} layers, "
        f"B={DECODE_B} T={DECODE_T}: max |decode - forward| / max |forward|"
        f" = {worst / scale:.3e} (limit {DECODE_TOL}; "
        f"{time.perf_counter() - t0:.2f} s)")
    if not worst / scale < DECODE_TOL:
        fail(f"granite decode differs from forward by {worst / scale:.3e}")
    del model, fwd, cache, lg
    gc.collect()
    torch.cuda.empty_cache()

    # The serving loop at granite-8b: 4 requests of 16 tokens.
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", GRANITE_ARCH, "--requests", "4",
                         "--prompt-len", "16", "--gen", "16"])
    drv_s = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"serve granite: {line}")
    m = re.search(r"prefill: ([\d.]+) ms\s+decode: ([\d.]+) ms \(([\d.]+) "
                  r"ms/token\)", text)
    gens = re.findall(r"^\s+\[([\d, ]+)\]$", text, re.M)
    if rc != 0 or m is None or len(gens) != 3 or any(
            len(x.split(",")) != 16 for x in gens):
        fail(f"launch.serve --arch {GRANITE_ARCH}: exit {rc}, output not "
             "as expected")
    log(f"launch.serve granite-8b: prefill {m.group(1)} ms, decode "
        f"{m.group(3)} ms/token, {drv_s:.2f} s with the build")
    gc.collect()
    torch.cuda.empty_cache()
    summary = {**pre, "decode_vs_forward": worst / scale,
               "serve_prefill_ms": float(m.group(1)),
               "serve_decode_ms_per_token": float(m.group(3)),
               "flash_granite_shape": flash_row}
    return n_flash + fwd_launches, flash_row, summary


GEMMA_ARCH, GEMMA_27B = "gemma3-12b", "gemma3-27b"
GEMMA_B, GEMMA_T = 4, 2048
GEMMA_DECODE_LAYERS = 6         # one superblock: 5 windowed, 1 global
GEMMA_DECODE_T = 1088           # past the window of 1024: the rings wrap
GEMMA_27B_LAYERS = 8            # the 2-layer rem segment + a superblock


def lm_prefill(torch, ops, ref, cfg, b, t, seed, timed, profile=False):
    """A bf16 prefill of ``cfg`` at b x t (tokens from numpy ``seed``)
    with random weights from seed 0: a warm-up and ``timed`` timed runs
    with the flash launches counted from zero, the last-position logits
    within LM_REL_L2 of the same model with plain attention, and with
    ``profile`` one more prefill under ``torch.profiler``.  Returns (flash
    launches, summary)."""
    import numpy as np

    from repro_torch.models.steps import build_model, make_prefill_step

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    w_bytes = torch.cuda.memory_allocated() - base
    log(f"{cfg.name} ({cfg.n_layers} layers): {n_par:,} parameters, "
        f"{w_bytes / 2**30:.2f} GiB in {cfg.dtype}, built from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, t)).astype(np.int32), device="cuda")
    prefill = make_prefill_step(model, cfg)
    batch = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the prefill path: counts zeroed above, read below.
    walls = []
    for _ in range(1 + timed):               # a warm-up, then the timed
        t0 = time.perf_counter()
        logits = prefill(model, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n_flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the prefill path.
    if n_flash != cfg.n_layers * len(walls):
        fail(f"{cfg.name}: flash launches {n_flash} over {len(walls)} "
             f"prefills != {cfg.n_layers} per prefill")
    if tuple(logits.shape) != (b, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{cfg.name} prefill logits: shape {tuple(logits.shape)} or "
             "non-finite")
    with attention_as(ops, ref.flash_attention_plain):
        want = prefill(model, batch)
    got32, want32 = logits.float(), want.float()
    rel = float((got32 - want32).norm() / want32.norm())
    agree = float((got32.argmax(-1) == want32.argmax(-1)).float().mean())
    med = statistics.median(walls[1:])
    flops = 2.0 * cfg.n_params() * b * t
    log(f"{cfg.name} prefill {b}x{t}: wall ms "
        f"{[round(w, 2) for w in walls]} (first is the warm-up), median "
        f"{med:.2f} ms, {b * t / med * 1e3:,.0f} tokens/s "
        f"({flops:.3e} flops of weight products); peak memory "
        f"{peak / 2**30:.3f} GiB (weights included); flash launches "
        f"{n_flash}; logits against plain attention: relative L2 "
        f"{rel:.3e} (limit {LM_REL_L2}), argmax agreement {agree:.3f}")
    if not rel <= LM_REL_L2:
        fail(f"{cfg.name} prefill logits differ from plain attention by "
             f"relative L2 {rel:.3e}")
    flash_dev = None
    if profile:
        by_name = profile_call(torch, lambda: prefill(model, batch),
                               f"{cfg.name} prefill {b}x{t}")
        if by_name:
            flash_dev = sum(ms for n, ms in by_name.items()
                            if "flash_bf16_kernel" in n)
            dev = sum(by_name.values())
            log(f"{cfg.name}: flash kernel device time in the profiled "
                f"prefill {flash_dev:.3f} ms of {dev:.3f} ms of device time "
                f"({100 * flash_dev / dev:.1f}%); device time over the "
                f"unprofiled median wall: {100 * dev / med:.1f}%")
    del model, logits, want, prefill, got32, want32
    gc.collect()
    torch.cuda.empty_cache()
    return n_flash, {"params": n_par, "weight_bytes": w_bytes,
                     "prefill_ms": walls, "prefill_median_ms": med,
                     "tokens_per_s": b * t / med * 1e3,
                     "weight_product_flops": flops,
                     "prefill_peak_bytes": peak, "prefill_rel_l2": rel,
                     "prefill_argmax_agreement": agree,
                     "flash_device_ms_in_profiled_prefill": flash_dev}


def gemma3_phase(torch, ops, ref):
    """gemma3-12b at full width (48 layers: 40 windowed of 1024, 8 global,
    d = 240) prefilled in bf16 against plain attention; its fp32 decode
    against forward at 6 layers past the window (ring buffers wrap);
    ``launch.serve --arch gemma3-12b``; gemma3-27b (d = 168) at 8 layers
    against plain attention.  Returns (flash launches over the counted
    runs, a summary)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.steps import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(GEMMA_ARCH)
    n12, s12 = lm_prefill(torch, ops, ref, cfg, GEMMA_B, GEMMA_T, seed=1,
                          timed=2, profile=True)

    # fp32 decode against forward at full width, one superblock, past the
    # window: every local layer's ring buffer of 1024 slots wraps.
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=GEMMA_DECODE_LAYERS)
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (DECODE_B, GEMMA_DECODE_T)).astype(np.int32),
        device="cuda")
    ops.reset_launches()
    # ---- the gemma3 forward run: counts zeroed above, read below.
    fwd, _ = model(toks)
    torch.cuda.synchronize()
    fwd_launches = ops.LAUNCHES["flash_attention"]
    # ---- end of the gemma3 forward run.
    if fwd_launches != cfg32.n_layers:
        fail(f"gemma3 forward: flash launches {fwd_launches} != "
             f"{cfg32.n_layers}")
    cache = model.init_cache(DECODE_B, GEMMA_DECODE_T)
    slots = sorted({lc["k"].shape[1] for lc in cache})
    if slots != [cfg.local_window, GEMMA_DECODE_T]:
        fail(f"gemma3 cache slots {slots}, expected ring buffers of "
             f"{cfg.local_window} and full caches of {GEMMA_DECODE_T}")
    t0 = time.perf_counter()
    errs = []
    for i in range(GEMMA_DECODE_T):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        errs.append((lg[:, 0] - fwd[:, i]).abs().amax())
    worst = float(torch.stack(errs).max()) / float(fwd.abs().max())
    dec_s = time.perf_counter() - t0
    log(f"gemma3 decode against forward, fp32, {cfg32.n_layers} layers, "
        f"B={DECODE_B} T={GEMMA_DECODE_T} (rings of {cfg.local_window} "
        f"slots wrap): max |decode - forward| / max |forward| = "
        f"{worst:.3e} (limit {DECODE_TOL}; {dec_s:.2f} s)")
    if not worst < DECODE_TOL:
        fail(f"gemma3 decode differs from forward by {worst:.3e}")
    del model, fwd, cache, lg, errs
    gc.collect()
    torch.cuda.empty_cache()

    # The serving loop at gemma3-12b: 4 requests of 16 tokens.
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", GEMMA_ARCH, "--requests", "4",
                         "--prompt-len", "16", "--gen", "16"])
    drv_s = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"serve gemma3: {line}")
    m = re.search(r"prefill: ([\d.]+) ms\s+decode: ([\d.]+) ms \(([\d.]+) "
                  r"ms/token\)", text)
    gens = re.findall(r"^\s+\[([\d, ]+)\]$", text, re.M)
    if rc != 0 or m is None or len(gens) != 3 or any(
            len(x.split(",")) != 16 for x in gens):
        fail(f"launch.serve --arch {GEMMA_ARCH}: exit {rc}, output not as "
             "expected")
    log(f"launch.serve gemma3-12b: prefill {m.group(1)} ms, decode "
        f"{m.group(3)} ms/token, {drv_s:.2f} s in all")
    gc.collect()
    torch.cuda.empty_cache()

    cfg27 = dataclasses.replace(get_config(GEMMA_27B),
                                n_layers=GEMMA_27B_LAYERS)
    n27, s27 = lm_prefill(torch, ops, ref, cfg27, GEMMA_B, GEMMA_T, seed=3,
                          timed=1)
    return n12 + fwd_launches + n27, {
        "gemma3_12b": s12, "gemma3_27b_8_layers": s27,
        "decode_vs_forward": worst, "decode_s": dec_s,
        "serve_prefill_ms": float(m.group(1)),
        "serve_decode_ms_per_token": float(m.group(3))}


# --------------------------------------------------------------------------- #
TRAIN_ARCH, TRAIN_B, TRAIN_T, TRAIN_STEPS = "qwen3-0.6b", 2, 4096, 10
TRAIN_GRAD_REL = 2e-2           # bf16 step 1, kernel route against plain
TRAIN_GRAD_REL32 = 1e-4         # fp32, 2 layers


@contextlib.contextmanager
def plain_attention_route():
    """While open, the LM's flash route is autograd through
    ``flash_attention_plain``, checkpointed per call (its [BH, T, T]
    scores are recomputed in the backward instead of kept for every
    layer): the plain route the train step's gradients are held to."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels import ref
    from repro_torch.models import attention as A

    class Plain:
        @staticmethod
        def apply(q, k, v, window):
            return checkpoint(ref.flash_attention_plain, q, k, v, True,
                              window, use_reentrant=False)

    real = A._FlashAttention
    A._FlashAttention = Plain
    try:
        yield
    finally:
        A._FlashAttention = real


def grads_against_plain(torch, model, cfg, batch, limit, label):
    """The loss and every gradient of ``steps.value_and_grad`` through
    the kernel route and the plain route, held within relative L2
    ``limit``; returns (loss, plain loss, worst gradient's relative L2,
    its name)."""
    from repro_torch.models.steps import value_and_grad

    _, loss, _, grads = value_and_grad(model, cfg, batch)
    with plain_attention_route():
        _, ploss, _, pgrads = value_and_grad(model, cfg, batch)
    torch.cuda.synchronize()
    rel_loss = abs(float(loss) - float(ploss)) / abs(float(ploss))
    worst, worst_name = 0.0, ""
    for name, g in grads.items():
        pg = pgrads[name].float()
        if not bool(torch.isfinite(g).all()):
            fail(f"{label}: gradient {name} not finite")
        rel = float((g.float() - pg).norm() / pg.norm().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    log(f"{label}: loss {float(loss):.6f} (plain route {float(ploss):.6f}, "
        f"relative {rel_loss:.3e}); worst gradient relative L2 {worst:.3e} "
        f"({worst_name}; limit {limit}) over {len(grads)} gradients")
    if not (rel_loss <= limit and worst <= limit):
        fail(f"{label}: kernel route differs from the plain route (loss "
             f"{rel_loss:.3e}, gradient {worst_name} {worst:.3e})")
    return float(loss), float(ploss), worst, worst_name


def train_phase(torch, ops, ref):
    """qwen3-0.6b at full width trained in bf16 at B=2, T=4096: step 1's
    loss and gradients against the plain route, the same in fp32 at 2
    layers, 10 timed steps of ``make_train_step`` on
    ``synthetic_batches``, a checkpoint round trip of the train state on
    the card, and ``launch.train`` crashed at step 4 and resumed from its
    own checkpoint.  Returns (flash launches over the counted steps, a
    summary)."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.models.steps import (build_model, init_train_state,
                                          make_train_step)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    it = synthetic_batches(cfg, TRAIN_B, TRAIN_T, seed=0)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in next(it).items()} for _ in range(TRAIN_STEPS)]

    # fp32 at full width, 2 layers: kernel route against plain.
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    m32, _ = init_train_state(build_model(cfg32, seed=0))
    r32 = grads_against_plain(torch, m32, cfg32, batches[0],
                              TRAIN_GRAD_REL32, "train fp32, 2 layers")
    del m32
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model, opt = init_train_state(build_model(cfg, seed=0))
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated() - base
    n_par = sum(p.numel() for p in model.parameters())
    log(f"train {cfg.name}: {n_par:,} parameters in {cfg.dtype}, params + "
        f"fp32 master, mu and nu {state_bytes / 2**30:.3f} GiB")
    r16 = grads_against_plain(torch, model, cfg, batches[0],
                              TRAIN_GRAD_REL, "train bf16 step 1")
    step = make_train_step(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the train path: counts zeroed above, read below.
    walls, losses = [], []
    for b in batches:
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    n_flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the train path.
    if n_flash != cfg.n_layers * TRAIN_STEPS:
        fail(f"train: flash launches {n_flash} over {TRAIN_STEPS} steps != "
             f"{cfg.n_layers} per step")
    if not all(math.isfinite(x) for x in losses) or int(opt.step) != \
            TRAIN_STEPS:
        fail(f"train: losses {losses}, step {int(opt.step)}")
    med = statistics.median(walls[1:])
    tok = TRAIN_B * TRAIN_T
    log(f"train {cfg.name} B={TRAIN_B} T={TRAIN_T} bf16: step wall ms "
        f"{[round(w, 2) for w in walls]} (first is the warm-up), median "
        f"{med:.2f} ms, {tok / med * 1e3:,.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB (state included); flash launches "
        f"{n_flash}; losses {[round(x, 4) for x in losses]}")
    by_name = profile_call(torch, lambda: step(model, opt, batches[0]),
                           f"train step {TRAIN_B}x{TRAIN_T}")
    flash_dev = None
    b_ms, b_by = flash_bound(TRAIN_B * cfg.n_heads, TRAIN_T, TRAIN_T, cfg.hd,
                             True, 2, PEAK_BF16_FLOP_S,
                             kv_heads=TRAIN_B * cfg.n_kv_heads)
    if by_name:
        flash_dev = sum(ms for n, ms in by_name.items()
                        if "flash_bf16_kernel" in n)
        dev = sum(by_name.values())
        log(f"train: flash kernel device time in the profiled step "
            f"{flash_dev:.3f} ms of {dev:.3f} ms of device time, "
            f"{flash_dev / cfg.n_layers:.4f} ms a call against a bound of "
            f"{b_ms:.4f} ms ({b_by})")

    # Checkpoint round trip of the whole train state on the card.
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        save(ck, int(opt.step), (model, opt), meta={"loss": losses[-1]})
        save_s = time.perf_counter() - t0
        fresh, fopt = init_train_state(build_model(cfg, seed=1))
        t0 = time.perf_counter()
        (fresh, fopt), got_step, meta = restore(ck, (fresh, fopt))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same = got_step == int(fopt.step) == int(opt.step) and all(
            torch.equal(a, b) for a, b in zip(
                model.state_dict().values(), fresh.state_dict().values()))
        for n in opt.mu:
            same = same and torch.equal(opt.mu[n], fopt.mu[n]) and \
                torch.equal(opt.nu[n], fopt.nu[n]) and \
                torch.equal(opt.master[n], fopt.master[n])
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(ck) for f in fs)
    log(f"checkpoint of the train state: {nbytes:,} bytes, save "
        f"{save_s:.2f} s, restore onto the card {restore_s:.2f} s, bit for "
        f"bit: {same}")
    if not same or fresh.embed.device != model.embed.device:
        fail("checkpoint round trip of the train state is not bit for bit")
    del model, opt, fresh, fopt, batches
    gc.collect()
    torch.cuda.empty_cache()

    # launch.train, crashed after step 4 and resumed from its checkpoint.
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    with tempfile.TemporaryDirectory() as ck:
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                TRAIN_ARCH, "--steps", "5", "--batch", str(TRAIN_B), "--seq",
                str(TRAIN_T), "--log-every", "1", "--ckpt-dir", ck,
                "--ckpt-every", "3", "--resume", "auto"]
        t0 = time.perf_counter()
        r1 = subprocess.run(args + ["--crash-at", "4"], env=env,
                            capture_output=True, text=True, timeout=600)
        r2 = subprocess.run(args, env=env, capture_output=True, text=True,
                            timeout=600)
        drv_s = time.perf_counter() - t0
        last = latest_step(ck)
    for line in (r1.stdout + r2.stdout).splitlines():
        log(f"launch.train: {line}")
    if (r1.returncode != 42 or r2.returncode != 0 or last != 3
            or "[resume] restored step 3" not in r2.stdout
            or "done: 5 steps" not in r2.stdout):
        fail(f"launch.train crash / resume: exits {r1.returncode}, "
             f"{r2.returncode}, latest step {last}:\n{r1.stderr[-2000:]}"
             f"\n{r2.stderr[-2000:]}")
    log(f"launch.train --arch {TRAIN_ARCH} --batch {TRAIN_B} --seq "
        f"{TRAIN_T}: crashed after step 4 (exit 42), resumed from step 3, "
        f"done at 5; {drv_s:.2f} s for both processes")
    return n_flash, {
        "params": n_par, "state_bytes": state_bytes, "step_ms": walls,
        "step_median_ms": med, "tokens_per_s": tok / med * 1e3,
        "peak_bytes": peak, "losses": losses,
        "flash_device_ms_in_profiled_step": flash_dev,
        "flash_bound_ms": b_ms,
        "step1_bf16": {"loss": r16[0], "plain_loss": r16[1],
                       "worst_grad_rel_l2": r16[2], "worst_grad": r16[3]},
        "fp32_2_layers": {"loss": r32[0], "plain_loss": r32[1],
                          "worst_grad_rel_l2": r32[2],
                          "worst_grad": r32[3]},
        "checkpoint": {"bytes": nbytes, "save_s": save_s,
                       "restore_s": restore_s},
        "launch_train_s": drv_s}


# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def attention_as(ops, fn):
    """While open, ``ops.flash_attention`` is ``fn``: the check's own
    reference runs of the model (no launch is counted)."""
    real = ops.flash_attention
    ops.flash_attention = fn
    try:
        yield
    finally:
        ops.flash_attention = real


def chunked_attention(q, k, v, causal=True, window=0, chunk=256):
    """``ops.flash_attention``'s function through the port's
    ``_sdpa_chunked``, which rounds P to the value dtype for the P.V
    product as the kernel's bf16 body (and JAX) do: a run of the model
    with this attention shows what that rounding alone does to the
    logits."""
    import torch

    from repro_torch.models.attention import _sdpa_chunked
    t, d = q.shape[1], q.shape[2]
    pos = torch.arange(t, device=q.device)
    o = _sdpa_chunked(*(x.transpose(0, 1)[None] for x in (q, k, v)), pos,
                      pos, causal, window, d ** -0.5, chunk)
    return o[0].transpose(0, 1).contiguous()


def flash_bound(bh, tq, tk, d, causal, elem_bytes, peak_flop_s,
                kv_heads=None, window=0):
    """Bytes: q, k, v read once (k / v over ``kv_heads`` heads, bh when
    None), out written once; operations: 4 d flops (two products) per
    (query, key) pair the mask keeps (under a window W, query i keeps
    keys max(0, i - W + 1) .. i)."""
    kv = bh if kv_heads is None else kv_heads
    if causal:
        pairs = sum(min(tk, i + 1) - (max(0, i - window + 1) if window
                                      else 0) for i in range(tq))
    else:
        pairs = tq * tk
    return bound_ms(elem_bytes * d * (2 * bh * tq + 2 * kv * tk),
                    4.0 * d * bh * pairs, peak_flop_s)


def sdpa_yardstick(torch, q, k, v, window=0):
    """``F.scaled_dot_product_attention`` (causal; under a window W with
    a boolean ``attn_mask`` holding ``0 <= qpos - kpos < W``) on the
    kernel's operands, k / v with one head per G query heads:
    ``enable_gqa=True`` where the installed torch takes it (2.5 on), else
    on heads repeated G times.  Returns (the call, how grouped heads and
    the mask were passed)."""
    import torch.nn.functional as F
    g = q.shape[0] // k.shape[0]
    q4, k4, v4 = q[None], k[None], v[None]
    kw, how = {"is_causal": True}, ""
    if window:
        t = q.shape[1]
        dif = (torch.arange(t, device=q.device)[:, None]
               - torch.arange(k.shape[1], device=q.device)[None, :])
        kw = {"attn_mask": (dif >= 0) & (dif < window)}
        how = ", boolean attn_mask"
    if g == 1:
        return (lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw)), \
            "one KV head per query head" + how
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True, **kw)), "enable_gqa=True" + how
    kr, vr = (x.repeat_interleave(g, dim=0)[None] for x in (k, v))
    return (lambda: F.scaled_dot_product_attention(q4, kr, vr, **kw)), \
        "KV heads repeated (no enable_gqa)" + how


def flash_kernel_phase(torch, ops, ref):
    """The flash kernel against its plain version on the JAX sweep, its
    bf16 case, ragged and grouped-head cases, gemma3's head dims and
    sliding windows, and the path shape; returns the kernels-line entry
    (the path shape in bf16 with qwen3-0.6b's grouped KV heads, as the
    prefill calls it), the path-shape readings and the rows of gemma3's
    prefill shape."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def qkv(bh, tq, tk, d, dtype, g=1):
        return [torch.randn(n, t, d, generator=gen, device="cuda"
                            ).to(dtype)
                for n, t in ((bh, tq), (bh // g, tk), (bh // g, tk))]

    cases = [(tq, tk, h, d, c, torch.float32, 1)
             for tq, tk, h, d, c in FLASH_SHAPES]
    cases += [(128, 128, 2, 64, True, torch.bfloat16, 1),
              (200, 200, 3, 128, True, torch.float32, 1),
              (200, 200, 3, 128, True, torch.bfloat16, 1)]
    cases += [(tq, tk, h, d, c, dt, g) for tq, tk, h, d, c, dt, g in (
        (128, 128, 4, 64, True, torch.bfloat16, 2),
        (200, 200, 8, 128, True, torch.bfloat16, 8),
        (77, 130, 4, 40, False, torch.bfloat16, 2),
        (256, 128, 4, 128, True, torch.float32, 2),
        (200, 200, 8, 128, True, torch.float32, 8))]
    for tq, tk, h, d, causal, dt, g in cases:
        q, k, v = qkv(h, tq, tk, d, dt, g)
        tol = ((0.0, FLASH_ATOL) if dt == torch.float32
               else (FLASH_BF16_TOL, FLASH_BF16_TOL))
        name = f"flash {tq}x{tk} h={h} G={g} d={d} causal={causal} {dt}"
        got = ops.flash_attention(q, k, v, causal)
        want = ref.flash_attention_plain(q, k, v, causal)
        check_close(torch, name, got, want, *tol)
        if dt == torch.bfloat16:
            r_whole, r_row = check_rows(torch, name, got, want)
            log(f"{name}: relative L2 {r_whole:.3e} whole, {r_row:.3e} "
                "worst row")
    log(f"flash: {len(cases)} sweep / bf16 / ragged / grouped-head cases "
        "within tolerance")
    n_wide = flash_window_cases(torch, ops, ref, qkv)
    log(f"flash: {n_wide} wide-head / sliding-window cases within "
        "tolerance")

    # qwen3-0.6b prefill heads at B=4: 64 query heads of 128 over 32 KV
    # heads (G=2, the layout the prefill passes), and the same call with
    # one KV head per query head (the layout before grouped heads were
    # read in the kernel), in bf16 and fp32.
    bh, t, d = LM_B * 16, LM_T, 128
    entry, path_rel = None, {}
    for dt in (torch.bfloat16, torch.float32):
        bf16 = dt == torch.bfloat16
        for g in (2, 1):
            q, k, v = qkv(bh, t, t, d, dt, g)
            name = f"flash path shape {str(dt)[6:]} G={g}"
            got = ops.flash_attention(q, k, v, True)
            want = ref.flash_attention_plain(q, k, v, True)
            if bf16:
                # Late rows average ~i keys, so their values are ~0.03 and
                # an elementwise 3e-2 would not see a dropped KV tile there.
                r_whole, r_row = check_rows(torch, name, got, want)
                err = float((got.float() - want.float()).abs().max())
                log(f"{name}: relative L2 {r_whole:.3e} whole (limit "
                    f"{FLASH_BF16_WHOLE:.3e}), {r_row:.3e} worst row (limit "
                    f"{FLASH_BF16_ROW:.3e}), max|err| {err:.3e}")
                path_rel[f"G={g}"] = {"whole": r_whole, "worst_row": r_row}
            else:
                err = check_close(torch, name, got, want, 0.0, FLASH_ATOL)
            del got, want
            t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                               True))
            t_p = median_ms(torch, lambda: ref.flash_attention_plain(
                q, k, v, True), reps=3, launches=5)
            lib, how = sdpa_yardstick(torch, q, k, v)
            t_l = median_ms(torch, lib)
            b_ms, b_by = flash_bound(bh, t, t, d, True, 2 if bf16 else 4,
                                     PEAK_BF16_FLOP_S if bf16
                                     else PEAK_FP32_FLOP_S, kv_heads=bh // g)
            log(f"kernel flash_attention BH={bh} KV heads={bh // g} T={t} "
                f"d={d} causal {dt}: kernel {t_k:.4f} ms, plain {t_p:.4f} "
                f"ms, F.scaled_dot_product_attention ({how}) {t_l:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), max|err| {err:.2e}")
            path_rel.setdefault("ms", {})[f"{str(dt)[6:]} G={g}"] = {
                "kernel": t_k, "plain": t_p, "sdpa": t_l, "bound": b_ms}
            if entry is None:
                entry = {"name": "flash_attention", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                         "replaces": "src/repro/kernels/flash_attention.py"
                                     ":26",
                         "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": t_l}
            del q, k, v
    return entry, path_rel, flash_gemma3_rows(torch, ops, ref, qkv)


# gemma3's head dims (168: gemma3-27b, 240: gemma3-12b, 256: the widest the
# kernel takes) and windows (1, 5, 64, gemma3's 1024, and >= T: none);
# (T, heads, G, d, window).  T is ragged against both bodies' tiles; 100
# and 1000 end inside a KV tile.
FLASH_WIDE_CASES = [(T, h, g, d, w)
                    for d in (168, 240, 256)
                    for T, h, g, w in ((300, 4, 2, 0), (300, 4, 2, 1),
                                       (300, 4, 1, 5), (300, 4, 2, 64),
                                       (1300, 2, 2, 1024),
                                       (300, 2, 1, 1024))]
FLASH_WINDOW_CASES = [(250, 4, 2, 128, 100), (1100, 2, 1, 64, 1000),
                      (77, 2, 2, 40, 3)]


def flash_window_cases(torch, ops, ref, qkv):
    """The kernel at gemma3's head dims and under sliding windows, fp32
    at atol 2e-5 and bf16 under ``check_rows``; returns the case count."""
    n = 0
    for T, h, g, d, w in FLASH_WIDE_CASES + FLASH_WINDOW_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(h, T, T, d, dt, g)
            name = f"flash {T}x{T} h={h} G={g} d={d} window={w} {dt}"
            got = ops.flash_attention(q, k, v, True, w)
            want = ref.flash_attention_plain(q, k, v, True, w)
            if dt == torch.float32:
                check_close(torch, name, got, want, 0.0, FLASH_ATOL)
            else:
                check_rows(torch, name, got, want)
            if not torch.equal(ops.flash_attention(q, k, v, True, w), got):
                fail(f"{name}: two launches differ")
            n += 1
    return n


GEMMA_FLASH_WINDOW = 1024


def flash_gemma3_rows(torch, ops, ref, qkv):
    """The kernel at gemma3-12b's prefill shape (B=4: 64 query heads of
    240 over 32 KV heads, T=2048, bf16, causal), without and with its
    local layers' window of 1024, timed beside the plain version and SDPA
    with the bound; returns a row per window."""
    bh, t, d = LM_B * 16, LM_T, 240
    q, k, v = qkv(bh, t, t, d, torch.bfloat16, 2)
    rows = {}
    for w in (0, GEMMA_FLASH_WINDOW):
        name = f"flash gemma3-12b prefill shape window={w}"
        got = ops.flash_attention(q, k, v, True, w)
        want = ref.flash_attention_plain(q, k, v, True, w)
        r_whole, r_row = check_rows(torch, name, got, want)
        err = float((got.float() - want.float()).abs().max())
        del got, want
        t_k = median_ms(torch, lambda: ops.flash_attention(q, k, v, True, w))
        t_p = median_ms(torch, lambda: ref.flash_attention_plain(
            q, k, v, True, w), reps=3, launches=3)
        lib, how = sdpa_yardstick(torch, q, k, v, w)
        t_l = median_ms(torch, lib)
        b_ms, b_by = flash_bound(bh, t, t, d, True, 2, PEAK_BF16_FLOP_S,
                                 kv_heads=bh // 2, window=w)
        log(f"kernel flash_attention BH={bh} KV heads={bh // 2} T={t} d={d} "
            f"causal window={w} bf16: kernel {t_k:.4f} ms, plain {t_p:.4f} "
            f"ms, F.scaled_dot_product_attention ({how}) {t_l:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); relative L2 {r_whole:.3e} "
            f"whole, {r_row:.3e} worst row, max|err| {err:.2e}")
        rows[f"window={w}"] = {
            "shape": f"BH={bh} over {bh // 2} KV heads, T={t}, d={d}, bf16,"
                     f" causal, window {w}", "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": t_l, "library": how, "rel_l2_whole": r_whole,
            "rel_l2_worst_row": r_row}
    return rows


def lm_phase(torch, ops, ref):
    """qwen3-0.6b prefill (bf16, B=4, T=2048), fp32 decode against
    forward, and ``launch.serve``; see the module docstring.  Returns
    (flash launches over the counted runs, a summary dict)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.steps import (build_model, make_prefill_step,
                                          make_serve_step)

    cfg = get_config(LM_ARCH)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()     # the GNN phases' state
    t0 = time.perf_counter()
    model = build_model(cfg, seed=0)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {n_par:,} parameters ({cfg.n_params():,} in "
        f"matrices) in {cfg.dtype}, built from seed 0 in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_B, LM_T)).astype(
        np.int32), device="cuda")
    prefill = make_prefill_step(model, cfg)
    batch = {"tokens": tokens}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    # ---- the prefill path: counts are zeroed just above, read below.
    walls = []
    for _ in range(4):                       # a warm-up, then 3 timed
        t0 = time.perf_counter()
        logits = prefill(model, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    # ---- end of the prefill path.
    n_prefill = len(walls)
    if launches["flash_attention"] != cfg.n_layers * n_prefill:
        fail(f"flash launches {launches['flash_attention']} over "
             f"{n_prefill} prefills != {cfg.n_layers} per prefill")
    if tuple(logits.shape) != (LM_B, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        fail(f"prefill logits: shape {tuple(logits.shape)} or non-finite")
    with attention_as(ops, ref.flash_attention_plain):
        want = prefill(model, batch)
    with attention_as(ops, chunked_attention):
        wit = prefill(model, batch)
    got32, want32 = logits.float(), want.float()
    rel = float((got32 - want32).norm() / want32.norm())
    rel_wit = float((wit.float() - want32).norm() / want32.norm())
    agree = float((got32.argmax(-1) == want32.argmax(-1)).float().mean())
    prefill_ms = statistics.median(walls[1:])
    log(f"prefill {LM_B}x{LM_T}: wall ms {[round(w, 2) for w in walls]} "
        f"(first is the warm-up), median {prefill_ms:.2f} ms, "
        f"{LM_B * LM_T / prefill_ms * 1e3:,.0f} tokens/s; peak memory "
        f"{peak / 2**30:.3f} GiB over the {base / 2**30:.3f} GiB the "
        f"earlier phases hold (weights included, max_memory_allocated); "
        f"flash launches {launches['flash_attention']}")
    log(f"prefill logits against plain attention: relative L2 {rel:.3e} "
        f"(limit {LM_REL_L2}), argmax agreement {agree:.3f}; the same "
        f"model with _sdpa_chunked attention (P rounded to bf16, no "
        f"kernel) reads {rel_wit:.3e}")
    if not rel <= LM_REL_L2:
        fail(f"prefill logits differ from plain attention by relative L2 "
             f"{rel:.3e}")
    by_name = profile_call(torch, lambda: prefill(model, batch),
                           f"prefill {LM_B}x{LM_T}")
    flash_dev = None
    if by_name:
        flash_dev = sum(ms for n, ms in by_name.items()
                        if "flash_bf16_kernel" in n)
        dev = sum(by_name.values())
        log(f"flash kernel device time in the profiled prefill: "
            f"{flash_dev:.3f} ms of {dev:.3f} ms of device time "
            f"({100 * flash_dev / dev:.1f}%); device time over the "
            f"unprofiled median wall: {100 * dev / prefill_ms:.1f}%")
    # One decode step at launch.serve's shape (8 requests, a 48-slot
    # cache) under the profiler: device events and busy share of a step.
    step = make_serve_step(model, cfg)
    cache = model.init_cache(8, 48)
    tok = tokens[0, :8].reshape(8, 1)
    for pos in range(2):
        tok, cache = step(model, cache, tok, pos)
    profile_call(torch, lambda: step(model, cache, tok, 2),
                 "decode step, 8 requests")
    del model, logits, want, wit, prefill, cache
    torch.cuda.empty_cache()

    # fp32 decode against forward at full width.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg32, seed=0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (DECODE_B, DECODE_T)
                                        ).astype(np.int32), device="cuda")
    ops.reset_launches()
    # ---- the forward run: counts are zeroed just above, read below.
    fwd, _ = model(toks)
    torch.cuda.synchronize()
    fwd_launches = ops.LAUNCHES["flash_attention"]
    # ---- end of the forward run.
    if fwd_launches != cfg.n_layers:
        fail(f"forward: flash launches {fwd_launches} != {cfg.n_layers}")
    cache = model.init_cache(DECODE_B, DECODE_T)
    t0 = time.perf_counter()
    worst = 0.0
    scale = float(fwd.abs().max())
    for i in range(DECODE_T):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        worst = max(worst, float((lg[:, 0] - fwd[:, i]).abs().max()))
    dec_s = time.perf_counter() - t0
    log(f"decode against forward, fp32, B={DECODE_B} T={DECODE_T}: max "
        f"|decode - forward| / max |forward| = {worst / scale:.3e} (limit "
        f"{DECODE_TOL}; {DECODE_T} steps in {dec_s:.2f} s)")
    if not worst / scale < DECODE_TOL:
        fail(f"decode differs from forward by {worst / scale:.3e} of max "
             "|logit|")
    del model, fwd, cache
    torch.cuda.empty_cache()

    # The serving loop, launch.serve, at its defaults.
    ops.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(["--arch", LM_ARCH, "--requests", "8",
                         "--prompt-len", "32", "--gen", "16"])
    drv_s = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"serve: {line}")
    m = re.search(r"prefill: ([\d.]+) ms\s+decode: ([\d.]+) ms \(([\d.]+) "
                  r"ms/token\)", out)
    gens = re.findall(r"^\s+\[([\d, ]+)\]$", out, re.M)
    if rc != 0 or m is None or len(gens) != 3 or any(
            len(g.split(",")) != 16 for g in gens):
        fail(f"launch.serve: exit {rc}, output not as expected")
    log(f"launch.serve: prefill {m.group(1)} ms, decode {m.group(3)} "
        f"ms/token, {drv_s:.2f} s in all; flash launches "
        f"{ops.LAUNCHES['flash_attention']} (prefill by decode steps)")
    summary = {"prefill_ms": walls, "prefill_median_ms": prefill_ms,
               "prefill_peak_bytes": peak, "prefill_rel_l2": rel,
               "prefill_rel_l2_sdpa_chunked": rel_wit,
               "flash_device_ms_in_profiled_prefill": flash_dev,
               "decode_vs_forward": worst / scale,
               "serve_prefill_ms": float(m.group(1)),
               "serve_decode_ms_per_token": float(m.group(3))}
    return launches["flash_attention"] + fwd_launches, summary


# --------------------------------------------------------------------------- #
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None,
                    help="also write the run's summary JSON to this path")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse")

    from repro_torch.core import graph as G
    from repro_torch.kernels import build, ops, ref

    t_start = time.perf_counter()
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    t_build = build.build_all()
    for name, rep in build.build_log.items():
        log(f"nvcc {name}.cu:\n{rep.strip()}")
    log(f"build: {len(build.SOURCES)} kernels in {t_build:.2f} s")

    gemm_entry = kernel_phase(torch, ops, ref)
    launches, fl_prog, responses, peak, engine, co, fl = path_phase(torch)
    spdmm_entry = fl_spdmm_entry(torch, ops, ref, fl_prog)
    t6 = time.perf_counter()
    host_launches, heng, fl_x, host_sum = host_phase(
        torch, engine, fl, fl_prog, responses[-3].output)
    co_launches, co_remap = remap_co_phase(torch, co)
    fl_launches, fl_remap = remap_fl_phase(torch, heng, fl, fl_x)
    densify_entry, gemm_remap = remap_gemm_entry(torch, ops, ref, fl_prog)
    del heng
    log(f"host and remap phase: {time.perf_counter() - t6:.1f} s")
    rt_launches, gat_prog, rt_resps, rt_peak, rt_wall = runtime_phase(
        torch, engine, co, fl)
    sddmm_entry, sddmm_hub = fl_sddmm_entry(torch, ops, ref, gat_prog)
    t7 = time.perf_counter()
    sp_launches, sampled = sampled_phase(torch, G.synthesize("FL"))
    log(f"sampled phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    conf_launches, conformance = conformance_phase(
        torch, co, fl, card, host_sum["budget"], fl_remap)
    log(f"conformance phase: {time.perf_counter() - t7:.1f} s")
    del engine, fl_prog, gat_prog       # the FL programs of phases 3-5
    gc.collect()
    torch.cuda.empty_cache()
    t7 = time.perf_counter()
    live_launches, live = live_phase(torch, card)
    log(f"live phase: {time.perf_counter() - t7:.1f} s")
    t5 = time.perf_counter()
    flash_entry, flash_path, flash_gemma = flash_kernel_phase(torch, ops,
                                                              ref)
    flash_launches, lm = lm_phase(torch, ops, ref)
    lm["flash_path_shape"] = flash_path
    log(f"LM phase (flash checks, prefill, decode, launch.serve): "
        f"{time.perf_counter() - t5:.1f} s")
    t7 = time.perf_counter()
    mesh_launches, mesh = mesh_phase(torch, card)
    log(f"mesh phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    granite_launches, flash_granite, granite = granite_phase(torch, ops, ref)
    log(f"granite phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    gemma_launches, gemma = gemma3_phase(torch, ops, ref)
    gemma["flash_gemma3_12b_shape"] = flash_gemma
    log(f"gemma3 phase: {time.perf_counter() - t7:.1f} s")
    t7 = time.perf_counter()
    train_launches, train = train_phase(torch, ops, ref)
    log(f"train phase: {time.perf_counter() - t7:.1f} s")
    flash_entry["launches"] = (flash_launches + granite_launches
                               + gemma_launches + train_launches)
    kernels = [gemm_entry, spdmm_entry, sddmm_entry]
    for e in kernels:
        e["launches"] = sum(run.get(e["name"], 0) for run in (
            launches, rt_launches, host_launches, co_launches, fl_launches,
            sp_launches, conf_launches, live_launches, mesh_launches))
    kernels.append(flash_entry)
    densify_entry["launches"] = co_launches["densify"] + \
        fl_launches["densify"] + conf_launches["densify"] + \
        live_launches["densify"] + mesh_launches["densify"]
    kernels.append(densify_entry)
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    spdmm_extra = {k: spdmm_entry[k] for k in ("full_walk_ms",
                                               "padded_bound_ms")}
    kernels = [{k: e[k] for k in order} for e in kernels]
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "kernels": kernels,
                       "spdmm_fl_slice": spdmm_extra,
                       "sddmm_fl_slice": {
                           "padded_bound_ms": sddmm_entry[
                               "padded_bound_ms"]},
                       "sddmm_hub_tile": sddmm_hub,
                       "max_memory_allocated": peak,
                       "requests": [{"id": r.request_id,
                                     "t_loc_s": r.t_loc,
                                     "t_loh_s": r.t_loh,
                                     "cache_hit": r.cache_hit}
                                    for r in responses],
                       "runtime": {
                           "wall_s": rt_wall,
                           "max_memory_allocated": rt_peak,
                           "launches": rt_launches,
                           "requests": [{"id": r.request_id,
                                         "t_loc_s": r.t_loc,
                                         "t_loh_s": r.t_loh,
                                         "batch_size": r.batch_size,
                                         "overlay": r.overlay,
                                         "cache_hit": r.cache_hit}
                                        for r in rt_resps]},
                       "lm": lm,
                       "host_path": host_sum,
                       "remap": {"co": co_remap, "fl": fl_remap,
                                 "gemm_4096x4096x128": gemm_remap},
                       "sampled": sampled, "conformance": conformance,
                       "live": live, "mesh": mesh, "granite": granite,
                       "flash_granite_shape": flash_granite,
                       "gemma3": gemma, "train": train,
                       "flash_launches": {
                           "lm": flash_launches, "granite": granite_launches,
                           "gemma3": gemma_launches,
                           "train": train_launches},
                       "seconds": time.perf_counter() - t_start,
                       **result}, fh, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
