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
   ``Engine.remap`` with the default constants (TPU v5e figures) over its
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

6. LM serving path, qwen3-0.6b at full width (28 layers, d_model 1024, 16
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
   the whole output and 2^-7 over each query row, ``check_rows``);
   ``make_prefill_step`` in bf16 at B=4, T=2048 (a warm-up and 3 timed
   prefills, 28 flash launches each, last-position logits within
   relative L2 2e-2 of the same model run with plain attention, the
   reading of the same model with ``_sdpa_chunked`` attention beside it,
   one more prefill under ``torch.profiler``); fp32 decode
   against forward at B=2, T=64 (every position within 2e-4 of max
   |logit|, the JAX test's tolerance); and the serving loop
   ``repro_torch.launch.serve.main`` at its defaults (8 requests, prompt
   32, 16 generated tokens, bf16).

``launches`` in the ``kernels`` line is a kernel's count over the driven
paths (the Engine.serve path, the host and remap runs of phase 4, the
runtime path, and the prefill and forward runs of phase 6), each counted
from zero just before the path runs and read just after.

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
import io
import json
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
    """b2@FL: one profiled hit, then remap priced by the TPU-default
    constants over the exec_profile densities and by probing this card's
    kernels; each run once device-resident (its T_LoH printed)."""
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
    for label, kw in (("tpu-default", {"source": "exec_profile"}),
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


def chunked_attention(q, k, v, causal=True, chunk=256):
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
                      pos, causal, 0, d ** -0.5, chunk)
    return o[0].transpose(0, 1).contiguous()


def flash_bound(bh, tq, tk, d, causal, elem_bytes, peak_flop_s,
                kv_heads=None):
    """Bytes: q, k, v read once (k / v over ``kv_heads`` heads, bh when
    None), out written once; operations: 4 d flops (two products) per
    (query, key) pair the mask keeps."""
    kv = bh if kv_heads is None else kv_heads
    pairs = (sum(min(tk, i + 1) for i in range(tq)) if causal
             else tq * tk)
    return bound_ms(elem_bytes * d * (2 * bh * tq + 2 * kv * tk),
                    4.0 * d * bh * pairs, peak_flop_s)


def sdpa_yardstick(torch, q, k, v):
    """``F.scaled_dot_product_attention`` (causal) on the kernel's
    operands, k / v with one head per G query heads: ``enable_gqa=True``
    where the installed torch takes it (2.5 on), else on heads repeated G
    times.  Returns (the call, how grouped heads were passed)."""
    import torch.nn.functional as F
    g = q.shape[0] // k.shape[0]
    q4, k4, v4 = q[None], k[None], v[None]
    if g == 1:
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)), "one KV head per query head"
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return (lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)), "enable_gqa=True"
    kr, vr = (x.repeat_interleave(g, dim=0)[None] for x in (k, v))
    return (lambda: F.scaled_dot_product_attention(
        q4, kr, vr, is_causal=True)), "KV heads repeated (no enable_gqa)"


def flash_kernel_phase(torch, ops, ref):
    """The flash kernel against its plain version on the JAX sweep, its
    bf16 case, ragged and grouped-head cases and the path shape; returns
    the kernels-line entry (the path shape in bf16 with qwen3-0.6b's
    grouped KV heads, as the prefill calls it)."""
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
    return entry, path_rel


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
    t5 = time.perf_counter()
    flash_entry, flash_path = flash_kernel_phase(torch, ops, ref)
    flash_launches, lm = lm_phase(torch, ops, ref)
    lm["flash_path_shape"] = flash_path
    log(f"LM phase (flash checks, prefill, decode, launch.serve): "
        f"{time.perf_counter() - t5:.1f} s")
    flash_entry["launches"] = flash_launches
    kernels = [gemm_entry, spdmm_entry, sddmm_entry]
    for e in kernels:
        e["launches"] = sum(run.get(e["name"], 0) for run in (
            launches, rt_launches, host_launches, co_launches, fl_launches))
    kernels.append(flash_entry)
    densify_entry["launches"] = co_launches["densify"] + \
        fl_launches["densify"]
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
                       "seconds": time.perf_counter() - t_start,
                       **result}, fh, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
