#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases (any failure exits non-zero; nothing is caught):

1. Card and build: the card's name and power limit (``nvidia-smi``), then
   every hand kernel built from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once), with the build time and ``ptxas``
   report.
2. Kernels: each kernel against its plain torch version on the card, at
   the executor's tile shapes (GEMM 4096x128x128 without and with the
   accumulator, against torch.matmul / torch.addmm; SpDMM n1=4096, f=128,
   w in {8, 64, 512}, strided views as the executor passes them) and at
   the ragged sweep shapes of ``tests/test_kernels.py``, fp32 tolerance
   rtol 1e-5 / atol 1e-4.  Median times of kernel, plain version and the
   PyTorch library call, and the bound (bytes over 3.35 TB/s or flops
   over 67 TFLOP/s fp32, the H100 SXM data-sheet peaks).
3. Main path: ``Engine(device="cuda").serve`` answers b1-b8 on Cora (CO)
   and three b2 (GCN, hidden 128) requests on full-scale Flickr (FL,
   89,250 vertices, 989,006 edges with self loops), weights random from
   seed 0.  Every output is held against the port's plain torch reference
   (``run_reference``, index_add_ / scatter_reduce) on the card at rtol
   2e-4 / atol 2e-5; the FL repeats must be cache hits; the kernels'
   launch counts over the serve loop must be > 0 and equal the
   executor's GEMM and SUM/MEAN SpDMM tile ops.
4. One more FL request (a cache hit) under ``torch.profiler``: device
   time by kernel and the device's busy share.  Then the SpDMM kernel
   timed again on the widest real ELL slice of the FL program, which is
   the kernel's entry in the ``kernels`` line.

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
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12        # H100 SXM fp32, CUDA cores
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-4
PATH_RTOL, PATH_ATOL = 2e-4, 2e-5

GEMM_SWEEP = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
              (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258)]
SPDMM_SWEEP = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
               (32, 64, 32, 8), (8, 8, 8, 8)]


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(nbytes: float, flops: float):
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FP32_FLOP_S * 1e3
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
    zero = ops.spdmm(torch.zeros(16, 8, dtype=torch.int32, device="cuda"),
                     torch.zeros(16, 8, device="cuda"), randn(16, 16))
    torch.cuda.synchronize()
    if float(zero.abs().max()) != 0.0:
        fail("spdmm: zero padding is not inert")
    log("kernels: ragged sweeps within tolerance "
        f"({len(GEMM_SWEEP)} gemm, {len(SPDMM_SWEEP)} spdmm shapes)")

    # GEMM at the executor's tile shape: a [4096, 128] sub-fiber view of a
    # padded [4096, 512] layer tensor times a [128, 128] weight block view,
    # in both forms the executor issues: the first K step of an output
    # tile (C = A.B, the kernels-line entry, against torch.matmul) and the
    # later ones (C = acc + A.B, against torch.addmm).
    m, k, n = 4096, 128, 128
    h_full, w_full = randn(m, 4 * k), randn(4 * k, 2 * n)
    x, w = h_full[:, k:2 * k], w_full[k:2 * k, n:2 * n]
    acc = randn(m, n)
    gemm_entry = None
    for with_acc in (False, True):
        a = acc if with_acc else None
        want = ref.gemm_ref(x, w) + (acc if with_acc else 0.0)
        err = check_close(torch, "gemm path shape", ops.gemm(x, w, a), want,
                          KERNEL_RTOL, KERNEL_ATOL)
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
            f"{', +acc' if with_acc else ''}): kernel {t_k:.4f} ms, plain "
            f"{t_p:.4f} ms, {lib} {t_l:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), max|err| {err:.2e}")
        if gemm_entry is None:
            gemm_entry = {
                "name": "gemm", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/gemm.cu",
                "replaces": "src/repro/kernels/gemm.py:38",
                "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l}

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


def _ell_to_csr(torch, cols, vals, live, n_src):
    """The true edges of an ELL tile as a CSR matrix [n1, n_src]
    (duplicate columns summed), for the library yardstick."""
    rows, slots = torch.nonzero(live, as_tuple=True)
    idx = torch.stack([rows, cols[rows, slots].long()])
    coo = torch.sparse_coo_tensor(idx, vals[rows, slots],
                                  (cols.shape[0], n_src)).coalesce()
    return coo.to_sparse_csr()


def _spdmm_bound(n1, w, n_src, f, nnz):
    """Bytes: cols + vals [n1, w] + h [n_src, f] + acc + out [n1, f], each
    once; operations: 2 flops per true edge and feature (pad slots are
    work the data does not need)."""
    nbytes = 4 * (2 * n1 * w + n_src * f + 2 * n1 * f)
    return bound_ms(nbytes, 2.0 * nnz * f)


# --------------------------------------------------------------------------- #
def path_phase(torch):
    from repro_torch.core import graph as G
    from repro_torch.core.gnn_builders import BENCHMARKS, build
    from repro_torch.core.ir import AggOp, LayerType
    from repro_torch.core.reference import run_reference
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

    # Every output against the port's plain reference on the card, run in
    # float64 so that the reference's own rounding does not count; the
    # fp32 reference's distance is printed beside it for comparison.
    worst, bad = 0.0, []
    for req, resp in zip(reqs, responses):
        g = req.graph
        model = build(req.model, g, req.seed)
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
    log(f"path: {len(responses)} outputs within rtol {PATH_RTOL} / atol "
        f"{PATH_ATOL} of run_reference in float64 (worst max|err| "
        f"{worst:.3e})")
    profile_request(torch, engine, reqs[-1])
    fl_prog = engine.cache.get(responses[-1].cache_key)
    return launches, fl_prog, responses, layer_times, peak


def profile_request(torch, engine, req) -> None:
    """One more FL request (a cache hit) under torch.profiler: device time
    by kernel name and the device's busy share of the request's wall
    time.  A measurement beside the smoke run, not one of its checks:
    when the profiler yields no device events it says "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.serve([req])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    except Exception as exc:            # the profiler is optional here
        log(f"profile: not measured ({type(exc).__name__}: {exc})")
        return
    if not kern:
        log("profile: no device events; device busy share not measured")
        return
    by_name, ivs = {}, []
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        ivs.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(ivs):
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"profile b2@FL hit: wall {wall_us / 1e3:.2f} ms under the "
        f"profiler, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), {len(kern)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {us / 1e3:9.3f} ms  {name[:90]}")


def fl_spdmm_entry(torch, ops, ref, prog):
    """The SpDMM kernel on the widest real ELL slice of the FL program,
    with the source view the executor passes it."""
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
    gen = torch.Generator(device="cuda").manual_seed(1)
    h_full = torch.randn(pg.n_blocks * n1, 4 * f, generator=gen,
                         device="cuda")
    k = key[1]
    h = h_full[k * n1:(k + 1) * n1, f:2 * f]
    acc = torch.randn(n1, f, generator=gen, device="cuda")
    err = check_close(torch, "spdmm FL tile", ops.spdmm(cols, vals, h, acc),
                      acc + ref.spdmm_ref(cols, vals, h), KERNEL_RTOL,
                      KERNEL_ATOL)
    live = vals != 0
    sp, hc = _ell_to_csr(torch, cols, vals, live, n1), h.contiguous()
    t_k = median_ms(torch, lambda: ops.spdmm(cols, vals, h, acc))
    t_p = median_ms(torch, lambda: acc + ref.spdmm_ref(cols, vals, h))
    t_l = median_ms(torch, lambda: torch.sparse.mm(sp, hc))
    b_ms, b_by = _spdmm_bound(n1, w, n1, f, nnz)
    slots = sum(t.cols.size for ts in pg.tiles.values() for t in ts)
    log(f"FL program: {sum(len(ts) for ts in pg.tiles.values())} ELL "
        f"slices, {slots} padded slots for {pg.total_nnz()} edges "
        f"({slots / max(pg.total_nnz(), 1):.1f}x)")
    log(f"kernel spdmm on FL slice (j,k,s)={key} n1={n1} w={w} f={f} "
        f"nnz={nnz}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
        f"torch.sparse.mm {t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"max|err| {err:.2e}")
    return {"name": "spdmm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/spdmm.cu",
            "replaces": "src/repro/kernels/spdmm.py:44",
            "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l}


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
    launches, fl_prog, responses, _, peak = path_phase(torch)
    spdmm_entry = fl_spdmm_entry(torch, ops, ref, fl_prog)
    gemm_entry["launches"] = launches["gemm"]
    spdmm_entry["launches"] = launches["spdmm"]
    kernels = [gemm_entry, spdmm_entry]
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    kernels = [{k: e[k] for k in order} for e in kernels]
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump({"card": card, "kernels": kernels,
                       "max_memory_allocated": peak,
                       "requests": [{"id": r.request_id,
                                     "t_loc_s": r.t_loc,
                                     "t_loh_s": r.t_loh,
                                     "cache_hit": r.cache_hit}
                                    for r in responses],
                       "seconds": time.perf_counter() - t_start,
                       **result}, fh, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
