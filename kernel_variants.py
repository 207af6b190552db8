#!/usr/bin/env python3
"""Tile-shape variants of the GEMM and SDDMM kernels, read beside the
kernels themselves on one GPU.

    python3 kernel_variants.py [--parent DIR] [--json-out PATH]

Builds ``src/repro_torch/kernels/csrc/gemm.cu`` and ``sddmm.cu`` and one
copy of each per entry of ``VARIANTS`` (a text edit of the source that
changes a tile or block constant; each edited text must appear in the
source exactly once), one ``nvcc`` per source, all at once, under the
git-ignored ``src/repro_torch/kernels/_build/variants/``
(``build.build_copies``); the sources in the checkout are not touched.
With ``--parent DIR`` (a checkout of another tree, for example an
unpacked ``git archive`` of the parent commit) that tree's two sources
are built as the variant ``parent``.  Each variant is called through the
unchanged ``ops.gemm`` / ``ops.sddmm`` wrappers (``ops.entry`` swapped)
and:

* held against the plain version on ``chip_smoke.py``'s ragged sweeps and
  the path shapes (fp32 rtol 1e-5 / atol 1e-4; the unmasked SDDMM sweep
  at the JAX sweep's 1e-4 / 1e-4), and compared bit for bit with the
  kernel in the checkout (a GEMM variant keeps each element's sum order,
  so it must be equal; an SDDMM variant keeps each slot's);
* timed as ``chip_smoke.py`` times kernels (median of 5 trials of 20
  calls queued behind a spin kernel): GEMM at 4096x128xN, N in {128, 64,
  8}, strided views, C = A.B and C = acc + A.B, beside ``torch.matmul``
  and ``torch.addmm``; SDDMM on the widest ELL slice of full-scale Flickr
  (n1 = 4096, n2 = 128, the partition every FL program uses, its real
  mask), on the synthetic hub tile of ``chip_smoke.py`` and on two
  narrow tiles (w = 8 and 64, row lengths uniform in [0, w]), with an
  accumulator, beside ``torch.sparse.sampled_addmm``.

The kernel in the checkout is timed first and last (change, variants,
change), so its two readings show the drift within the call.  It exits
non-zero if a build fails, the checkout's kernel or a variant fails its
check, or a variant that must be bit-identical is not.  The last line of
the output is the readings as JSON.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Past 48 KB of shared memory a launch needs the opt-in (deeper rings at
# 64-column tiles); harmless below it.
_OPT_IN = ("  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);\n",
           "  cudaFuncSetAttribute(gemm_f32_kernel<true>,\n"
           "      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);\n"
           "  cudaFuncSetAttribute(gemm_f32_kernel<false>,\n"
           "      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);\n"
           "  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);\n")

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
    },
}


def log(*a) -> None:
    print(*a, flush=True)


def build_variants(build, parent):
    """Build every variant (and the parent's sources); returns (kernel,
    name) -> C entry point, the checkout's kernels as "change"."""
    copies = {}
    for kern, variants in VARIANTS.items():
        for name, (_, edits) in variants.items():
            copies[f"{kern}_{name}"] = (kern, build.edited(kern, edits))
        if parent:
            with open(os.path.join(parent, "src/repro_torch/kernels/csrc",
                                   f"{kern}.cu")) as fh:
                copies[f"{kern}_parent"] = (kern, fh.read())
    t0 = time.perf_counter()
    built = build.build_copies(copies, os.path.join(build.BUILD_DIR,
                                                    "variants"))
    log(f"build: {len(copies)} copies and the checkout's two kernels in "
        f"{time.perf_counter() - t0:.2f} s")
    fns = {}
    for tag, (fn, report) in built.items():
        kern, name = tag.split("_", 1)
        regs = [ln.split("ptxas info    :")[-1].strip()
                for ln in report.splitlines() if "Used" in ln or "spill" in ln]
        log(f"nvcc {kern} {name}: " + "; ".join(regs))
        fns[(kern, name)] = fn
    return fns


class entry_as:
    """While open, the wrappers launch ``fn`` (one variant's entry)."""

    def __init__(self, ops, fn):
        self.ops, self.fn, self.real = ops, fn, ops.entry

    def __enter__(self):
        self.ops.entry = lambda name: self.fn

    def __exit__(self, *exc):
        self.ops.entry = self.real


def gemm_phase(torch, cs, ops, ref, fns):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    names = [n for k, n in fns if k == "gemm"]
    shapes = cs.GEMM_SWEEP + [(4096, 128, n) for n in (128, 64, 8)]
    for m, k, n in shapes:
        x, w, acc = randn(m, 2 * k)[:, k:], randn(k, n), randn(m, n)
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
    m, k = 4096, 128
    for n in (128, 64, 8):
        h_full, w_full = randn(m, 4 * k), randn(4 * k, 2 * n)
        x, w = h_full[:, k:2 * k], w_full[k:2 * k, n:2 * n]
        acc = randn(m, n)
        row = {}
        for i, nm in enumerate(order):
            with entry_as(ops, fns[("gemm", nm)]):
                t = cs.median_ms(torch, lambda: ops.gemm(x, w))
                ta = cs.median_ms(torch, lambda: ops.gemm(x, w, acc))
            row[nm if i < len(order) - 1 else "change_again"] = [t, ta]
        row["torch"] = [cs.median_ms(torch, lambda: torch.matmul(x, w)),
                        cs.median_ms(torch, lambda: torch.addmm(acc, x, w))]
        out[f"N={n}"] = row
        log(f"gemm {m}x{k}x{n} ms (C = A.B / C = acc + A.B): " + ", ".join(
            f"{nm} {a:.4f} / {b:.4f}" for nm, (a, b) in row.items())
            + " (torch: matmul / addmm)")
    return out


def fl_widest_slice(torch):
    """cols / mask of the widest ELL slice of full-scale Flickr at the
    engine's default geometry (n1 = 4096, n2 = 128)."""
    from repro_torch.core import graph as G
    from repro_torch.core.passes.partition import (PartitionConfig,
                                                   partition_graph)
    t0 = time.perf_counter()
    fl = G.synthesize("FL").gcn_normalized()
    pg = partition_graph(fl, PartitionConfig(n1=4096, n2=128))
    tile = max((t for ts in pg.tiles.values() for t in ts),
               key=lambda t: (t.width, t.nnz))
    log(f"FL partition in {time.perf_counter() - t0:.1f} s; widest slice "
        f"(j,k)=({tile.shard_row},{tile.shard_col}) w={tile.width} "
        f"nnz={tile.nnz}")
    return (torch.as_tensor(tile.cols, device="cuda").contiguous(),
            torch.as_tensor(tile.edge_pos >= 0, device="cuda").contiguous())


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


def sddmm_phase(torch, cs, ops, ref, fns):
    gen = torch.Generator(device="cuda").manual_seed(2)
    names = [n for k, n in fns if k == "sddmm"]
    # The parent's per-slot sum order may differ: held to tolerance only.
    same_order = [n for n in names if n != "parent"]
    sweep = cs.SDDMM_SWEEP + [(40, 200, 50, 256), (33, 77, 60, 33)]
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
    log(f"sddmm: {len(names)} builds within tolerance on {len(sweep)} "
        "shapes")
    order = ["change"] + [nm for nm in names if nm != "change"] + ["change"]
    out = {}
    for tname, (cols, mask) in (("FL", fl_widest_slice(torch)),
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
        out[tname] = {"live": int(rows.numel()), "ms": row}
        log(f"sddmm {tname} tile n1={n1} w={w} f=128 live={rows.numel()} "
            "ms: " + ", ".join(f"{nm} {t:.4f}" for nm, t in row.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose gemm.cu / sddmm.cu to "
                         "build and time as the variant 'parent'")
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
    fns = build_variants(build, args.parent)
    fns[("gemm", "change")] = ops.entry("gemm")
    fns[("sddmm", "change")] = ops.entry("sddmm")
    result = {"card": card,
              "variants": {k: {n: d for n, (d, _) in v.items()}
                           for k, v in VARIANTS.items()},
              "gemm": gemm_phase(torch, cs, ops, ref, fns),
              "sddmm": sddmm_phase(torch, cs, ops, ref, fns)}
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as fh:
            json.dump(result, fh, indent=1)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
