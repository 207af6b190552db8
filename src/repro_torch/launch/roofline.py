"""Roofline report: aggregate the port's dry-run artifacts into roofline
tables (torch; the counterpart of ``repro/launch/roofline.py``).

  PYTHONPATH=src python -m repro_torch.launch.roofline \\
      [--dir artifacts/dryrun_torch]

Per (arch x shape x mesh): the three roofline terms (seconds) on H100
SXM5 80 GB cards at 700 W, the dominant term, MODEL_FLOPS (6*N*D train /
2*N*D decode+prefill, N = active params), the useful-compute ratio
MODEL_FLOPS / traced flops, and a one-line "what would move the dominant
term" note.  JAX's ``reanalyze`` is not ported: it re-reads stored HLO,
and the port's dry-run keeps none (a cell is traced again with
``launch.dryrun --force``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

# The dry-run's pricing (``launch/dryrun.py``), NVIDIA's H100 SXM5 80 GB
# data sheet at 700 W:
from repro_torch.core.perfmodel import HBM_BW  # noqa: F401  3.35e12 B/s
PEAK_FLOPS = 989e12     # bf16 FLOP/s / card, tensor cores, dense
LINK_BW = 450e9         # B/s / card, each direction (NVLink 4)

_MOVE_NOTES = {
    "compute_s": ("raise tensor-core utilization: larger per-device batch "
                  "or less recompute (remat policy)"),
    "memory_s": ("cut HBM traffic: fuse epilogues, chunk the loss, "
                 "avoid f32 round-trips, smaller attention chunks"),
    "collective_s": ("reshard to cut collectives: different einsum "
                     "order, overlap a2a with expert compute, "
                     "hierarchical reduction over pod axis"),
}


def model_flops(rec: Dict) -> float:
    n_active = rec.get("n_active_params", 0)
    if rec["kind"] == "train":
        return 6.0 * n_active * rec["tokens"]
    if rec["kind"] == "prefill":
        return 2.0 * n_active * rec["tokens"]
    # decode: one token per sequence in the batch
    return 2.0 * n_active * rec["tokens"]


def load(art_dir: str, mesh: Optional[str] = None) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        if "__naive" in f or "__tag" in f:
            continue
        r = json.load(open(f))
        if mesh and r.get("mesh") != mesh:
            continue
        out.append(r)
    return out


def fmt_row(r: Dict) -> str:
    if r.get("skipped"):
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | — | "
                f"skip: {r['skipped'][:42]}… |")
    if r.get("status") != "ok":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | — | "
                "ERROR |")
    rf = r["roofline"]
    mf = model_flops(r)
    n_dev = r["n_devices"]
    traced_flops_total = r["analysis"]["flops_per_device"] * n_dev
    ratio = mf / traced_flops_total if traced_flops_total else 0.0
    dom = rf["dominant"].replace("_s", "")
    mem_gib = r["memory"]["per_device_total"] / 2 ** 30
    return (f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4f} | "
            f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
            f"**{dom}** | {ratio:.2f} | {mem_gib:.1f} GiB |")


def dominant_note(r: Dict) -> str:
    return _MOVE_NOTES[r["roofline"]["dominant"]]


def report(art_dir: str) -> str:
    lines = []
    lines.append("### Single-pod (16x16 = 256 H100s) roofline, "
                 "per (arch x shape)\n")
    lines.append("| arch | shape | compute (s) | memory (s) | "
                 "collective (s) | bottleneck | 6ND/traced | mem/dev |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for r in load(art_dir, "single"):
        lines.append(fmt_row(r))
    lines.append("")
    lines.append("### Multi-pod (2x16x16 = 512 H100s) roofline\n")
    lines.append("| arch | shape | compute (s) | memory (s) | "
                 "collective (s) | bottleneck | 6ND/traced | mem/dev |")
    lines.append("|---|---|---|---|---|---|---|---|")
    for r in load(art_dir, "multi"):
        lines.append(fmt_row(r))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "artifacts",
        "dryrun_torch"))
    args = ap.parse_args(argv)
    print(report(args.dir))


if __name__ == "__main__":
    main()
