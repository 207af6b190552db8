"""Cost-model conformance: measured-vs-predicted accounting.

A copy of ``repro/obs/conformance.py`` over the port's perfmodel (whose
default constants are the H100's) and ``ExecStats.per_layer``: CUDA-event
times of each layer on the device path, synchronized host wall times on
the host path.  The one departure is :func:`fit_stage_bw`, which prefers
a ``stage`` span's ``copy_us`` argument, the copies' device time that
the executor records with CUDA events, to the span's host duration, which
on a CUDA device measures only how long the copies took to enqueue.

The compiler's decisions (kernel mapping, Algorithm 9 scheduling, LPT
placement) all price work with the analytic roofline in
:mod:`repro_torch.core.perfmodel`; this module closes the loop by joining
those *predictions* with what the executor *measured*:

* per-layer join — ``perfmodel.layer_costs`` against
  ``ExecStats.per_layer`` (populated on every residency path), grouped
  by kernel mode;
* per-mode **model error** — normalized RMSE of predicted vs measured
  layer times, the drift metric the CI trajectory gate holds;
* **least-squares calibration** — a per-mode scale fitted through the
  origin (``a = Σ p·m / Σ p²``, the exact minimizer of the squared
  error, so calibrated error ≤ uncalibrated by construction), folded
  back into *effective* machine constants (``ModelConstants`` with
  fitted FLOPS/BW) plus a staging-bandwidth fit from traced ``stage``
  spans;
* **density join** — predicted vs measured cost share per tile-density
  bucket, reusing the ``exec_profile`` histogram (the Dynasparse
  remapper's decision input);
* **halo gap** — measured all_gather volume vs the compile-time
  targeted-halo estimate on mesh runs (what a ppermute-style exchange
  would save);
* optional **critical path** — :mod:`repro_torch.obs.attrib` summary of the
  traced run folded into the report.

Reports serialize as JSON (``to_dict``) and markdown (``to_markdown``)
and feed both ``BENCH_fullgraph.json`` (the gated ``model_error``
metric) and the ``CONFORMANCE.md`` CI artifact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.perfmodel import (DEFAULT_CONSTANTS,
                                        ModelConstants, layer_costs)

from .attrib import build_dag

__all__ = ["ConformanceReport", "build_report", "ls_scale", "nrmse",
           "fit_stage_bw"]

# which machine constant each kernel mode's roofline leans on
_CONSTANT_OF_MODE = {
    "gemm": "peak_flops",
    "spdmm": "vpu_flops",
    "sddmm": "vpu_flops",
    "vadd": "hbm_bw",
    "act": "hbm_bw",
}


def ls_scale(pairs: Sequence[Tuple[float, float]]) -> float:
    """Least-squares scale ``a`` minimizing ``Σ (m - a·p)²`` over
    (predicted, measured) pairs — fit through the origin, so the
    calibrated error can never exceed the uncalibrated one."""
    num = sum(p * m for p, m in pairs)
    den = sum(p * p for p, _ in pairs)
    return (num / den) if den > 0 else 1.0


def nrmse(pairs: Sequence[Tuple[float, float]], scale: float = 1.0
          ) -> float:
    """RMSE of ``scale·predicted`` vs measured, normalized by the mean
    measured value (dimensionless; comparable across modes)."""
    if not pairs:
        return 0.0
    mse = sum((m - scale * p) ** 2 for p, m in pairs) / len(pairs)
    mean = sum(m for _, m in pairs) / len(pairs)
    return math.sqrt(mse) / mean if mean > 0 else 0.0


def fit_stage_bw(events: Sequence[dict]) -> Optional[float]:
    """Effective h2d staging bandwidth (bytes/s) least-squares fitted
    from traced ``stage`` spans (``t ≈ bytes / B``), each span's time
    being its ``copy_us`` argument where it has one (the copies' device
    time on a CUDA device), else its duration."""
    num = den = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("name") == "stage":
            args = e.get("args", {})
            b = float(args.get("bytes", 0))
            t = float(args.get("copy_us", e.get("dur", 0.0))) / 1e6
            if b > 0 and t > 0:
                num += b * b
                den += b * t
    return (num / den) if den > 0 else None


@dataclasses.dataclass
class ConformanceReport:
    """Joined measured-vs-predicted accounting for one traced run."""

    residency: str
    predicted_s: float
    measured_s: float
    model_error: Dict[str, float]              # per kernel mode, a=1
    model_error_calibrated: Dict[str, float]   # per mode, fitted a
    scales: Dict[str, float]                   # fitted per-mode scale
    constants: Dict[str, float]                # defaults the model used
    calibrated_constants: Dict[str, float]     # effective constants
    per_layer: List[dict]                      # join rows
    density: List[dict]                        # per-bucket join rows
    halo: Optional[dict] = None                # mesh halo gap
    critical_path: Optional[dict] = None       # attrib summary

    @property
    def model_error_overall(self) -> float:
        return nrmse([(r["predicted_s"], r["measured_s"])
                      for r in self.per_layer])

    @property
    def model_error_overall_calibrated(self) -> float:
        return nrmse([(r["predicted_s"] * self.scales.get(r["kernel"], 1.0),
                       r["measured_s"]) for r in self.per_layer])

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_error_overall"] = self.model_error_overall
        d["model_error_overall_calibrated"] = \
            self.model_error_overall_calibrated
        return d

    def to_markdown(self) -> str:
        out = ["## Cost-model conformance", "",
               f"Residency: `{self.residency}` — predicted "
               f"{self.predicted_s:.4g}s vs measured "
               f"{self.measured_s:.4g}s "
               f"(overall error {self.model_error_overall:.3f} -> "
               f"{self.model_error_overall_calibrated:.3f} calibrated)",
               "", "| mode | layers | predicted s | measured s | "
               "scale | error | error (cal) |",
               "|---|---|---|---|---|---|---|"]
        modes = sorted(self.model_error)
        for m in modes:
            rows = [r for r in self.per_layer if r["kernel"] == m]
            out.append(
                f"| {m} | {len(rows)} "
                f"| {sum(r['predicted_s'] for r in rows):.4g} "
                f"| {sum(r['measured_s'] for r in rows):.4g} "
                f"| {self.scales[m]:.3g} | {self.model_error[m]:.3f} "
                f"| {self.model_error_calibrated[m]:.3f} |")
        out += ["", "### Calibrated machine constants", "",
                "| constant | default | effective |", "|---|---|---|"]
        for k, v in self.constants.items():
            eff = self.calibrated_constants.get(k)
            out.append(f"| {k} | {v:.4g} | "
                       + (f"{eff:.4g} |" if eff is not None else "- |"))
        if self.density:
            out += ["", "### Density buckets (sparse tiles)", "",
                    "| bucket | tiles | ops | predicted share | "
                    "measured share |", "|---|---|---|---|---|"]
            for r in self.density:
                out.append(
                    f"| {r['bucket']} | {r['tiles']} | {r['ops']} "
                    f"| {r['predicted_share']:.3f} "
                    f"| {r['measured_share']:.3f} |")
        if self.halo:
            h = self.halo
            out += ["", "### Halo exchange (mesh)", "",
                    "- gathered (measured all_gather): "
                    f"{h['gathered_bytes']} bytes",
                    "- targeted estimate (placement): "
                    f"{h['estimated_bytes']} bytes",
                    "- gap (gathered - estimated, positive = planner "
                    f"under-estimate): {h['gap_bytes']} bytes "
                    f"({100 * h['gap_fraction']:.1f}% of estimate)"]
        if self.critical_path:
            cp = self.critical_path
            out += ["", "### Critical path", "",
                    f"- makespan: {cp['makespan_us']:.0f} µs over "
                    f"{cp['n_spans']} spans; critical path "
                    f"{cp['critical_path_us']:.0f} µs "
                    f"({len(cp['critical_path'])} spans)"]
            stalls = cp.get("stall_us_by_name") or {}
            for name, us in sorted(stalls.items(),
                                   key=lambda kv: -kv[1])[:5]:
                out.append(f"- stall[{name}]: {us:.0f} µs")
        return "\n".join(out)


def _density_join(prog, per_mode_measured: Dict[str, float],
                  constants: ModelConstants) -> List[dict]:
    """Predicted vs measured cost share per tile-density bucket of the
    sparse kernel modes, reusing the ``exec_profile`` per-tile records.
    Measured share attributes each mode's measured seconds over its
    tiles proportionally to dispatched ops (the per-tile resolution the
    executor has); predicted share prices each tile with the roofline."""
    prof = (prog.manifest or {}).get("exec_profile")
    if not prof or not prof.get("tiles"):
        return []
    pg = prog.pgraph
    n1, n2 = pg.config.n1, pg.config.n2
    buckets: Dict[int, dict] = {}
    total_ops: Dict[str, int] = {}
    for rec in prof["tiles"].values():
        total_ops[rec["kernel"]] = (total_ops.get(rec["kernel"], 0)
                                    + int(rec["ops"]))
    tot_pred = 0.0
    for rec in prof["tiles"].values():
        nnz, slots = int(rec["nnz"]), int(rec["slots"])
        density = float(rec["density"])
        mode = rec["kernel"]
        flops = 2.0 * nnz * n2
        bytes_ = slots * 4 * 2 + n1 * n2 * 4
        t_pred = max(flops / constants.vpu_flops,
                     bytes_ / constants.hbm_bw) * int(rec["ops"])
        m_tot = per_mode_measured.get(mode, 0.0)
        t_meas = (m_tot * rec["ops"] / total_ops[mode]
                  if total_ops.get(mode) else 0.0)
        b = buckets.setdefault(min(int(density * 10), 9), {
            "tiles": 0, "ops": 0, "predicted_s": 0.0, "measured_s": 0.0})
        b["tiles"] += 1
        b["ops"] += int(rec["ops"])
        b["predicted_s"] += t_pred
        b["measured_s"] += t_meas
        tot_pred += t_pred
    tot_meas = sum(b["measured_s"] for b in buckets.values())
    out = []
    for k in sorted(buckets):
        b = buckets[k]
        out.append({
            "bucket": k, "tiles": b["tiles"], "ops": b["ops"],
            "predicted_share": (b["predicted_s"] / tot_pred
                                if tot_pred > 0 else 0.0),
            "measured_share": (b["measured_s"] / tot_meas
                               if tot_meas > 0 else 0.0)})
    return out


def build_report(prog, stats, residency: str = "device",
                 events: Optional[Sequence[dict]] = None,
                 overlap: bool = True,
                 constants: Optional[ModelConstants] = None
                 ) -> ConformanceReport:
    """Join one run's measurements against the cost model.

    ``prog`` is the :class:`CompiledProgram` (must carry ``source`` —
    recompile with ``use_cache=False`` after a cache hit), ``stats`` the
    run's :class:`ExecStats` (``per_layer`` populated), ``events`` an
    optional traced event list for the staging-bandwidth fit and the
    critical-path summary.
    """
    if getattr(prog, "source", None) is None:
        raise ValueError(
            "conformance needs prog.source (the object-graph Program); "
            "recompile with use_cache=False after a program-cache hit")
    if not getattr(stats, "per_layer", None):
        raise ValueError(
            "stats.per_layer is empty — run the program first (every "
            "residency path populates per-layer attribution)")
    c = constants or DEFAULT_CONSTANTS
    model_res = "host" if residency == "host" else "device"
    pred = {lc.layer_id: lc for lc in layer_costs(
        prog.source.program, overlap=overlap, residency=model_res,
        constants=c)}

    rows: List[dict] = []
    for r in stats.per_layer:
        lc = pred.get(r["layer"])
        if lc is None:
            continue
        rows.append({
            "layer": r["layer"], "kernel": r["kernel"],
            "step": r.get("step"),
            "instr_lo": r.get("instr_lo", -1),
            "instr_hi": r.get("instr_hi", -1),
            "tile_ops": r.get("tile_ops", 0),
            "predicted_s": lc.t, "measured_s": r["wall_s"],
            "h2d_bytes": r.get("h2d_bytes", 0)})

    by_mode: Dict[str, List[Tuple[float, float]]] = {}
    meas_by_mode: Dict[str, float] = {}
    for r in rows:
        by_mode.setdefault(r["kernel"], []).append(
            (r["predicted_s"], r["measured_s"]))
        meas_by_mode[r["kernel"]] = (meas_by_mode.get(r["kernel"], 0.0)
                                     + r["measured_s"])
    scales = {m: ls_scale(p) for m, p in by_mode.items()}
    err = {m: nrmse(p) for m, p in by_mode.items()}
    err_cal = {m: nrmse(p, scales[m]) for m, p in by_mode.items()}

    # Effective machine constants: measured ≈ scale · predicted and the
    # roofline divides by the constant, so the fitted constant is
    # default / scale (measured-time-weighted across modes sharing it).
    eff: Dict[str, float] = {}
    weight: Dict[str, float] = {}
    for m, a in scales.items():
        key = _CONSTANT_OF_MODE.get(m)
        if key is None or a <= 0:
            continue
        w = meas_by_mode.get(m, 0.0) or 1e-12
        eff[key] = eff.get(key, 0.0) + w * a
        weight[key] = weight.get(key, 0.0) + w
    calibrated = {}
    for k, v in c.to_dict().items():
        if k in eff and weight[k] > 0:
            calibrated[k] = v / (eff[k] / weight[k])
    if events is not None:
        bw = fit_stage_bw(events)
        if bw is not None:
            calibrated["stage_bw"] = bw

    halo = None
    est = int(getattr(stats, "halo_bytes", 0) or 0)
    gath = int(getattr(stats, "halo_gather_bytes", 0) or 0)
    if gath > 0 or est > 0:
        # Signed: positive = the all_gather moved more than the
        # placement estimate (planner under-estimate), negative = less.
        gap = gath - est
        halo = {"estimated_bytes": est, "gathered_bytes": gath,
                "gap_bytes": gap,
                "gap_fraction": (gap / est) if est > 0 else 0.0}

    cp = None
    if events is not None:
        cp = build_dag(list(events)).summary()

    return ConformanceReport(
        residency=residency,
        predicted_s=sum(r["predicted_s"] for r in rows),
        measured_s=sum(r["measured_s"] for r in rows),
        model_error=err, model_error_calibrated=err_cal, scales=scales,
        constants=c.to_dict(), calibrated_constants=calibrated,
        per_layer=rows,
        density=_density_join(prog, meas_by_mode, c),
        halo=halo, critical_path=cp)
