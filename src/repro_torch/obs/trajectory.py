"""Perf-trajectory comparison — make BENCH_*.json a *gated* artifact.

A copy of ``repro/obs/trajectory.py`` (pure stdlib; a test holds the two
equal on the same documents).

Every PR in this repo ships benchmark JSON (serve throughput, sampling
tail latency, out-of-core window sizes, live-graph cutover health).
Until now those were write-only: nothing noticed when a change made the
batcher stop coalescing or the streaming window grow.  This module
compares a freshly produced benchmark file against the committed
baseline under **per-metric tolerance bands** and renders a markdown
report; ``benchmarks/check_trajectory.py`` wires it into CI as a gate.

Bands are asymmetric by design: a metric only *fails* when it moves in
its bad direction past its band — improvements are reported, never
blocked.  Wall-clock metrics get wide relative bands (CI hosts are
noisy and heterogeneous); semantic metrics — cache hit rates, batching
pass counts, bit-identity flags, dropped/misrouted request counts,
deterministic byte counters — get tight or zero bands, because those
regress only when the code regresses.

Files are compared only when their ``mode`` field matches (a ``--smoke``
run is not comparable against a committed full-scale run); mismatches
are reported as skipped, not failed.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "MetricSpec", "MetricResult", "FileReport", "TrajectoryReport",
    "DEFAULT_SPECS", "lookup", "compare_metrics", "compare_docs",
    "compare_dirs",
]


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One gated metric: where it lives, which way is good, how much
    degradation the band tolerates.

    ``rel_tol``/``abs_tol`` define the allowed move in the *bad*
    direction: a higher-is-better metric fails when
    ``fresh < baseline * (1 - rel_tol) - abs_tol``; a lower-is-better
    metric fails when ``fresh > baseline * (1 + rel_tol) + abs_tol``.
    Booleans compare as 1.0/0.0, so a flag with zero tolerances must
    simply never flip the wrong way.
    """

    path: str                   # dotted path; integer segments index lists
    direction: str = "higher"   # "higher" | "lower" is BETTER
    rel_tol: float = 0.25
    abs_tol: float = 0.0
    note: str = ""

    def __post_init__(self) -> None:
        if self.direction not in ("higher", "lower"):
            raise ValueError(
                "direction must be 'higher' or 'lower', "
                f"got {self.direction!r}")


@dataclasses.dataclass
class MetricResult:
    path: str
    status: str                 # ok | improved | regressed | missing | new
    baseline: Optional[float] = None
    fresh: Optional[float] = None
    delta_pct: Optional[float] = None
    band: str = ""
    note: str = ""

    @property
    def failed(self) -> bool:
        return self.status in ("regressed", "missing")


@dataclasses.dataclass
class FileReport:
    name: str
    results: List[MetricResult] = dataclasses.field(default_factory=list)
    skipped: Optional[str] = None     # reason this file was not compared

    @property
    def ok(self) -> bool:
        return not any(r.failed for r in self.results)

    @property
    def regressions(self) -> List[MetricResult]:
        return [r for r in self.results if r.failed]


@dataclasses.dataclass
class TrajectoryReport:
    files: List[FileReport] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(f.ok for f in self.files)

    @property
    def regressions(self) -> List[MetricResult]:
        return [r for f in self.files for r in f.regressions]

    # ------------------------------------------------------------------ #
    def to_markdown(self) -> str:
        """Render the whole comparison as a markdown report."""
        lines = ["# Perf trajectory report", ""]
        lines.append("**PASS** — no metric left its tolerance band."
                     if self.ok else
                     f"**FAIL** — {len(self.regressions)} metric(s) "
                     "regressed past their tolerance bands.")
        lines.append("")
        for f in self.files:
            lines.append(f"## {f.name}")
            lines.append("")
            if f.skipped is not None:
                lines.append(f"_skipped: {f.skipped}_")
                lines.append("")
                continue
            lines.append("| metric | baseline | fresh | Δ | band |"
                         " status |")
            lines.append("|---|---:|---:|---:|---|---|")
            for r in f.results:
                delta = ("" if r.delta_pct is None
                         else f"{r.delta_pct:+.1f}%")
                base = "" if r.baseline is None else f"{r.baseline:g}"
                fresh = "" if r.fresh is None else f"{r.fresh:g}"
                status = {"regressed": "**REGRESSED**",
                          "missing": "**MISSING**"}.get(r.status,
                                                        r.status)
                lines.append(f"| `{r.path}` | {base} | {fresh} | "
                             f"{delta} | {r.band} | {status} |")
            lines.append("")
        return "\n".join(lines)


# --------------------------------------------------------------------------- #
def lookup(doc: Any, path: str) -> Any:
    """Resolve a dotted path; integer segments index into lists.
    Raises ``KeyError`` when any segment is absent."""
    cur = doc
    for seg in path.split("."):
        if isinstance(cur, list):
            try:
                cur = cur[int(seg)]
            except (ValueError, IndexError) as e:
                raise KeyError(path) from e
        elif isinstance(cur, dict):
            if seg not in cur:
                raise KeyError(path)
            cur = cur[seg]
        else:
            raise KeyError(path)
    return cur


def _as_float(v: Any) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    return float(v)


def compare_metrics(baseline: dict, fresh: dict,
                    specs: Sequence[MetricSpec]) -> List[MetricResult]:
    """Evaluate every spec against (baseline, fresh) documents."""
    out: List[MetricResult] = []
    for spec in specs:
        band = (f"{spec.direction}-is-better, rel {spec.rel_tol:g}"
                + (f", abs {spec.abs_tol:g}" if spec.abs_tol else ""))
        try:
            b = _as_float(lookup(baseline, spec.path))
        except (KeyError, TypeError, ValueError):
            # Baseline predates this metric: record, never fail.
            try:
                f = _as_float(lookup(fresh, spec.path))
            except (KeyError, TypeError, ValueError):
                f = None
            out.append(MetricResult(spec.path, "new", None, f,
                                    band=band, note=spec.note))
            continue
        try:
            f = _as_float(lookup(fresh, spec.path))
        except (KeyError, TypeError, ValueError):
            out.append(MetricResult(
                spec.path, "missing", b, None, band=band,
                note=spec.note or "metric disappeared from fresh run"))
            continue
        delta_pct = ((f - b) / abs(b) * 100.0) if b else None
        if spec.direction == "higher":
            floor = b * (1.0 - spec.rel_tol) - spec.abs_tol
            status = ("regressed" if f < floor
                      else "improved" if f > b else "ok")
        else:
            ceil = b * (1.0 + spec.rel_tol) + spec.abs_tol
            status = ("regressed" if f > ceil
                      else "improved" if f < b else "ok")
        out.append(MetricResult(spec.path, status, b, f,
                                delta_pct=delta_pct, band=band,
                                note=spec.note))
    return out


def compare_docs(name: str, baseline: Optional[dict],
                 fresh: Optional[dict],
                 specs: Sequence[MetricSpec]) -> FileReport:
    """Compare one benchmark document pair, honoring the mode guard."""
    if baseline is None:
        return FileReport(name, skipped="no committed baseline")
    if fresh is None:
        return FileReport(name, skipped="no fresh run produced this file")
    bm, fm = baseline.get("mode"), fresh.get("mode")
    if bm != fm:
        return FileReport(
            name, skipped=f"mode mismatch (baseline {bm!r} vs fresh "
                          f"{fm!r}): not comparable")
    return FileReport(name, results=compare_metrics(baseline, fresh,
                                                    specs))


def _load(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def compare_dirs(baseline_dir: str, fresh_dir: str,
                 registry: Optional[Dict[str, List[MetricSpec]]] = None,
                 files: Optional[Sequence[str]] = None
                 ) -> TrajectoryReport:
    """Compare every registered benchmark file present in either dir."""
    registry = registry if registry is not None else DEFAULT_SPECS
    names = list(files) if files else sorted(registry)
    report = TrajectoryReport()
    for name in names:
        specs = registry.get(name)
        if specs is None:
            report.files.append(FileReport(
                name, skipped="no metric specs registered"))
            continue
        report.files.append(compare_docs(
            name, _load(os.path.join(baseline_dir, name)),
            _load(os.path.join(fresh_dir, name)), specs))
    return report


# --------------------------------------------------------------------------- #
# The committed trajectory: per-file tolerance bands.
#
# Wall-clock metrics (throughput, percentile latencies, speedups) carry
# wide relative bands — CI hosts vary ~2-3x — chosen so only an
# order-of-magnitude collapse fails the gate.  Semantic metrics (hit
# rates, batching pass counts, identity flags, dropped/misrouted
# counts, deterministic streaming byte counters) are tight: they only
# move when behavior changes.
# --------------------------------------------------------------------------- #
DEFAULT_SPECS: Dict[str, List[MetricSpec]] = {
    "BENCH_serve.json": [
        MetricSpec("traffic.same_key.batched_speedup", "higher", 0.9,
                   note="batching collapse would show here first"),
        MetricSpec("traffic.mixed.batched_speedup", "higher", 0.9),
        MetricSpec("traffic.same_key.batched.throughput_rps",
                   "higher", 0.9),
        MetricSpec("traffic.same_key.batched.p99_ms", "lower", 9.0),
        MetricSpec("traffic.same_key.batched.cache_hit_rate",
                   "higher", 0.0, 0.01,
                   note="repeat traffic must stay fully cached"),
        MetricSpec("traffic.mixed.batched.cache_hit_rate",
                   "higher", 0.0, 0.01),
        MetricSpec("traffic.same_key.batched.binary_passes",
                   "lower", 0.0, 0.0,
                   note="more passes = coalescing broke"),
        MetricSpec("traffic.same_key.batched.batch_occupancy",
                   "higher", 0.0, 0.01),
        MetricSpec("verify.checks_passed", "higher", 0.0, 0.0,
                   note="static verifier coverage must never shrink"),
        MetricSpec("verify.checks_failed", "lower", 0.0, 0.0,
                   note="shipped programs must verify clean"),
    ],
    "BENCH_sample.json": [
        MetricSpec("bucketed_speedup", "higher", 0.9),
        MetricSpec("bucketed_batched.throughput_rps", "higher", 0.9),
        MetricSpec("bucketed_batched.p50_ms", "lower", 9.0),
        MetricSpec("bucketed_batched.p99_ms", "lower", 9.0),
        MetricSpec("bucketed_batched.cache_hit_rate", "higher",
                   0.0, 0.02,
                   note="bucketing must keep cache keys colliding"),
        MetricSpec("bucketed_batched.mean_batch_size", "higher", 0.5),
        MetricSpec("verify.checks_passed", "higher", 0.0, 0.0,
                   note="static verifier coverage must never shrink"),
        MetricSpec("verify.checks_failed", "lower", 0.0, 0.0,
                   note="shipped programs must verify clean"),
    ],
    "BENCH_live.json": [
        MetricSpec("cutover.dropped", "lower", 0.0, 0.0,
                   note="zero-downtime contract"),
        MetricSpec("cutover.misrouted", "lower", 0.0, 0.0,
                   note="zero-downtime contract"),
        MetricSpec("cutover.compiles", "lower", 0.0, 0.0,
                   note="cutovers must rebind, never recompile"),
        MetricSpec("cutover.versions_reclaimed", "higher", 0.0, 0.0,
                   note="drained retirees must be reclaimed"),
        MetricSpec("updates.1.speedup", "higher", 0.9),
        MetricSpec("updates.1.retention", "higher", 0.0, 0.05,
                   note="single-edge delta must retain ~all tiles"),
        MetricSpec("updates.16.retention", "higher", 0.0, 0.15),
        MetricSpec("verify.checks_passed", "higher", 0.0, 0.0,
                   note="static verifier coverage must never shrink"),
        MetricSpec("verify.checks_failed", "lower", 0.0, 0.0,
                   note="shipped programs must verify clean"),
    ],
    "BENCH_fullgraph.json": [
        MetricSpec("models.0.mesh.bit_identical_to_host", "higher",
                   0.0, 0.0, note="mesh equivalence flag"),
        MetricSpec("models.0.host_under_budget.completed", "higher",
                   0.0, 0.0,
                   note="streaming path must fit the budget"),
        MetricSpec("models.0.device_under_budget.completed", "lower",
                   0.0, 0.0,
                   note="device path must keep refusing over-budget "
                        "runs"),
        MetricSpec("models.0.placement.load_imbalance", "lower", 0.5),
        MetricSpec("models.0.host_under_budget.peak_stage_bytes",
                   "lower", 0.1,
                   note="deterministic double-buffered window size"),
        MetricSpec("models.0.host_under_budget.shards_streamed",
                   "lower", 0.0, 0.0,
                   note="deterministic shard schedule length"),
        MetricSpec("models.0.host_under_budget.h2d_bytes",
                   "lower", 0.1,
                   note="deterministic staging traffic"),
        # Cost-model conformance (repro_torch.obs.conformance): normalized
        # RMSE of predicted vs measured per-layer time, per kernel
        # mode.  Bands are asymmetric and generous — wall time on CI
        # hosts is noisy — but a model that drifts to ~3x its committed
        # error has genuinely decoupled from the executor and fails.
        MetricSpec("models.0.conformance.model_error.gemm",
                   "lower", 2.0, 0.5,
                   note="cost-model drift, GEMM mode"),
        MetricSpec("models.0.conformance.model_error.spdmm",
                   "lower", 2.0, 0.5,
                   note="cost-model drift, SpDMM mode"),
        MetricSpec("models.0.conformance.model_error_overall",
                   "lower", 2.0, 0.5,
                   note="cost-model drift, all modes"),
        # rel 1.0: the gain's magnitude tracks run noise, only its SIGN
        # is the invariant — fail when calibration stops reducing the
        # error (fresh < baseline·0 - 0.05, i.e. gain goes negative)
        MetricSpec("models.0.conformance.calibration_gain",
                   "higher", 1.0, 0.05,
                   note="LS calibration must keep reducing model error"),
        # Sparsity-adaptive remapping (repro_torch.core.passes.remap): the
        # re-encoded program must stay at least as fast as the
        # canonical one (wide band — wall clock), and must stay
        # bit-identical across the device/streaming/mesh paths
        # (zero-width — semantic flag).
        MetricSpec("models.0.remap.remap_speedup", "higher", 0.5,
                   note="remapped program must not regress vs "
                        "canonical SpDMM encoding"),
        MetricSpec("models.0.remap.remap_bit_identical", "higher",
                   0.0, 0.0,
                   note="remapped outputs must match the baseline "
                        "across residency paths"),
        MetricSpec("verify.checks_passed", "higher", 0.0, 0.0,
                   note="static verifier coverage must never shrink"),
        MetricSpec("verify.checks_failed", "lower", 0.0, 0.0,
                   note="shipped programs must verify clean"),
    ],
}
