"""repro_torch.obs — observability for the port (the exports of
``repro.obs``).

* :mod:`~repro_torch.obs.tracer` — structured tracing exported as
  Chrome/Perfetto trace-event JSON; zero overhead when disabled.
* :mod:`~repro_torch.obs.attrib` — trace analysis: span DAG, critical
  path, per-span slack/stall, the per-(layer, tile-block, kernel-mode)
  attribution table.
* :mod:`~repro_torch.obs.conformance` — measured-vs-predicted cost
  accounting against :mod:`repro_torch.core.perfmodel`, and effective
  machine constants fitted from a run.
* :mod:`~repro_torch.obs.trajectory` — per-metric tolerance-band
  comparison of benchmark JSON documents.
"""
from .attrib import Span, TraceDAG, attribution_table, build_dag, \
    parse_spans
from .conformance import (ConformanceReport, build_report, fit_stage_bw,
                          ls_scale, nrmse)
from .tracer import (NullTracer, Tracer, disable_tracing,
                     enable_tracing, get_tracer, set_tracer, tracing)
from .trajectory import (DEFAULT_SPECS, FileReport, MetricResult,
                         MetricSpec, TrajectoryReport, compare_dirs,
                         compare_docs, compare_metrics, lookup)

__all__ = [
    "Tracer", "NullTracer", "get_tracer", "set_tracer",
    "enable_tracing", "disable_tracing", "tracing",
    "Span", "TraceDAG", "parse_spans", "build_dag",
    "attribution_table",
    "ConformanceReport", "build_report", "ls_scale", "nrmse",
    "fit_stage_bw",
    "MetricSpec", "MetricResult", "FileReport", "TrajectoryReport",
    "DEFAULT_SPECS", "compare_metrics", "compare_docs", "compare_dirs",
    "lookup",
]
