"""Dynamic race detector — recorded trace order vs static hazard edges.

(The port's copy of ``repro/verify/race.py``.)  The static analyzer
(:mod:`repro_torch.verify.checks`) proves what *must* happen-before
what; the tracer (:mod:`repro_torch.obs.tracer`) records what *did*.
This module cross-checks the two: every RAW layer edge in the
``dep_graph`` manifest section must appear in the trace as
producer-span-ends-before-consumer-span-starts, every streamed shard's
compute window must be preceded by its own h2d stage span, and no
layer's execution may overlap that layer's halo exchange (the gather is
a barrier — compute reading half-exchanged sub-fibers is the mesh
path's one true race).

Order violations are reported through the same :class:`VerifyReport`
machinery as the static checks, under check names:

  race_layer_order          RAW layer edge inverted/overlapped
  race_stage_before_compute compute window opened before its working
                            set finished staging
  race_halo_barrier         layer execution overlaps its halo exchange

``stats["overlap_pairs"]`` counts stage(j')-inside-compute(j) windows
(j' != j) — the double-buffer overlap the streaming path exists for, so
a healthy host-streaming trace shows a positive count here with zero
violations.

On a CUDA device the port's ``stage`` and ``compute`` spans are host
clock times of when the copies and the kernels were *issued*; the
device orders them by a CUDA event the compute stream waits on
(``BinaryExecutor._stream_shards``).  On such a trace
``race_stage_before_compute`` proves issue order only, and
``overlap_pairs`` counts issue windows, not copies overlapping kernels
on the card (``torch.profiler`` reads that).  On the CPU, spans are the
work itself.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from .report import VerifyReport

# Two spans touching end-to-start is legal ordering; only a genuine
# inversion/overlap beyond float-roundoff fires.
_EPS_US = 1e-6

_LAYER_RE = re.compile(r"^layer(\d+)$")


class _Span:
    __slots__ = ("name", "cat", "t0", "t1", "track", "args")

    def __init__(self, ev: dict, track: str) -> None:
        self.name = ev.get("name", "")
        self.cat = ev.get("cat", "")
        self.t0 = float(ev.get("ts", 0.0))
        self.t1 = self.t0 + float(ev.get("dur", 0.0))
        self.track = track
        self.args = ev.get("args") or {}


def _load_events(trace: Any) -> List[dict]:
    """Accept a Tracer, a trace dict, a raw event list, or a
    ``trace.json`` path."""
    if hasattr(trace, "to_dict"):
        trace = trace.to_dict()
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        return list(trace.get("traceEvents", []))
    return list(trace)


def _spans(events: List[dict]) -> List[_Span]:
    tracks: Dict[int, str] = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            tracks[ev.get("tid", 0)] = ev.get("args", {}).get("name", "")
    out = [_Span(ev, tracks.get(ev.get("tid", 0), ""))
           for ev in events if ev.get("ph") == "X"]
    out.sort(key=lambda s: s.t0)
    return out


def _layer_edges_of(manifest: Optional[dict]) -> List[Tuple[int, int]]:
    dg = (manifest or {}).get("dep_graph") or {}
    return [(int(a), int(b)) for a, b, kind in dg.get("layer_edges", [])
            if kind == "RAW" and a >= 0]


def check_trace(trace: Any, prog_or_manifest: Any = None
                ) -> VerifyReport:
    """Cross-check a recorded trace against static hazard edges.

    ``prog_or_manifest``: a :class:`CompiledProgram`, a manifest dict
    (with a ``dep_graph`` section), or ``None`` — without it the
    layer-order check is skipped and only the self-contained stage /
    halo orderings run."""
    manifest = prog_or_manifest
    if manifest is not None and hasattr(manifest, "manifest"):
        manifest = manifest.manifest
    report = VerifyReport(program=(manifest or {}).get(
        "model_name", "<trace>"))
    spans = _spans(_load_events(trace))
    report.stats["n_spans"] = len(spans)

    # Index the span families the executor emits.
    layer_spans: Dict[int, List[_Span]] = {}
    stage_spans: List[_Span] = []
    compute_spans: List[_Span] = []
    halo_spans: List[_Span] = []
    for s in spans:
        m = _LAYER_RE.match(s.name)
        if m and s.cat == "exec":
            layer_spans.setdefault(int(m.group(1)), []).append(s)
        elif s.name == "stage" and s.cat == "h2d":
            stage_spans.append(s)
        elif s.name == "compute" and s.cat == "exec":
            compute_spans.append(s)
        elif s.name == "halo_exchange" and s.cat == "comm":
            halo_spans.append(s)

    # -- race_layer_order -------------------------------------------------- #
    edges = _layer_edges_of(manifest)
    if manifest is None or not edges:
        report.skip("race_layer_order",
                    "no dep_graph layer edges supplied")
    else:
        report.ran("race_layer_order")
        for prod, cons in edges:
            ps, cs = layer_spans.get(prod, []), layer_spans.get(cons, [])
            if not ps or not cs:
                continue
            # Pair per track (mesh runs emit one span per device) and
            # per round (a trace may hold many runs of the program).
            by_track: Dict[str, Tuple[List[_Span], List[_Span]]] = {}
            for s in ps:
                by_track.setdefault(s.track, ([], []))[0].append(s)
            for s in cs:
                by_track.setdefault(s.track, ([], []))[1].append(s)
            for track, (pp, cc) in sorted(by_track.items()):
                for r in range(min(len(pp), len(cc))):
                    if pp[r].t1 > cc[r].t0 + _EPS_US:
                        report.add(
                            "race_layer_order",
                            f"layer {cons} (RAW-dependent on layer "
                            f"{prod}) started at {cc[r].t0:.1f}us on "
                            f"track {track or '?'} before its producer "
                            f"finished at {pp[r].t1:.1f}us",
                            layer_id=cons,
                            instr_lo=int(cc[r].args.get("instr_lo", -1)),
                            instr_hi=int(cc[r].args.get("instr_hi", -1)))

    # -- race_stage_before_compute ----------------------------------------- #
    if not compute_spans:
        report.skip("race_stage_before_compute",
                    "trace has no streaming compute spans")
    else:
        report.ran("race_stage_before_compute")
        stages_by_key: Dict[Tuple[int, int], List[_Span]] = {}
        for s in stage_spans:
            key = (int(s.args.get("layer", -1)),
                   int(s.args.get("shard", -1)))
            stages_by_key.setdefault(key, []).append(s)
        seen_rounds: Dict[Tuple[int, int], int] = {}
        for c in compute_spans:
            key = (int(c.args.get("layer", -1)),
                   int(c.args.get("shard", -1)))
            r = seen_rounds.get(key, 0)
            seen_rounds[key] = r + 1
            stages = stages_by_key.get(key, [])
            if r >= len(stages):
                report.add(
                    "race_stage_before_compute",
                    f"compute window for layer {key[0]} shard {key[1]} "
                    "has no matching h2d stage span",
                    layer_id=key[0])
            elif stages[r].t1 > c.t0 + _EPS_US:
                report.add(
                    "race_stage_before_compute",
                    f"compute window for layer {key[0]} shard {key[1]} "
                    f"opened at {c.t0:.1f}us while its working set was "
                    f"still staging (h2d ended {stages[r].t1:.1f}us)",
                    layer_id=key[0])
        # The healthy-overlap evidence: the NEXT shard staging inside
        # the current compute window.
        overlap = 0
        for c in compute_spans:
            cl = int(c.args.get("layer", -1))
            cj = int(c.args.get("shard", -1))
            for s in stage_spans:
                if int(s.args.get("layer", -1)) != cl or \
                        int(s.args.get("shard", -1)) == cj:
                    continue
                if s.t0 < c.t1 - _EPS_US and s.t1 > c.t0 + _EPS_US:
                    overlap += 1
        report.stats["overlap_pairs"] = overlap

    # -- race_halo_barrier ------------------------------------------------- #
    if not halo_spans:
        report.skip("race_halo_barrier",
                    "trace has no halo exchange spans")
    else:
        report.ran("race_halo_barrier")
        for h in halo_spans:
            lid = int(h.args.get("layer", -1))
            for s in layer_spans.get(lid, []):
                if s.t0 < h.t1 - _EPS_US and s.t1 > h.t0 + _EPS_US:
                    report.add(
                        "race_halo_barrier",
                        f"layer {lid} executed on track "
                        f"{s.track or '?'} during its own halo "
                        f"exchange ({h.t0:.1f}..{h.t1:.1f}us) — "
                        "gather is a barrier",
                        layer_id=lid,
                        instr_lo=int(s.args.get("instr_lo", -1)),
                        instr_hi=int(s.args.get("instr_hi", -1)))
    return report
