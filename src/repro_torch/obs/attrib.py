"""Trace attribution: span DAG, critical path, and measured accounting.

A copy of ``repro/obs/attrib.py`` (pure stdlib; a test holds the two
equal on the same trace).  Consumes the Chrome/Perfetto trace-event JSON
the :mod:`repro_torch.obs.tracer` emits and turns it back into
*structure*:

* :func:`parse_spans` — the ``"X"`` complete events as :class:`Span`
  records with resolved track names;
* :func:`build_dag` — a :class:`TraceDAG`: the per-track containment
  forest (Perfetto infers nesting from timestamp containment; we make it
  explicit) plus dependency edges — previous-sibling order on each
  track, and the executor's cross-track producer edges (a ``stage`` span
  feeds the ``compute`` span of the same ``(layer, shard)``);
* :meth:`TraceDAG.critical_path` — the backward last-to-finish walk:
  from the last span to end, through the child that delayed each end and
  the gate (sibling / producer / parent) that delayed each start.  Its
  total is what the scoreboard-issue refactor is bounded by;
* :meth:`TraceDAG.slack_us` / :meth:`TraceDAG.stall_us` — per-span CPM
  slack (how far a span's finish could slip without moving the
  makespan) and *induced stall* (time a producer span kept its consumer
  waiting beyond the consumer's other gates — ≈0 for every ``stage``
  span when the double-buffer overlap works, the exposed staging time
  when it does not);
* :func:`attribution_table` — the measured per-(layer, tile-block,
  kernel-mode) accounting: wall time, tile ops, and staged bytes from
  the executor's spans, joined back to decoded instruction index ranges.

Everything here is pure stdlib over plain dicts, so saved ``trace.json``
files from other processes analyze the same as live ``tracer.events()``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "Span", "TraceDAG", "parse_spans", "build_dag", "attribution_table",
]

# containment / ordering fuzz for float-µs timestamps
_EPS = 2e-3


@dataclasses.dataclass
class Span:
    """One complete ("X") trace event, with graph fields filled by
    :func:`build_dag`."""

    index: int
    name: str
    cat: str
    tid: int
    track: str
    ts: float                 # µs from trace start
    dur: float                # µs
    args: Dict[str, Any]
    parent: Optional[int] = None
    children: List[int] = dataclasses.field(default_factory=list)

    @property
    def end(self) -> float:
        return self.ts + self.dur


def _event_list(trace: Union[dict, Sequence[dict], str]) -> List[dict]:
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return list(trace)


def parse_spans(trace: Union[dict, Sequence[dict], str]) -> List[Span]:
    """Complete events of a trace (dict / event list / path to JSON) as
    :class:`Span` records, sorted by start time."""
    events = _event_list(trace)
    tracks: Dict[int, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tracks[e["tid"]] = e.get("args", {}).get("name", "")
    spans = [
        Span(index=0, name=e["name"], cat=e.get("cat", ""),
             tid=e.get("tid", 0),
             track=tracks.get(e.get("tid", 0), str(e.get("tid", 0))),
             ts=float(e["ts"]), dur=float(e.get("dur", 0.0)),
             args=dict(e.get("args", {})))
        for e in events if e.get("ph") == "X"
    ]
    spans.sort(key=lambda s: (s.ts, -s.dur))
    for i, s in enumerate(spans):
        s.index = i
    return spans


class TraceDAG:
    """Span containment forest + dependency edges over one trace."""

    def __init__(self, spans: List[Span]) -> None:
        self.spans = spans
        n = len(spans)
        self.prev_sibling: List[Optional[int]] = [None] * n
        self.producers: List[List[int]] = [[] for _ in range(n)]
        self.consumers: List[List[int]] = [[] for _ in range(n)]
        self._build_forest()
        self._link_producers()

    # -------------------------------------------------------------- #
    def _build_forest(self) -> None:
        by_tid: Dict[int, List[Span]] = {}
        for s in self.spans:
            by_tid.setdefault(s.tid, []).append(s)
        for group in by_tid.values():
            stack: List[Span] = []          # open ancestors
            last_child_of: Dict[Optional[int], int] = {}
            for s in group:                 # already (ts, -dur) sorted
                while stack and stack[-1].end <= s.ts + _EPS:
                    stack.pop()
                parent = stack[-1] if stack else None
                if parent is not None and s.end > parent.end + _EPS:
                    parent = None           # overlap, not containment
                if parent is not None:
                    s.parent = parent.index
                    parent.children.append(s.index)
                prev = last_child_of.get(
                    parent.index if parent else None)
                if prev is not None:
                    self.prev_sibling[s.index] = prev
                last_child_of[parent.index if parent else None] = s.index
                stack.append(s)

    def _link_producers(self) -> None:
        """Executor cross-track edges: a ``stage`` span produces the
        working set its same-(layer, shard) ``compute`` span consumes."""
        stages: Dict[Tuple[Any, Any], int] = {}
        for s in self.spans:
            if s.name == "stage" and "shard" in s.args:
                stages[(s.args.get("layer"), s.args["shard"])] = s.index
        for s in self.spans:
            if s.name == "compute" and "shard" in s.args:
                p = stages.get((s.args.get("layer"), s.args["shard"]))
                if p is not None:
                    self._add_edge(p, s.index)

    def _add_edge(self, producer: int, consumer: int) -> None:
        if producer not in self.producers[consumer]:
            self.producers[consumer].append(producer)
            self.consumers[producer].append(consumer)

    # -------------------------------------------------------------- #
    def _start_gates(self, i: int) -> List[int]:
        """Spans that gate span ``i``'s start (sibling order + producer
        edges); the containment parent is handled separately."""
        g = []
        if self.prev_sibling[i] is not None:
            g.append(self.prev_sibling[i])
        g.extend(self.producers[i])
        return g

    @property
    def makespan_us(self) -> float:
        return max((s.end for s in self.spans), default=0.0)

    def _last_predecessor(self, cur: int, visited: set
                          ) -> Optional[int]:
        """Latest-ending unvisited span that finished by the time
        ``cur`` started — the classic retrospective "what had just
        finished when this could start" fallback that bridges
        cross-track waits no explicit edge records."""
        sp = self.spans
        limit = sp[cur].ts + _EPS
        lo, hi = 0, len(self._by_end)
        while lo < hi:
            mid = (lo + hi) // 2
            if sp[self._by_end[mid]].end <= limit:
                lo = mid + 1
            else:
                hi = mid
        for pos in range(lo - 1, -1, -1):
            i = self._by_end[pos]
            if i not in visited:
                return i
        return None

    def critical_path(self) -> List[Span]:
        """Backward last-to-finish walk: start from the span that ends
        last; a span's end is explained by its last-ending child, a
        span's start by its latest-ending gate (previous sibling,
        producer, or the last span to finish anywhere before it
        started), falling back to its containment parent."""
        if not self.spans:
            return []
        sp = self.spans
        if not hasattr(self, "_by_end"):
            self._by_end = sorted(range(len(sp)),
                                  key=lambda i: sp[i].end)
        cur = max(range(len(sp)), key=lambda i: sp[i].end)
        path, visited = [cur], {cur}
        via_end = True
        while True:
            nxt: Optional[int] = None
            if via_end:
                ch = [c for c in sp[cur].children if c not in visited]
                if ch:
                    nxt = max(ch, key=lambda i: sp[i].end)
            via_end = True
            if nxt is None:
                gates = [g for g in self._start_gates(cur)
                         if g not in visited]
                fb = self._last_predecessor(cur, visited)
                if fb is not None:
                    gates.append(fb)
                if gates:
                    nxt = max(gates, key=lambda i: sp[i].end)
                elif (sp[cur].parent is not None
                        and sp[cur].parent not in visited):
                    nxt = sp[cur].parent
                    via_end = False     # explain the PARENT's start next
                else:
                    break
            path.append(nxt)
            visited.add(nxt)
            cur = nxt
        path.reverse()
        return [sp[i] for i in path]

    def slack_us(self) -> List[float]:
        """Per-span CPM slack: how much later the span could have
        finished without moving any downstream start constraint (next
        sibling start, consumer start, parent end) or the makespan."""
        sp = self.spans
        makespan = self.makespan_us
        next_sibling: List[Optional[int]] = [None] * len(sp)
        for i, prev in enumerate(self.prev_sibling):
            if prev is not None:
                next_sibling[prev] = i
        out = []
        for s in sp:
            limits = [makespan]
            if next_sibling[s.index] is not None:
                limits.append(sp[next_sibling[s.index]].ts)
            for c in self.consumers[s.index]:
                limits.append(sp[c].ts)
            if s.parent is not None:
                limits.append(sp[s.parent].end)
            out.append(max(0.0, min(limits) - s.end))
        return out

    def stall_us(self) -> List[float]:
        """Per-span *induced stall*: time this span kept a consumer
        waiting beyond the consumer's other start gates.  A ``stage``
        span whose transfer hid entirely under the previous shard's
        compute induces ~0 stall; a stage that out-lived it exposes the
        difference as stall — the quantified overlap-failure signal."""
        sp = self.spans
        out = [0.0] * len(sp)
        for c in range(len(sp)):
            gates = self._start_gates(c)
            if not gates:
                continue
            ends = {g: sp[g].end for g in gates}
            for g in gates:
                others = [e for k, e in ends.items() if k != g]
                if sp[c].parent is not None:
                    others.append(sp[sp[c].parent].ts)
                baseline = max(others) if others else sp[g].ts
                out[g] += max(0.0, min(sp[g].end, sp[c].ts + _EPS)
                              - max(baseline, sp[g].ts))
        return out

    def summary(self) -> dict:
        """Plain-dict rollup for reports: makespan, the critical path
        (name, track, dur), and the top stall contributors."""
        cp = self.critical_path()
        stalls = self.stall_us()
        by_name: Dict[str, float] = {}
        for s, st in zip(self.spans, stalls):
            if st > 0:
                by_name[s.name] = by_name.get(s.name, 0.0) + st
        # Path length as the UNION of the path spans' intervals, so a
        # parent and the children explaining its end don't double count.
        covered = 0.0
        end = -1.0
        for s in sorted(cp, key=lambda s: s.ts):
            covered += max(0.0, s.end - max(s.ts, end))
            end = max(end, s.end)
        return {
            "makespan_us": round(self.makespan_us, 3),
            "n_spans": len(self.spans),
            "critical_path": [
                {"name": s.name, "track": s.track,
                 "dur_us": round(s.dur, 3)} for s in cp],
            "critical_path_us": round(covered, 3),
            "stall_us_by_name": {k: round(v, 3)
                                 for k, v in sorted(by_name.items())},
        }


def build_dag(trace: Union[dict, Sequence[dict], str]) -> TraceDAG:
    """Parse a trace and reconstruct its span DAG."""
    return TraceDAG(parse_spans(trace))


def attribution_table(trace: Union[dict, Sequence[dict], str]
                      ) -> List[dict]:
    """Measured per-(layer, tile-block, kernel-mode) accounting.

    Layer rows aggregate the executor's ``layer<id>`` spans per
    (track, layer, kernel): wall µs, tile ops, staged bytes (joined
    from same-layer ``stage`` spans) and halo-exchange bytes (mesh),
    each attributable back to the decoded instruction index range the
    span carries.  Host-streaming ``compute`` spans additionally yield
    per-shard tile-block rows (``"shard"`` set, layer row otherwise).
    """
    spans = parse_spans(trace)
    halo_by_layer: Dict[Any, int] = {}
    for s in spans:
        if s.name == "halo_exchange" and "layer" in s.args:
            halo_by_layer[s.args["layer"]] = (
                halo_by_layer.get(s.args["layer"], 0)
                + int(s.args.get("bytes", 0)))
    rows: Dict[Tuple, dict] = {}
    for s in spans:
        a = s.args
        if s.name.startswith("layer") and "kernel" in a:
            lid = a.get("step"), int(s.name[5:])
            key = (s.track, lid[1], a["kernel"], None)
            r = rows.setdefault(key, {
                "track": s.track, "layer": lid[1], "shard": None,
                "kernel": a["kernel"], "step": a.get("step"),
                "instr_lo": a.get("instr_lo", -1),
                "instr_hi": a.get("instr_hi", -1),
                "wall_us": 0.0, "tile_ops": 0, "staged_bytes": 0,
                "halo_bytes": 0})
            r["wall_us"] += s.dur
            r["tile_ops"] += int(a.get("tile_ops", 0))
            r["staged_bytes"] += int(a.get("h2d_bytes", 0))
            r["halo_bytes"] = halo_by_layer.get(lid[1], 0)
        elif s.name == "compute" and "shard" in a:
            key = (s.track, a.get("layer"), None, a["shard"])
            r = rows.setdefault(key, {
                "track": s.track, "layer": a.get("layer"),
                "shard": a["shard"], "kernel": None, "step": None,
                "instr_lo": -1, "instr_hi": -1, "wall_us": 0.0,
                "tile_ops": 0, "staged_bytes": 0, "halo_bytes": 0})
            r["wall_us"] += s.dur
            r["tile_ops"] += int(a.get("tiles", 0))
            r["staged_bytes"] += int(a.get("staged_bytes", 0))
    out = sorted(rows.values(),
                 key=lambda r: (r["track"], r["step"] is None,
                                r["step"] or 0, r["shard"] or 0))
    for r in out:
        r["wall_us"] = round(r["wall_us"], 3)
    return out
