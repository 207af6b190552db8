"""Structured tracing for the GraphAGILE stack.

The paper's whole argument is a *latency decomposition* — T_LoC
(software compilation) vs T_LoH (data loading/execution) and the
compiler's ability to overlap them — so the observability layer records
exactly that: nestable spans (compile passes, shard staging, tile
compute, halo exchange, request lifecycle phases), counters, and
instant events, on named tracks per device / residency path.

Export is Chrome trace-event JSON (the ``traceEvents`` array format),
directly openable in https://ui.perfetto.dev or ``chrome://tracing``:

    from repro_torch.obs import enable_tracing
    tracer = enable_tracing()
    ...   # any engine / runtime / sampling work
    tracer.save("trace.json")          # -> load in ui.perfetto.dev
    tracer.summary()                   # -> plain-dict rollup

Design constraints:

* **Zero overhead when disabled.**  ``get_tracer()`` returns a
  process-wide :class:`NullTracer` singleton unless tracing was
  enabled; its ``span`` hands back one shared no-op context manager,
  so instrumented hot paths cost one attribute load + one truthiness
  check.  Instrumentation sites may also guard expensive ``args``
  construction behind ``tracer.enabled``.
* **Thread safety.**  The serving loop runs per-overlay worker
  threads; spans carry the recording thread's identity, so concurrent
  spans land on separate tracks and never need cross-thread nesting.
  Event append takes a lock only at span *end* (one append per span).
* **No heavy imports.**  Pure stdlib — ``repro_torch.core`` (which must not
  depend on jax-importing modules at import time) can instrument
  freely.

Chrome trace-event specifics: spans are emitted as ``"X"`` (complete)
events with microsecond ``ts``/``dur`` relative to tracer start;
tracks are (pid=1, tid) pairs named via ``thread_name`` metadata
events.  Fractional microseconds are allowed by both viewers.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Tracer", "NullTracer", "get_tracer", "set_tracer",
    "enable_tracing", "disable_tracing", "tracing",
]


class _Span:
    """One open span; context manager, or end explicitly with
    :meth:`done`.  ``add(**kv)`` attaches args discovered mid-span
    (e.g. bytes counted while staging)."""

    __slots__ = ("_tracer", "name", "cat", "args", "track", "_t0",
                 "_closed")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict], track: Optional[str]) -> None:
        self._tracer = tracer
        self.name, self.cat, self.track = name, cat, track
        self.args = dict(args) if args else {}
        self._t0 = time.perf_counter_ns()
        self._closed = False

    def add(self, **kv: Any) -> "_Span":
        self.args.update(kv)
        return self

    def done(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._tracer._emit_complete(
            self.name, self.cat, self._t0, time.perf_counter_ns(),
            self.args, self.track)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.done()


class _NullSpan:
    """Shared, reusable no-op span (the disabled-path object)."""

    __slots__ = ()

    def add(self, **kv: Any) -> "_NullSpan":
        return self

    def done(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """API-complete no-op: every instrumentation site stays branch-free
    whether tracing is on or off."""

    enabled = False

    def span(self, name: str, cat: str = "", args: Optional[dict] = None,
             track: Optional[str] = None) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None,
                track: Optional[str] = None) -> None:
        pass

    def counter(self, name: str, value: float,
                track: Optional[str] = None) -> None:
        pass

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 cat: str = "", args: Optional[dict] = None,
                 track: Optional[str] = None) -> None:
        pass

    def now_ns(self) -> int:
        return 0

    def to_dict(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def summary(self) -> dict:
        return {"enabled": False, "events": 0, "spans": {}}

    def save(self, path: str) -> None:
        raise RuntimeError(
            "tracing is disabled; call repro_torch.obs.enable_tracing() first")


class Tracer:
    """Thread-safe trace recorder; see module docstring."""

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._t0 = time.perf_counter_ns()
        # track name -> synthetic tid; real threads claim a tid from the
        # same space so named tracks and worker threads never collide.
        self._tracks: Dict[str, int] = {}
        self._thread_tids: Dict[int, int] = {}
        self._next_tid = 1

    # ------------------------------------------------------------------ #
    def now_ns(self) -> int:
        """Timestamp in the tracer's clock (for :meth:`complete`)."""
        return time.perf_counter_ns()

    def _us(self, t_ns: int) -> float:
        return (t_ns - self._t0) / 1e3

    def _tid(self, track: Optional[str]) -> int:
        # caller holds the lock
        if track is not None:
            tid = self._tracks.get(track)
            if tid is None:
                tid = self._next_tid
                self._next_tid += 1
                self._tracks[track] = tid
                self._events.append({
                    "ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid, "args": {"name": track}})
            return tid
        ident = threading.get_ident()
        tid = self._thread_tids.get(ident)
        if tid is None:
            tid = self._next_tid
            self._next_tid += 1
            self._thread_tids[ident] = tid
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": threading.current_thread().name}})
        return tid

    # ------------------------------------------------------------------ #
    def span(self, name: str, cat: str = "", args: Optional[dict] = None,
             track: Optional[str] = None) -> _Span:
        """Open a span; close it via ``with`` or ``.done()``.  Spans on
        one track nest by timestamps (Perfetto infers the tree from
        containment of complete events)."""
        return _Span(self, name, cat, args, track)

    def _emit_complete(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                       args: dict, track: Optional[str]) -> None:
        with self._lock:
            self._events.append({
                "ph": "X", "name": name, "cat": cat or "default",
                "pid": 1, "tid": self._tid(track),
                "ts": self._us(t0_ns),
                "dur": max((t1_ns - t0_ns) / 1e3, 0.001),
                "args": args})

    def complete(self, name: str, t0_ns: int, t1_ns: int,
                 cat: str = "", args: Optional[dict] = None,
                 track: Optional[str] = None) -> None:
        """Record a span retroactively from explicit ``perf_counter_ns``
        endpoints — how cross-thread phases (queue wait measured at
        admission, closed by a worker) become spans."""
        self._emit_complete(name, cat, t0_ns, t1_ns,
                            dict(args) if args else {}, track)

    def instant(self, name: str, cat: str = "",
                args: Optional[dict] = None,
                track: Optional[str] = None) -> None:
        t = time.perf_counter_ns()
        with self._lock:
            self._events.append({
                "ph": "i", "s": "t", "name": name,
                "cat": cat or "default", "pid": 1,
                "tid": self._tid(track), "ts": self._us(t),
                "args": dict(args) if args else {}})

    def counter(self, name: str, value: float,
                track: Optional[str] = None) -> None:
        t = time.perf_counter_ns()
        with self._lock:
            self._events.append({
                "ph": "C", "name": name, "pid": 1,
                "tid": self._tid(track), "ts": self._us(t),
                "args": {"value": value}})

    # ------------------------------------------------------------------ #
    def events(self) -> List[dict]:
        """Snapshot of recorded events (copy; safe to mutate)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def to_dict(self) -> dict:
        """Chrome/Perfetto trace-event JSON as a plain dict."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        """Write ``trace.json``; open it at https://ui.perfetto.dev."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    def summary(self) -> dict:
        """Plain-dict rollup: per span name, count / total / max ms —
        the cheap view when no trace viewer is at hand."""
        spans: Dict[str, dict] = {}
        counters: Dict[str, float] = {}
        n = 0
        for e in self.events():
            n += 1
            if e["ph"] == "X":
                s = spans.setdefault(e["name"], {
                    "count": 0, "total_ms": 0.0, "max_ms": 0.0,
                    "cat": e.get("cat", "")})
                d_ms = e["dur"] / 1e3
                s["count"] += 1
                s["total_ms"] = round(s["total_ms"] + d_ms, 6)
                s["max_ms"] = round(max(s["max_ms"], d_ms), 6)
            elif e["ph"] == "C":
                counters[e["name"]] = e["args"]["value"]
        return {"enabled": True, "events": n, "spans": spans,
                "counters": counters}


# --------------------------------------------------------------------------- #
# Process-wide tracer registry.
# --------------------------------------------------------------------------- #
_NULL = NullTracer()
_current: Any = _NULL
_reg_lock = threading.Lock()


def get_tracer() -> Any:
    """The active tracer (a :class:`NullTracer` unless enabled)."""
    return _current


def set_tracer(tracer: Optional[Any]) -> Any:
    """Install ``tracer`` (``None`` -> the null tracer); returns the
    previously active one (for restore)."""
    global _current
    with _reg_lock:
        prev = _current
        _current = tracer if tracer is not None else _NULL
        return prev


def enable_tracing() -> Tracer:
    """Install and return a fresh :class:`Tracer`."""
    t = Tracer()
    set_tracer(t)
    return t


def disable_tracing() -> None:
    """Back to the zero-overhead null tracer."""
    set_tracer(None)


class tracing:
    """``with tracing() as t: ...`` — scoped enable, restores the
    previous tracer on exit (exception-safe)."""

    def __init__(self) -> None:
        self.tracer = Tracer()
        self._prev: Any = None

    def __enter__(self) -> Tracer:
        self._prev = set_tracer(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> None:
        set_tracer(self._prev)
