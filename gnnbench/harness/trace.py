"""The traced stretch: a few whole passes under ``torch.profiler``,
opened and closed with no pass in flight, reduced to device time by
kernel name, the device's busy time, and the longest idle gaps labelled
by what the host was doing.  No trace file is written."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

STRETCH = "gnnbench.stretch"
# Seconds of sending in the traced stretch, then a drain: a few whole
# passes of every cell, never the whole window.
STRETCH_S = 0.25
TOP = 10


@dataclasses.dataclass
class Trace:
    kernel_s: Dict[str, float]        # device seconds by event name
    busy_s: float                     # union of device activity
    window_s: float                   # the stretch, host clock
    gaps: List[Tuple[str, float]]     # longest idle gaps, labelled
    events: int
    read_s: float                     # host time spent reading the trace


def _union(ivs) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of intervals, and the merged intervals."""
    merged: List[List[float]] = []
    for a, b in sorted(ivs):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), [(a, b) for a, b in merged]


def _label(t: float, cpu) -> str:
    """What each host thread was doing at time ``t``: its outermost and
    innermost events open then, threads apart by " | "."""
    by_thread: Dict[int, list] = {}
    for e in cpu:
        if e.time_range.start <= t <= e.time_range.end and e.name != STRETCH:
            by_thread.setdefault(e.thread, []).append(e)
    parts = []
    for _, evs in sorted(by_thread.items()):
        evs.sort(key=lambda e: e.time_range.elapsed_us())
        inner, outer = evs[0].name, evs[-1].name
        parts.append(inner if inner == outer else f"{outer} > {inner}")
    return " | ".join(parts)[:200] or "host: no event open"


def short(name: str) -> str:
    """A device event's name without its return type, argument list and
    template arguments, at most 120 characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def run(fn: Callable[[], None]) -> Trace:
    """``fn()`` (which must return with no pass in flight) under the
    profiler."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    kernel_s: Dict[str, float] = {}
    for e in dev:
        kernel_s[e.name] = (kernel_s.get(e.name, 0.0)
                            + e.time_range.elapsed_us() * 1e-6)
    busy_us, merged = _union((e.time_range.start, e.time_range.end)
                             for e in dev)
    span = next((e for e in cpu if e.name == STRETCH), None)
    gaps = []
    if span is not None and merged:
        edges = ([span.time_range.start] + [x for iv in merged for x in iv]
                 + [span.time_range.end])
        gaps = sorted(((b - a, a) for a, b in zip(edges[::2], edges[1::2])
                       if b > a), reverse=True)[:TOP]
    return Trace(kernel_s=kernel_s, busy_s=busy_us * 1e-6, window_s=window,
                 gaps=[(_label(a + g / 2, cpu), g * 1e-6) for g, a in gaps],
                 events=len(dev),
                 read_s=time.perf_counter() - t0 - window)
