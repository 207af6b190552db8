"""Driving the port's runtime: the overlays, the warm passes, and a closed
loop of clients over ``ServeLoop.submit``.

Each client sends its next request as soon as its previous one is
answered.  One sending thread plays every client (``ServeLoop`` is driven
from one thread); the runtime's worker threads hand each response back
through the loop's ``Metrics``, which the benchmark extends only to be
told of it.  A request's latency runs from the sending thread's ``submit`` to
the moment its response is recorded, after the engine has synchronised
the pass that computed it.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, List, Optional

from repro_torch.engine import InferenceRequest
from repro_torch.runtime import Metrics, OverlayPool, ServeLoop
from torch.profiler import record_function

# How long the sending thread waits, once the window has closed, for the
# answers still owed; a request not answered by then is a failure.
DRAIN_S = 60.0
# A pass shape is captured by its second or third pass (the first on a
# new staging uploads its tiles, the next runs eagerly and is memoised,
# the one after captures); a fourth that still does not replay is a
# fault of the run.
WARM_MAX_PASSES = 4


class TracedPool(OverlayPool):
    """The runtime's pool with one host span around each batch's pass, so
    that a trace can say what the host was doing in a device gap."""

    def execute_on(self, idx, batch):
        with record_function("engine.submit_batch"):
            return super().execute_on(idx, batch)


@dataclasses.dataclass
class Done:
    """One answered request."""
    sent: float             # perf_counter at submit
    done: float             # perf_counter when its response was recorded
    t_loh: float            # the engine's T_LoH of its pass
    queue_wait: float       # the runtime's queue wait


class _Recorder(Metrics):
    """The loop's Metrics, telling the clients of every response and
    keeping the size of every batch dispatched."""

    def __init__(self, tell: Callable) -> None:
        super().__init__()
        self._tell = tell
        self.batch_sizes: List[int] = []

    def record_batch(self, key: str, size: int) -> None:
        super().record_batch(key, size)
        self.batch_sizes.append(size)

    def record_response(self, resp, latency_s, queue_wait_s=None,
                        execute_s=None, compile_s=None) -> None:
        super().record_response(resp, latency_s, queue_wait_s, execute_s,
                                compile_s)
        self._tell(resp, queue_wait_s)


class Clients:
    """A closed loop of ``traffic["clients"]`` clients over one ServeLoop:
    each client sends its next request as soon as its own answer is
    recorded.

    The sending thread sleeps on a condition until an answer arrives or
    the oldest queued batch reaches the batcher's deadline, when it calls
    ``ServeLoop.poll`` (the loop flushes only from its caller's thread).

    ``keep`` outputs of answered requests are held for the check, a
    reservoir sample drawn from the seed; every other output is dropped
    as soon as it is recorded (the loop keeps only the response's
    husk)."""

    def __init__(self, pool: OverlayPool, traffic: dict, make: Callable,
                 inputs, seed: int, keep: int) -> None:
        self.traffic = traffic
        self.make = make                # (idx, item) -> InferenceRequest
        self.inputs = inputs
        self.metrics = _Recorder(self._told)
        self.loop = ServeLoop(pool, max_batch=traffic["max_batch"],
                              max_wait_us=traffic["max_wait_us"],
                              clock=time.perf_counter, metrics=self.metrics)
        self._cond = threading.Condition()
        self._new: List[tuple] = []
        self._sent = {}                 # idx -> (item, perf_counter)
        self.done: List[Done] = []
        self.kept = []                  # [(idx, item, output)]
        self._rng = random.Random(seed)
        self._keep = keep
        self._seen = 0
        self._next = 0

    # -- worker threads ----------------------------------------------- #
    def _told(self, resp, queue_wait) -> None:
        t = time.perf_counter()
        out, resp.output = resp.output, None
        with self._cond:
            self._new.append((int(resp.request_id), t, resp.t_loh,
                              queue_wait or 0.0, out))
            self._cond.notify()

    # -- the sending thread ------------------------------------------- #
    def _send(self) -> None:
        """Send one client's next request.  Nothing here calls into
        torch: a torch call releases the interpreter lock, and the worker
        thread that takes it may hold it past the batcher's deadline, so
        that the sending thread's own overhead would split batches."""
        idx = self._next
        self._next += 1
        item = int(self.inputs.order.integers(0, self.traffic["pool"]))
        req = self.make(idx, item)
        self._sent[idx] = (item, time.perf_counter())
        self.loop.submit(req)

    def _deadline(self) -> Optional[float]:
        """When the oldest queued batch is due (perf_counter), or None."""
        groups = self.loop.batcher._groups.values()
        if not groups:
            return None
        return (min(b.created_at for b in groups)
                + self.traffic["max_wait_us"] * 1e-6)

    def _take(self, wait_s: float) -> list:
        with self._cond:
            if not self._new and wait_s > 0:
                self._cond.wait(timeout=wait_s)
            new, self._new = self._new, []
        return new

    def _record(self, idx, t, t_loh, qw, out) -> None:
        item, sent = self._sent.pop(idx)
        self.done.append(Done(sent, t, t_loh, qw))
        # Reservoir sample of the answered requests, drawn from the seed.
        self._seen += 1
        if len(self.kept) < self._keep:
            self.kept.append((idx, item, out))
        else:
            j = self._rng.randrange(self._seen)
            if j < self._keep:
                self.kept[j] = (idx, item, out)

    def run(self, seconds: float) -> tuple:
        """Serve for ``seconds``, then wait for every request sent to be
        answered (at most ``DRAIN_S``).  Returns (start, close) on the
        perf_counter clock; requests never answered stay in
        ``unanswered``."""
        start = time.perf_counter()
        close = start + seconds
        for _ in range(self.traffic["clients"]):
            self._send()
        give_up = close + DRAIN_S
        while self._sent:
            now = time.perf_counter()
            if now >= give_up:
                break
            until = close if now < close else give_up
            due = self._deadline()
            if due is not None:
                until = min(until, due)
            for rec in self._take(until - now):
                self._record(*rec)
                if time.perf_counter() < close:
                    self._send()
            self.loop.poll()
        return start, close

    @property
    def unanswered(self) -> int:
        return len(self._sent)

    def shutdown(self) -> None:
        self.loop.shutdown()


def warm(pool: OverlayPool, traffic: dict, make: Callable, replays: bool,
         log: Callable[[str], None]) -> float:
    """Serve every batch bucket the traffic can meet (the powers of two up
    to ``max_batch``; the engine pads a batch to the next one) on the
    serving overlay, largest first, until its pass replays a capture
    (``replays``: on a card; elsewhere one pass a bucket), so that tiles
    are staged and every pass shape captured before the window.  Returns
    the compile time of the cell's program (its ``t_loc``, paid by the
    first batch)."""
    from repro_torch.kernels import ops
    loop = ServeLoop(pool, max_batch=traffic["max_batch"],
                     max_wait_us=1e9, metrics=Metrics())
    t_loc = 0.0
    size = 1 << (traffic["max_batch"] - 1).bit_length()
    try:
        while size >= 1:
            for n in range(1, WARM_MAX_PASSES + 1):
                t0 = time.perf_counter()
                before = sum(ops.REPLAYED.values())
                for i in range(min(size, traffic["max_batch"])):
                    loop.submit(make(-1, i % traffic["pool"]))
                for r in loop.drain():
                    t_loc = max(t_loc, r.t_loc)
                replayed = sum(ops.REPLAYED.values()) > before
                log(f"warm pass {n} of {size}: "
                    f"{time.perf_counter() - t0:.3f} s"
                    f"{' (replayed)' if replayed else ''}")
                if replayed or not replays:
                    break
            else:
                raise RuntimeError(f"no replay of the {size}-lane pass "
                                   f"after {WARM_MAX_PASSES} warm passes")
            size //= 2
    finally:
        loop.shutdown()
    return t_loc


def request_maker(model, graph, inputs) -> Callable:
    def make(idx: int, item: int) -> InferenceRequest:
        return InferenceRequest(model=model, graph=graph,
                                features=inputs.items[item],
                                request_id=str(idx))
    return make
