"""Dynamic request batching — coalesce same-key traffic into one pass.

(The port's copy of ``repro/runtime/batcher.py``, over the port's engine.)

Production GNN traffic is dominated by *repeats*: the same deployed
(model, graph) pair queried with fresh features (Zhang et al.'s
CPU-FPGA mini-batch system, arXiv 2206.08536, batches exactly this way
to keep the accelerator saturated).  The :class:`Batcher` groups
concurrent :class:`~repro_torch.engine.InferenceRequest`s by their program
cache key and flushes a group as ONE batch when either

  * it reaches ``max_batch`` requests (size flush), or
  * its oldest request has waited ``max_wait_us`` (deadline flush),

whichever comes first.  A flushed batch executes a single binary pass
(``Engine.submit_batch``: features padded/stacked to ``[N, V, F]``,
instruction stream traversed once).

The batcher is a passive, clock-injected data structure — callers feed
it requests and poll it for due batches — so tests can drive it with a
fake clock and the serving loop stays deterministic: groups flush in
the order their first request arrived, and requests keep arrival order
within a group.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, List, Optional

from repro_torch.engine import InferenceRequest


@dataclasses.dataclass
class Batch:
    """A flushed group: same cache key, arrival-ordered requests."""

    key: str
    requests: List[InferenceRequest]
    indices: List[int]            # admission sequence numbers
    created_at: float             # clock time of the first request
    cost: float = 0.0             # routing cost estimate (graph work x N)

    def __len__(self) -> int:
        return len(self.requests)


def request_cost(req: InferenceRequest) -> float:
    """Deterministic per-request work estimate for load balancing:
    proportional to the graph traffic a pass touches (edges dominate
    aggregation, vertices dominate the dense layers)."""
    g = req.graph
    return float(g.n_edges + g.n_vertices)


class Batcher:
    """Groups requests by cache key; flush on size or deadline."""

    def __init__(self, max_batch: int = 8, max_wait_us: float = 2000.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_wait_us = max_wait_us
        self.clock = clock
        self._groups: "OrderedDict[str, Batch]" = OrderedDict()

    # ------------------------------------------------------------------ #
    @property
    def depth(self) -> int:
        """Requests currently queued (admitted, not yet flushed)."""
        return sum(len(b) for b in self._groups.values())

    def add(self, key: str, req: InferenceRequest, index: int,
            now: Optional[float] = None) -> Optional[Batch]:
        """Queue one request; returns the batch if this fills a group."""
        now = self.clock() if now is None else now
        group = self._groups.get(key)
        if group is None:
            group = Batch(key=key, requests=[], indices=[], created_at=now)
            self._groups[key] = group
        group.requests.append(req)
        group.indices.append(index)
        group.cost += request_cost(req)
        if len(group) >= self.max_batch:
            return self._groups.pop(key)
        return None

    def due(self, now: Optional[float] = None) -> List[Batch]:
        """Flush every group whose oldest request hit the deadline."""
        now = self.clock() if now is None else now
        deadline_s = self.max_wait_us * 1e-6
        out = []
        for key in [k for k, b in self._groups.items()
                    if now - b.created_at >= deadline_s]:
            out.append(self._groups.pop(key))
        return out

    def flush_all(self) -> List[Batch]:
        """Drain everything, in first-arrival order of each group."""
        out = list(self._groups.values())
        self._groups.clear()
        return out
