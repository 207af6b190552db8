"""Cached CSR in-adjacency view on :class:`repro_torch.core.graph.Graph`
(a copy of ``repro/sampling/csr.py``, numpy only; a test holds the two
equal).

The serving graph lives in COO (the compiler's input format); per-user
sampling instead needs "who sends messages to vertex v" in O(degree).
Message passing flows src -> dst, so the view is indexed by destination:
``in_neighbors(v)`` returns the sources (and weights / original edge
ids) of every edge targeting ``v``.

The O(|V| + |E|) build is memoized on the graph object via
``Graph.in_csr()`` (the hook in ``core/graph.py``), with the same
identity-keyed invalidation rule as the engine's signature memo:
rebinding the edge arrays (what every ``Graph`` method does) invalidates
the cache.  In-place content mutation is invisible to identity checks,
so the memo additionally records ``Graph.mutation_token`` — a dirty
counter bumped by ``Graph.invalidate_views()`` (which a live-graph delta
calls) — and rebuilds when the token moved.  A mutated
graph can therefore never silently serve stale adjacency, provided the
mutator invalidates.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class CSR:
    """In-adjacency CSR: edges grouped by destination, src-sorted."""

    n_vertices: int
    indptr: np.ndarray    # int64 [V+1]: dst v's edges at indptr[v]:indptr[v+1]
    src: np.ndarray       # int32 [E]  source endpoint per slot
    weight: np.ndarray    # float32 [E]
    edge_id: np.ndarray   # int32 [E]  index into the original COO arrays

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def in_degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    def in_neighbors(self, v: int) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
        """(sources, weights, original edge ids) of edges into ``v``."""
        lo, hi = int(self.indptr[v]), int(self.indptr[v + 1])
        return self.src[lo:hi], self.weight[lo:hi], self.edge_id[lo:hi]

    def max_in_degree(self) -> int:
        return int(np.max(np.diff(self.indptr))) if self.n_vertices else 0


def build_csr(g: Graph) -> CSR:
    """COO -> in-adjacency CSR, dst-grouped with src-sorted runs (the
    same (dst, src) order the partitioner uses)."""
    order = np.lexsort((g.src, g.dst)).astype(np.int64)
    dst = g.dst[order]
    counts = np.bincount(dst, minlength=g.n_vertices)
    indptr = np.zeros(g.n_vertices + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(
        n_vertices=g.n_vertices,
        indptr=indptr,
        src=g.src[order].astype(np.int32),
        weight=g.weight[order].astype(np.float32),
        edge_id=order.astype(np.int32),
    )


def in_csr(g: Graph) -> CSR:
    """Memoized :func:`build_csr`; backs ``Graph.in_csr()``.

    Invalidation is two-tier: array identity (rebinding arrays, what
    every ``Graph`` method does) AND the graph's ``mutation_token``
    dirty counter (bumped by ``Graph.invalidate_views()`` whenever
    contents are mutated in place — e.g. per applied ``livegraph``
    delta)."""
    token = g.mutation_token
    cached = g.__dict__.get("_in_csr")
    if (cached is None or cached[0] is not g.src or cached[1] is not g.dst
            or cached[2] is not g.weight or cached[3] != token):
        cached = (g.src, g.dst, g.weight, token, build_csr(g))
        g.__dict__["_in_csr"] = cached
    return cached[4]
