"""GraphDelta — a validated, coalescible graph-mutation log.

(The port's copy of ``repro/livegraph/delta.py``.)

A delta is the unit of change for a *deployed* graph: a batch of edge
additions/removals and vertex additions recorded against a known base
vertex count.  It is a write-ahead log, not a graph: ops are kept in
arrival order, and :meth:`coalesce` folds them into the canonical form
the tile patcher consumes —

  * ``removed_pairs``: (src, dst) pairs whose *base* edges die.  A
    removal kills every live (src, dst) edge at its point in the log
    (multi-edges are one logical adjacency, matching the dedupe story
    in :func:`repro.core.graph.random_graph`), so a later add re-creates
    the edge and a remove *after* an add in the same delta cancels it.
  * ``adds``: surviving additions, in arrival order.  Arrival order is
    load-bearing: the versioned tile store appends new edges in this
    order, which is exactly the edge order a cold compile of
    :meth:`apply_to`'s output sees — the root of the bit-identity
    guarantee (see ``livegraph/tiles.py``).

Vertex additions reserve ids ``base_vertices, base_vertices+1, ...`` in
call order; edges in the same delta may reference them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class CoalescedDelta:
    """Net effect of a delta log (see module docstring)."""

    removed_pairs: List[Tuple[int, int]]       # kill base edges
    must_exist: Dict[Tuple[int, int], bool]    # pair -> base edge required
    add_src: np.ndarray                        # int32 [A] arrival order
    add_dst: np.ndarray                        # int32 [A]
    add_weight: np.ndarray                     # float32 [A]
    n_new_vertices: int
    new_features: Optional[np.ndarray]         # [n_new, F] or None

    @property
    def n_adds(self) -> int:
        return int(self.add_src.shape[0])


class GraphDelta:
    """Ordered mutation log against a base graph of ``base_vertices``."""

    def __init__(self, base_vertices: int, feat_dim: int = 0) -> None:
        if base_vertices < 0:
            raise ValueError("base_vertices must be >= 0, "
                             f"got {base_vertices}")
        self.base_vertices = int(base_vertices)
        self.feat_dim = int(feat_dim)
        self._ops: List[tuple] = []          # ("add",u,v,w)|("rm",u,v)
        self._new_features: List[np.ndarray] = []
        self._n_new = 0

    # ------------------------------------------------------------------ #
    @property
    def n_vertices(self) -> int:
        """Vertex count after this delta (base + added)."""
        return self.base_vertices + self._n_new

    @property
    def n_ops(self) -> int:
        return len(self._ops) + self._n_new

    def _check_vertex(self, v: int, role: str) -> int:
        v = int(v)
        if not 0 <= v < self.n_vertices:
            raise IndexError(
                f"{role} vertex {v} out of range [0, {self.n_vertices}) "
                f"(base {self.base_vertices} + {self._n_new} added)")
        return v

    def add_edge(self, src: int, dst: int,
                 weight: float = 1.0) -> "GraphDelta":
        w = float(weight)
        if not np.isfinite(w):
            raise ValueError(f"edge weight must be finite, got {weight!r}")
        self._ops.append(("add", self._check_vertex(src, "src"),
                          self._check_vertex(dst, "dst"), w))
        return self

    def remove_edge(self, src: int, dst: int) -> "GraphDelta":
        self._ops.append(("rm", self._check_vertex(src, "src"),
                          self._check_vertex(dst, "dst")))
        return self

    def add_vertex(self, features=None) -> int:
        """Reserve the next vertex id; returns it.  ``features`` is the
        new vertex's ``[feat_dim]`` row (zeros when omitted)."""
        if features is None:
            row = np.zeros(self.feat_dim, np.float32)
        else:
            row = np.asarray(features, np.float32).reshape(-1)
            if self.feat_dim and row.shape[0] != self.feat_dim:
                raise ValueError(
                    f"vertex features have {row.shape[0]} dims, delta "
                    f"declared feat_dim={self.feat_dim}")
        vid = self.n_vertices
        self._new_features.append(row)
        self._n_new += 1
        return vid

    # ------------------------------------------------------------------ #
    def coalesce(self) -> CoalescedDelta:
        """Fold the log into its net effect (order preserved for adds)."""
        pending: "Dict[Tuple[int, int], List[tuple]]" = {}
        removed: Dict[Tuple[int, int], bool] = {}   # pair -> must_exist
        adds: List[tuple] = []                      # surviving add ops
        for op in self._ops:
            pair = (op[1], op[2])
            if op[0] == "add":
                pending.setdefault(pair, []).append(op)
                adds.append(op)
            else:
                live_adds = pending.pop(pair, [])
                for a in live_adds:
                    adds.remove(a)
                if pair in removed:
                    # Second removal of the same base pair: only legal
                    # if an add in between re-created the edge.
                    if not live_adds:
                        raise KeyError(
                            f"remove_edge({pair[0]}, {pair[1]}): edge "
                            "already removed by this delta")
                else:
                    # must_exist: the removal targeted base edges, not
                    # adds from this very delta.
                    removed[pair] = not live_adds
        a_src = np.array([a[1] for a in adds], np.int32)
        a_dst = np.array([a[2] for a in adds], np.int32)
        a_w = np.array([a[3] for a in adds], np.float32)
        feats = (np.stack(self._new_features).astype(np.float32)
                 if self._new_features else None)
        return CoalescedDelta(
            removed_pairs=sorted(removed), must_exist=removed,
            add_src=a_src, add_dst=a_dst, add_weight=a_w,
            n_new_vertices=self._n_new, new_features=feats)

    # ------------------------------------------------------------------ #
    def apply_to(self, g: Graph) -> Graph:
        """Reference application: base COO -> mutated COO.

        The output edge order is *canonical*: surviving base edges in
        their original positions, then the delta's surviving adds in
        arrival order.  The incremental tile patcher reproduces exactly
        this order (via per-edge birth sequence numbers), which is what
        makes incremental and cold-compiled programs bit-identical.

        The base graph object is not mutated, but its cached views are
        invalidated (:meth:`Graph.invalidate_views`): a holder of ``g``
        that thinks of it as "the live graph" must not keep serving a
        pre-delta adjacency out of the memo.
        """
        if g.n_vertices != self.base_vertices:
            raise ValueError(
                f"delta recorded against {self.base_vertices} vertices, "
                f"graph has {g.n_vertices}")
        cd = self.coalesce()
        keep = np.ones(g.n_edges, bool)
        if cd.removed_pairs:
            key = g.src.astype(np.int64) * self.n_vertices + g.dst
            dead = np.array(
                [u * self.n_vertices + v for u, v in cd.removed_pairs],
                np.int64)
            hit = np.isin(key, dead)
            present = set(np.unique(key[hit]).tolist())
            for u, v in cd.removed_pairs:
                k = u * self.n_vertices + v
                if cd.must_exist[(u, v)] and k not in present:
                    raise KeyError(
                        f"remove_edge({u}, {v}): no such edge in "
                        f"{g.name!r}")
            keep &= ~hit
        out = dataclasses.replace(
            g,
            n_vertices=self.n_vertices,
            src=np.concatenate([g.src[keep], cd.add_src]).astype(np.int32),
            dst=np.concatenate([g.dst[keep], cd.add_dst]).astype(np.int32),
            weight=np.concatenate(
                [g.weight[keep], cd.add_weight]).astype(np.float32),
        )
        g.invalidate_views()
        return out
