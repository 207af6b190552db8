"""Seeded k-hop ego-network sampling (GraphSAGE-style fanout caps).

A copy of ``repro/sampling/sampler.py`` (numpy only; a test holds the two
equal on the same inputs).

The realistic heavy-traffic GNN serving workload is "infer labels for
*these* target vertices" (Zhang et al., arXiv 2206.08536): each request
carries a handful of targets, and the host extracts the k-hop ego
network that a k-layer GNN actually reads — per hop, at most ``fanout``
in-neighbors per frontier vertex (``"full"`` keeps them all).

Determinism contract: given (graph, targets, fanouts, seed) the sampled
ego network is bit-reproducible — vertex order, edge order, everything —
so the bucketing layer downstream produces identical layouts and the
engine's exactness guarantees are testable.

Local vertex ids are assigned in discovery order with the targets first
(locals ``0..T-1``), and the per-hop frontiers are recorded, so the
service can slice exactly the final-hop targets' logit rows out of the
overlay's output.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np

from repro_torch.core.graph import Graph

from .csr import in_csr

Fanout = Union[int, str, None]      # per-hop cap; "full"/None = no cap


@dataclasses.dataclass
class EgoNet:
    """A sampled, relabeled ego network."""

    graph: Graph              # relabeled COO subgraph (weights inherited)
    vertices: np.ndarray      # int32 [V_sub]: local id -> global id
    targets: np.ndarray       # int32 [T]: local ids of the targets (0..T-1)
    hops: List[np.ndarray]    # local-id frontier per hop; hops[0] == targets

    @property
    def n_targets(self) -> int:
        return int(self.targets.shape[0])


def _cap(fanout: Fanout) -> int:
    if fanout is None or fanout == "full":
        return -1
    f = int(fanout)
    if f < 1:
        raise ValueError(f"fanout must be >= 1 or 'full', got {fanout!r}")
    return f


def sample_ego(g: Graph, targets: Sequence[int],
               fanouts: Sequence[Fanout], seed: int = 0) -> EgoNet:
    """Sample the k-hop ego network of ``targets`` (k = len(fanouts)).

    Hop h draws up to ``fanouts[h]`` in-neighbors (message senders)
    without replacement for every vertex of the current frontier; the
    sampled edges — and only those — form the subgraph, so a k-layer
    GNN over it touches exactly the traffic the caps promise.
    """
    tgt = np.asarray(list(targets), np.int64)
    if tgt.ndim != 1 or tgt.shape[0] == 0:
        raise ValueError("targets must be a non-empty 1-D sequence")
    if np.unique(tgt).shape[0] != tgt.shape[0]:
        raise ValueError("targets must be unique")
    if tgt.min() < 0 or tgt.max() >= g.n_vertices:
        raise ValueError(
            f"targets out of range for |V|={g.n_vertices}")

    csr = in_csr(g)
    rng = np.random.default_rng(seed)
    # inverse map global -> local id; -1 = undiscovered (hot path is
    # array-relabeling, no per-edge Python loops)
    inv = np.full(g.n_vertices, -1, np.int64)
    inv[tgt] = np.arange(tgt.shape[0])
    n_local = tgt.shape[0]
    hops: List[np.ndarray] = [np.arange(tgt.shape[0], dtype=np.int32)]
    vert_chunks: List[np.ndarray] = [tgt]
    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    e_w: List[np.ndarray] = []

    frontier = tgt
    for fanout in fanouts:
        cap = _cap(fanout)
        hop_src: List[np.ndarray] = []
        for v in frontier:
            srcs, ws, _ = csr.in_neighbors(int(v))
            deg = srcs.shape[0]
            if deg == 0:
                continue
            if 0 <= cap < deg:
                pick = rng.choice(deg, size=cap, replace=False)
                pick.sort()                   # deterministic edge order
                srcs, ws = srcs[pick], ws[pick]
            hop_src.append(srcs.astype(np.int64))
            e_dst.append(np.full(srcs.shape[0], v, np.int64))
            e_w.append(ws)
        if not hop_src:
            hops.append(np.zeros(0, np.int32))
            break
        hop_all = np.concatenate(hop_src)
        e_src.append(hop_all)
        # discover new vertices in first-occurrence (edge) order
        uniq, first = np.unique(hop_all, return_index=True)
        fresh = uniq[inv[uniq] < 0]
        fresh = fresh[np.argsort(first[inv[uniq] < 0], kind="stable")]
        inv[fresh] = n_local + np.arange(fresh.shape[0])
        n_local += fresh.shape[0]
        vert_chunks.append(fresh)
        hops.append(inv[fresh].astype(np.int32))
        frontier = fresh
        if frontier.shape[0] == 0:
            break

    vertices = np.concatenate(vert_chunks).astype(np.int32)
    if e_src:
        gsrc = np.concatenate(e_src)
        gdst = np.concatenate(e_dst)
        weight = np.concatenate(e_w).astype(np.float32)
    else:
        gsrc = np.zeros(0, np.int64)
        gdst = np.zeros(0, np.int64)
        weight = np.zeros(0, np.float32)
    sub = Graph(
        n_vertices=n_local,
        src=inv[gsrc].astype(np.int32),
        dst=inv[gdst].astype(np.int32),
        weight=weight,
        feat_dim=g.feat_dim,
        n_classes=g.n_classes,
        name=f"{g.name}:ego{tgt.shape[0]}",
    )
    return EgoNet(graph=sub, vertices=vertices, targets=hops[0],
                  hops=hops)
