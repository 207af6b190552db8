"""Graph containers and synthetic generators.

The container is offline, so the seven evaluation graphs of the paper
(Table 4) are synthesized to matching statistics: |V|, |E|, feature width,
number of classes, and a degree profile (power-law for the social/commerce
graphs, near-uniform for the citation graphs).  Latency and complexity
results of the compiler depend only on (|V|, |E|, degree structure, f), all
of which are matched; feature *values* are random.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# name: (|V|, |E|, features, classes, degree profile)
PAPER_DATASETS: Dict[str, Tuple[int, int, int, int, str]] = {
    "CI": (3327, 4732, 3703, 6, "uniform"),       # Citeseer
    "CO": (2708, 5429, 1433, 7, "uniform"),       # Cora
    "PU": (19717, 44338, 500, 3, "uniform"),      # Pubmed
    "FL": (89250, 899756, 500, 7, "powerlaw"),    # Flickr
    "RE": (232965, 116069919, 602, 41, "powerlaw"),   # Reddit
    "YE": (716847, 6977410, 300, 100, "powerlaw"),    # Yelp
    "AP": (1569960, 264339468, 200, 107, "powerlaw"),  # Amazon-Products
}


@dataclasses.dataclass
class Graph:
    """COO graph (paper §5.1): edge e = (src, dst, weight)."""

    n_vertices: int
    src: np.ndarray        # int32 [E]
    dst: np.ndarray        # int32 [E]
    weight: np.ndarray     # float32 [E]
    feat_dim: int = 0
    n_classes: int = 0
    name: str = "graph"

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_vertices)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_vertices)

    def with_self_loops(self) -> "Graph":
        """Add self loops (GCN uses N(i) ∪ {i})."""
        v = np.arange(self.n_vertices, dtype=np.int32)
        return dataclasses.replace(
            self,
            src=np.concatenate([self.src, v]),
            dst=np.concatenate([self.dst, v]),
            weight=np.concatenate(
                [self.weight, np.ones(self.n_vertices, np.float32)]
            ),
        )

    def gcn_normalized(self) -> "Graph":
        """Edge weights alpha_ji = 1/sqrt(D(j)D(i)) over the self-loop graph."""
        g = self.with_self_loops()
        deg = np.bincount(g.dst, minlength=g.n_vertices).astype(np.float32)
        deg = np.maximum(deg, 1.0)
        inv = 1.0 / np.sqrt(deg)
        w = inv[g.src] * inv[g.dst]
        return dataclasses.replace(g, weight=w.astype(np.float32))

    def mean_normalized(self) -> "Graph":
        """Edge weights 1/indeg(dst) — turns SUM aggregation into MEAN."""
        deg = np.maximum(self.in_degree().astype(np.float32), 1.0)
        w = self.weight / deg[self.dst]
        return dataclasses.replace(self, weight=w.astype(np.float32))

    def sorted_by_dst(self) -> "Graph":
        """Sort edges by (dst, src).

        On the FPGA, a RAW-hazard unit reorders conflicting destination
        updates at runtime; on TPU we sort at compile time so each
        destination row's edges are contiguous (see DESIGN.md §2).
        """
        order = np.lexsort((self.src, self.dst))
        return dataclasses.replace(
            self, src=self.src[order], dst=self.dst[order],
            weight=self.weight[order],
        )

    @property
    def mutation_token(self) -> int:
        """Monotone dirty counter for cached views (CSR, signatures).

        The memoized views on this object are keyed by array *identity*,
        which cannot see in-place content mutation.  Anything that
        mutates a deployed graph — a live-graph delta,
        or a caller writing into the arrays directly — must call
        :meth:`invalidate_views`; cached views compare this token on
        access and rebuild when it moved.
        """
        return self.__dict__.get("_mutation_token", 0)

    def invalidate_views(self) -> int:
        """Bump :attr:`mutation_token` and drop every memoized view
        (in-CSR adjacency, edge digest).  Returns the new token."""
        token = self.mutation_token + 1
        self.__dict__["_mutation_token"] = token
        self.__dict__.pop("_in_csr", None)
        self.__dict__.pop("_edge_digest", None)
        return token

    def in_csr(self):
        """Cached in-adjacency CSR view (``repro_torch.sampling.csr.CSR``).

        The per-user sampling layer needs O(degree) "who sends messages
        to vertex v" lookups on the host; this hook memoizes the one-time
        O(|V| + |E|) CSR build on the graph object (same identity-keyed
        invalidation rule as the engine's signature memo: rebinding the
        edge arrays invalidates).  In-place *content* mutation is
        invisible to identity checks — mutators must call
        :meth:`invalidate_views`, and the memo also re-checks
        :attr:`mutation_token` on access.
        """
        from repro_torch.sampling.csr import in_csr  # lazy: core has no
        return in_csr(self)             # other dependency on sampling


# --------------------------------------------------------------------------- #
def synthesize(
    name: str,
    scale: float = 1.0,
    seed: int = 0,
    degree: Optional[str] = None,
) -> Graph:
    """Synthesize a graph matching a paper dataset's statistics.

    ``scale`` < 1 shrinks |V| and |E| proportionally (used for the big
    graphs RE/YE/AP so CPU benchmark wall-times stay sane; always labeled).
    """
    nv, ne, f, c, prof = PAPER_DATASETS[name]
    nv = max(int(nv * scale), 16)
    ne = max(int(ne * scale), 32)
    g = random_graph(nv, ne, seed=seed, degree=degree or prof)
    g.feat_dim, g.n_classes = f, c
    g.name = name if scale == 1.0 else f"{name}@{scale:g}"
    return g


def random_graph(
    n_vertices: int, n_edges: int, seed: int = 0, degree: str = "uniform",
    alpha: float = 1.1, dedupe: bool = False,
) -> Graph:
    """Random COO graph.

    ``alpha`` is the power-law exponent of the Zipf-ish endpoint sampling
    (``degree="powerlaw"``; higher = heavier hubs).  With ``dedupe=True``
    duplicate (src, dst) draws are folded into a single edge whose weight
    counts the multiplicity — the realistic shape for sampled/benchmark
    traffic, where multi-edges are measurement artifacts.
    """
    rng = np.random.default_rng(seed)
    if degree == "powerlaw":
        # Zipf-ish endpoint sampling, truncated to |V|.
        ranks = np.arange(1, n_vertices + 1, dtype=np.float64)
        p = ranks ** -alpha
        p /= p.sum()
        dst = rng.choice(n_vertices, size=n_edges, p=p).astype(np.int32)
        src = rng.choice(n_vertices, size=n_edges, p=p).astype(np.int32)
    else:
        src = rng.integers(0, n_vertices, n_edges, dtype=np.int32)
        dst = rng.integers(0, n_vertices, n_edges, dtype=np.int32)
    w = np.ones(n_edges, np.float32)
    if dedupe:
        key = src.astype(np.int64) * n_vertices + dst
        uniq, inv = np.unique(key, return_inverse=True)
        mult = np.bincount(inv, minlength=uniq.shape[0])
        src = (uniq // n_vertices).astype(np.int32)
        dst = (uniq % n_vertices).astype(np.int32)
        w = mult.astype(np.float32)
    return Graph(n_vertices=n_vertices, src=src, dst=dst, weight=w)


def random_features(
    g: Graph, f: Optional[int] = None, seed: int = 1, dtype=np.float32
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = f or g.feat_dim
    return rng.normal(0, 1, (g.n_vertices, f)).astype(dtype) * 0.1
