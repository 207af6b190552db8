"""The deployed graph, made from its configuration.

A frozen copy of the power-law endpoint sampler of
``repro_torch.core.graph.random_graph`` (Zipf-like endpoint draws,
truncated to |V|), drawn in rounds of |E| pairs until |E| distinct
(src, dst) pairs with src != dst are in hand: the first |E| distinct
pairs in the order they were drawn.  So the graph has the dataset's
count of distinct edges, no multi-edges and no drawn self loops (the
loops are added apart, one a vertex).  The frozen copy keeps the graph a
cell serves from changing when the program's generator does.  The graph
seed is part of the configuration: a deployed graph is part of the
deployment.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _draw(rng: np.random.Generator, spec: dict, n: int, e: int
          ) -> Tuple[np.ndarray, np.ndarray]:
    """One round of ``e`` (src, dst) endpoint draws, as the port draws
    them (dst first)."""
    if spec["degree"] == "powerlaw":
        p = np.arange(1, n + 1, dtype=np.float64) ** -float(spec["alpha"])
        p /= p.sum()
        dst = rng.choice(n, size=e, p=p).astype(np.int32)
        src = rng.choice(n, size=e, p=p).astype(np.int32)
    elif spec["degree"] == "uniform":
        src = rng.integers(0, n, e, dtype=np.int32)
        dst = rng.integers(0, n, e, dtype=np.int32)
    else:
        raise ValueError(f"unknown degree profile {spec['degree']!r}")
    return src, dst


def edges(spec: dict) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays of ``spec`` (a configuration's ``graph``
    entry): ``n_edges`` distinct pairs, no self loops."""
    n, e = int(spec["n_vertices"]), int(spec["n_edges"])
    if e > n * (n - 1):
        raise ValueError(f"{e} distinct edges do not fit {n} vertices")
    rng = np.random.default_rng(int(spec["seed"]))
    keys = np.empty(0, np.int64)
    while keys.shape[0] < e:
        src, dst = _draw(rng, spec, n, e)
        k = src.astype(np.int64) * n + dst
        keys = np.concatenate([keys, k[src != dst]])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:e]
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def with_self_loops(src: np.ndarray, dst: np.ndarray, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The edge arrays with one loop i -> i for every vertex appended."""
    v = np.arange(n, dtype=np.int32)
    return np.concatenate([src, v]), np.concatenate([dst, v])


def distinct_pairs(src: np.ndarray, dst: np.ndarray, n: int) -> int:
    """Number of distinct (src, dst) pairs: the non-zeros of the adjacency
    matrix, which is what an aggregation needs to read."""
    return int(np.unique(src.astype(np.int64) * n + dst).shape[0])
