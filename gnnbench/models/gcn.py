"""GCN (Kipf and Welling, ICLR 2017) as GraphAGILE's b1 / b2 build it.

Layer i: H' = act(A_hat H W_i + b_i), A_hat the GCN-normalised adjacency
with self loops, act ReLU on every layer but the last.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

F32 = 4


def linear_shapes(cfg: dict) -> List[Tuple[int, int]]:
    """(f_in, f_out) of each LINEAR layer, in the order the model runs
    them."""
    g = cfg["graph"]
    widths = ([g["feat_dim"]] + [cfg["hidden"]] * (cfg["n_layers"] - 1)
              + [g["n_classes"]])
    return list(zip(widths[:-1], widths[1:]))


def raw_graph(G, src: np.ndarray, dst: np.ndarray, cfg: dict):
    """The raw edges as the port's ``Graph``, unit weights, no loops."""
    g = cfg["graph"]
    return G.Graph(n_vertices=g["n_vertices"], src=src, dst=dst,
                   weight=np.ones(src.shape[0], np.float32),
                   feat_dim=g["feat_dim"], n_classes=g["n_classes"],
                   name=g["name"])


def program_graph(G, src: np.ndarray, dst: np.ndarray, cfg: dict):
    """The deployed graph as the port takes it: raw edges, self loops and
    GCN edge weights added by the port's own ``Graph.gcn_normalized``."""
    return raw_graph(G, src, dst, cfg).gcn_normalized()


def program_model(B, graph, cfg: dict):
    """The model through the port's ``gnn_builders.build_gcn`` (weights
    replaced by the benchmark's afterwards)."""
    return B.build_gcn(graph, cfg["hidden"], cfg["n_layers"])


def work(cfg: dict, n_vertices: int, nnz: int, lanes: int
         ) -> Dict[str, Tuple[float, float]]:
    """Operations and bytes one pass of ``lanes`` requests needs, by the
    kernel that does the work: ``{"gemm": (flops, bytes), "spdmm": ...}``.

    A LINEAR layer is 2 V f_in f_out operations; it reads each lane's
    input and the weights once and writes each lane's output once.  An
    aggregation is 2 nnz f operations over the nnz distinct non-zeros of
    A_hat; it reads each lane's input once, the adjacency (a column index
    and a value a non-zero, a row offset a vertex) once for all lanes, and
    writes each lane's output once.  A SUM aggregation commutes with the
    layer's weights, A_hat (H W) + b = (A_hat H) W + b (the bias added
    after the aggregation), so it needs only the narrower of the layer's
    two widths.  The bias adds (V f_out a lane) are not counted."""
    v, n = n_vertices, lanes
    out = {"gemm": [0.0, 0.0], "spdmm": [0.0, 0.0]}
    for fi, fo in linear_shapes(cfg):
        out["gemm"][0] += n * 2.0 * v * fi * fo
        out["gemm"][1] += F32 * (n * v * fi + fi * fo + fo + n * v * fo)
        f = min(fi, fo)
        out["spdmm"][0] += n * 2.0 * nnz * f
        out["spdmm"][1] += F32 * (2 * n * v * f + 2 * nnz + v + 1)
    return {k: (a, b) for k, (a, b) in out.items()}
