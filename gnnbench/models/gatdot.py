"""gat-dot: a single-head GAT whose scores are dot products, the DP
attention of SuperGAT (Kim and Oh, ICLR 2021; PyG
``SuperGATConv(attention_type="DP")``, LeakyReLU slope 0.2).

Layer i: H = X W_i + b_i; e_uv = LReLU(<H_u, H_v>) on every edge u -> v
(self loops included); alpha = softmax of e over the edges into v;
X'_v = act(sum_u alpha_uv H_u), act ReLU on every layer but the last.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .gcn import F32, linear_shapes, raw_graph


def program_graph(G, src: np.ndarray, dst: np.ndarray, cfg: dict):
    """Raw edges with the port's ``Graph.with_self_loops`` (unit edge
    weights: the attention alone weighs the aggregation)."""
    return raw_graph(G, src, dst, cfg).with_self_loops()


def program_model(B, graph, cfg: dict):
    """The model from the port's ``gnn_builders`` primitives (as the repo's
    ``chip_smoke.build_gat_dot``); weights replaced by the benchmark's."""
    b = B._B(graph, f"gatdot{cfg['n_layers']}x{cfg['hidden']}")
    prev = None
    shapes = linear_shapes(cfg)
    for i, (fi, fo) in enumerate(shapes):
        h = b.linear(prev, fi, fo)
        e = b.vector_inner(h, fo, mode="dot")
        e = b.activation(e, 1, B.Activation.LRELU, on_edges=True)
        e = b.activation(e, 1, B.Activation.EDGE_SOFTMAX, on_edges=True)
        prev = b.aggregate(h, fo, B.AggOp.SUM, edge_weight_layer=e)
        if i < len(shapes) - 1:
            prev = b.activation(prev, fo, B.Activation.RELU)
    return b.m


def work(cfg: dict, n_vertices: int, nnz: int, lanes: int
         ) -> Dict[str, Tuple[float, float]]:
    """Operations and bytes one pass of ``lanes`` requests needs, by the
    kernel that does the work (see ``models/gcn.py`` for the rules).
    The dot scores (SDDMM) are 2 nnz f operations; they read each lane's
    H once (both ends of an edge read the same matrix), the adjacency's
    structure once, and write one score a non-zero a lane.  The weighted
    aggregation (SpDMM) reads each lane's H and its nnz weights, the
    structure once, and writes each lane's output.  LReLU and the edge
    softmax run on no hand kernel and are not counted here."""
    v, n = n_vertices, lanes
    struct = nnz + v + 1
    out = {"gemm": [0.0, 0.0], "sddmm": [0.0, 0.0], "spdmm": [0.0, 0.0]}
    for fi, fo in linear_shapes(cfg):
        out["gemm"][0] += n * 2.0 * v * fi * fo
        out["gemm"][1] += F32 * (n * v * fi + fi * fo + fo + n * v * fo)
        out["sddmm"][0] += n * 2.0 * nnz * fo
        out["sddmm"][1] += F32 * (n * v * fo + struct + n * nnz)
        out["spdmm"][0] += n * 2.0 * nnz * fo
        out["spdmm"][1] += F32 * (2 * n * v * fo + n * nnz + struct)
    return {k: (a, b) for k, (a, b) in out.items()}
