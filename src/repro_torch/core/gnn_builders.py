"""Builders: GNN model specs -> ModelIR (+ random weights).

Covers the paper's evaluated models (Table 5): GCN (b1/b2), GraphSAGE
(b3/b4), GIN (b5), GAT (b6), SGC (b7), and a GraphGym-style stack (b8).
Each builder mirrors how PyG would decompose the model into the six
computation-layer types of the IR (paper Fig. 10).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .graph import Graph
from .ir import Activation, AggOp, LayerIR, LayerType, ModelIR


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


class _B:
    """Small helper to build linear chains/branches of LayerIRs."""

    def __init__(self, g: Graph, name: str, seed: int = 0) -> None:
        self.m = ModelIR()
        self.m.name = name
        self.m.graph_meta = {
            "n_vertices": g.n_vertices,
            "n_edges": g.n_edges,
            "feat_dim": g.feat_dim,
        }
        self.g = g
        self.rng = _rng(seed)

    def add(self, layer: LayerIR, parents: List[int]) -> int:
        layer.layer_id = self.m.next_id()
        layer.parent_ids = list(parents)
        layer.n_vertices = self.g.n_vertices
        layer.n_edges = self.g.n_edges
        self.m.add_layer(layer)
        for p in parents:
            self.m.layers[p].child_ids.append(layer.layer_id)
        return layer.layer_id

    # ------------------------------------------------------------------ #
    def linear(self, parent: Optional[int], f_in: int, f_out: int,
               bias: bool = True, tag: str = "") -> int:
        lid = self.m.next_id()
        wkey, bkey = f"L{lid}.W", f"L{lid}.b"
        self.m.weights[wkey] = (
            self.rng.normal(0, 1, (f_in, f_out)).astype(np.float32)
            / np.sqrt(f_in)
        )
        attrs = {"W": wkey}
        if bias:
            self.m.weights[bkey] = np.zeros((f_out,), np.float32)
            attrs["b"] = bkey
        if tag:
            attrs["tag"] = tag
        l = LayerIR(LayerType.LINEAR, 0, f_in=f_in, f_out=f_out, attrs=attrs)
        return self.add(l, [] if parent is None else [parent])

    def aggregate(self, parent: Optional[int], f: int, op: AggOp = AggOp.SUM,
                  edge_weight_layer: Optional[int] = None) -> int:
        attrs = {}
        if edge_weight_layer is not None:
            attrs["edge_weight_layer"] = edge_weight_layer
        l = LayerIR(LayerType.AGGREGATE, 0, f_in=f, f_out=f, agg_op=op,
                    attrs=attrs)
        parents = [] if parent is None else [parent]
        if edge_weight_layer is not None:
            parents = parents + [edge_weight_layer]
        return self.add(l, parents)

    def activation(self, parent: int, f: int, act: Activation,
                   on_edges: bool = False) -> int:
        l = LayerIR(LayerType.ACTIVATION, 0, f_in=f, f_out=f, act=act,
                    act_enabled=True, attrs={"on_edges": on_edges})
        return self.add(l, [parent])

    def batchnorm(self, parent: int, f: int) -> int:
        lid = self.m.next_id()
        for k, v in [("mu", self.rng.normal(0, 0.5, f)),
                     ("sigma", np.abs(self.rng.normal(1, 0.2, f)) + 0.5),
                     ("gamma", self.rng.normal(1, 0.2, f)),
                     ("beta", self.rng.normal(0, 0.2, f))]:
            self.m.weights[f"L{lid}.{k}"] = v.astype(np.float32)
        l = LayerIR(LayerType.BATCHNORM, 0, f_in=f, f_out=f,
                    batch_enabled=True,
                    attrs={"eps": 1e-5, **{k: f"L{lid}.{k}" for k in
                                           ("mu", "sigma", "gamma", "beta")}})
        return self.add(l, [parent])

    def vadd(self, pa: Optional[int], pb: Optional[int], f: int,
             alpha: float = 1.0, beta: float = 1.0) -> int:
        """out = alpha*X_a + beta*X_b.  A ``None`` operand reads the model
        input features; attrs['operands'] keeps the positional mapping
        (-1 == model input)."""
        l = LayerIR(LayerType.VECTOR_ADD, 0, f_in=f, f_out=f,
                    attrs={"alpha": alpha, "beta": beta,
                           "operands": [pa if pa is not None else -1,
                                        pb if pb is not None else -1]})
        parents = [p for p in (pa, pb) if p is not None]
        return self.add(l, parents)

    def vector_inner(self, parent: int, f: int, mode: str = "dot") -> int:
        """Edge scores.  mode='dot': <h_src, h_dst>; mode='pair_sum':
        s_l[src] + s_r[dst] with f==2 (GAT, expressed as SDDMM of
        [s_l, 1] and [1, s_r] — see DESIGN.md)."""
        l = LayerIR(LayerType.VECTOR_INNER, 0, f_in=f, f_out=1,
                    attrs={"mode": mode})
        return self.add(l, [parent])


# --------------------------------------------------------------------------- #
# Model builders.  `hidden` etc. follow paper Table 5.
# --------------------------------------------------------------------------- #
def build_gcn(g: Graph, hidden: int, n_layers: int = 2, seed: int = 0,
              f_in: Optional[int] = None, n_classes: Optional[int] = None,
              ) -> ModelIR:
    b = _B(g, f"gcn{n_layers}x{hidden}", seed)
    f = f_in or g.feat_dim
    out = n_classes or g.n_classes
    prev = None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else out
        prev = b.aggregate(prev, f, AggOp.SUM)
        prev = b.linear(prev, f, fo)
        if i < n_layers - 1:
            prev = b.activation(prev, fo, Activation.RELU)
        f = fo
    return b.m


def build_sage(g: Graph, hidden: int, n_layers: int = 2, seed: int = 0,
               f_in: Optional[int] = None, n_classes: Optional[int] = None,
               ) -> ModelIR:
    """GraphSAGE-mean: h_i' = ReLU(W_s h_i + W_n mean_j h_j)."""
    b = _B(g, f"sage{n_layers}x{hidden}", seed)
    f = f_in or g.feat_dim
    out = n_classes or g.n_classes
    prev = None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else out
        self_lin = b.linear(prev, f, fo, tag="self")
        agg = b.aggregate(prev, f, AggOp.MEAN)
        neigh_lin = b.linear(agg, f, fo, tag="neigh")
        prev = b.vadd(self_lin, neigh_lin, fo)
        if i < n_layers - 1:
            prev = b.activation(prev, fo, Activation.RELU)
        f = fo
    return b.m


def build_gin(g: Graph, hidden: int, n_layers: int = 5, eps: float = 0.1,
              seed: int = 0, f_in: Optional[int] = None,
              n_classes: Optional[int] = None, batchnorm: bool = True,
              ) -> ModelIR:
    """GIN: h_i' = MLP((1+eps) h_i + sum_j h_j); 2-layer MLP with BN."""
    b = _B(g, f"gin{n_layers}x{hidden}", seed)
    f = f_in or g.feat_dim
    out = n_classes or g.n_classes
    prev = None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else out
        agg = b.aggregate(prev, f, AggOp.SUM)
        # (1+eps)*h_self + sum_neighbors; `prev=None` reads model input.
        mix = b.vadd(agg, prev, f, alpha=1.0, beta=1.0 + eps)
        h = b.linear(mix, f, hidden)
        if batchnorm:
            h = b.batchnorm(h, hidden)
        h = b.activation(h, hidden, Activation.RELU)
        h = b.linear(h, hidden, fo)
        if i < n_layers - 1:
            if batchnorm:
                h = b.batchnorm(h, fo)
            h = b.activation(h, fo, Activation.RELU)
        prev = h
        f = fo
    return b.m


def build_gat(g: Graph, hidden: int, n_layers: int = 2, seed: int = 0,
              f_in: Optional[int] = None, n_classes: Optional[int] = None,
              ) -> ModelIR:
    """Single-head GAT (paper Eq. 4), decomposed per DESIGN.md:
    Linear(W) -> scores Linear(f->2) -> Vector-Inner(pair_sum) ->
    LReLU -> edge softmax -> weighted Aggregate."""
    b = _B(g, f"gat{n_layers}x{hidden}", seed)
    f = f_in or g.feat_dim
    out = n_classes or g.n_classes
    prev = None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else out
        h = b.linear(prev, f, fo, tag="att_proj")
        s = b.linear(h, fo, 2, bias=False, tag="att_scores")
        e = b.vector_inner(s, 2, mode="pair_sum")
        e = b.activation(e, 1, Activation.LRELU, on_edges=True)
        e = b.activation(e, 1, Activation.EDGE_SOFTMAX, on_edges=True)
        h2 = b.aggregate(h, fo, AggOp.SUM, edge_weight_layer=e)
        if i < n_layers - 1:
            h2 = b.activation(h2, fo, Activation.RELU)
        prev = h2
        f = fo
    return b.m


def build_sgc(g: Graph, k: int = 2, seed: int = 0,
              f_in: Optional[int] = None, n_classes: Optional[int] = None,
              ) -> ModelIR:
    b = _B(g, f"sgc_k{k}", seed)
    f = f_in or g.feat_dim
    out = n_classes or g.n_classes
    prev = None
    for _ in range(k):
        prev = b.aggregate(prev, f, AggOp.SUM)
    b.linear(prev, f, out)
    return b.m


def build_graphgym(g: Graph, hidden: int = 256, n_gnn: int = 3, seed: int = 0,
                   f_in: Optional[int] = None, n_classes: Optional[int] = None,
                   ) -> ModelIR:
    """GraphGym-style: 1 pre-MLP, n GNN layers w/ residual+BN, 1 post-MLP."""
    b = _B(g, f"graphgym{n_gnn}x{hidden}", seed)
    f = f_in or g.feat_dim
    out = n_classes or g.n_classes
    h = b.linear(None, f, hidden, tag="pre_mlp")
    h = b.activation(h, hidden, Activation.RELU)
    for _ in range(n_gnn):
        res = h
        a = b.aggregate(h, hidden, AggOp.SUM)
        a = b.linear(a, hidden, hidden)
        a = b.batchnorm(a, hidden)
        a = b.activation(a, hidden, Activation.RELU)
        h = b.vadd(a, res, hidden)
    b.linear(h, hidden, out, tag="post_mlp")
    return b.m


# --------------------------------------------------------------------------- #
BENCHMARKS = {
    "b1": lambda g, s=0: build_gcn(g, 16, 2, seed=s),
    "b2": lambda g, s=0: build_gcn(g, 128, 2, seed=s),
    "b3": lambda g, s=0: build_sage(g, 128, 2, seed=s),
    "b4": lambda g, s=0: build_sage(g, 256, 2, seed=s),
    "b5": lambda g, s=0: build_gin(g, 128, 5, seed=s),
    "b6": lambda g, s=0: build_gat(g, 64, 2, seed=s),
    "b7": lambda g, s=0: build_sgc(g, 2, seed=s),
    "b8": lambda g, s=0: build_graphgym(g, 256, 3, seed=s),
}


def build(name: str, g: Graph, seed: int = 0) -> ModelIR:
    return BENCHMARKS[name](g, seed)
