"""Intermediate representation of GraphAGILE (paper Table 2, Listing 2).

A GNN model is decomposed into a DAG of *computation layers*, each one of six
types.  The compiler passes (order optimization, fusion, partitioning, kernel
mapping) all operate on this IR.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import OrderedDict
from typing import Any, Dict, List, Optional


class LayerType(enum.IntEnum):
    AGGREGATE = 0
    LINEAR = 1
    VECTOR_INNER = 2
    VECTOR_ADD = 3
    ACTIVATION = 4
    BATCHNORM = 5


class AggOp(enum.IntEnum):
    """Aggregation operators.  SUM and MEAN are linear (Definition 1)."""

    MAX = 0
    SUM = 1
    MIN = 2
    MEAN = 3

    @property
    def is_linear(self) -> bool:
        # Mean is linear w.r.t. features (the 1/deg coefficients are constants
        # of the graph); Max/Min are not.
        return self in (AggOp.SUM, AggOp.MEAN)


class Activation(enum.IntEnum):
    NONE = 0
    RELU = 1
    PRELU = 2
    SWISH = 3
    EXP = 4
    LRELU = 5
    SIGMOID = 6
    EDGE_SOFTMAX = 7  # segment softmax of edge weights over destination
    GELU = 8
    SILU = 9


@dataclasses.dataclass
class LayerIR:
    """IR of one computation layer (paper Table 2)."""

    layer_type: LayerType
    layer_id: int
    parent_ids: List[int] = dataclasses.field(default_factory=list)
    child_ids: List[int] = dataclasses.field(default_factory=list)
    f_in: int = 0
    f_out: int = 0
    n_vertices: int = 0
    n_edges: int = 0
    agg_op: Optional[AggOp] = None
    act: Activation = Activation.NONE
    act_enabled: bool = False
    batch_enabled: bool = False
    # Free-form attributes: weight keys, edge-weight source layer, notes.
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    def complexity(self) -> float:
        """Theoretical computation complexity (paper Eq. 10/11)."""
        t = self.layer_type
        if t == LayerType.AGGREGATE:
            return 2.0 * self.f_in * self.n_edges
        if t == LayerType.LINEAR:
            return 2.0 * self.f_in * self.f_out * self.n_vertices
        if t == LayerType.VECTOR_INNER:
            return 2.0 * self.f_in * self.n_edges
        if t == LayerType.VECTOR_ADD:
            return 1.0 * self.f_in * self.n_vertices
        if t == LayerType.ACTIVATION:
            n = self.n_edges if self.attrs.get("on_edges") else self.n_vertices
            return 1.0 * max(self.f_in, 1) * n
        if t == LayerType.BATCHNORM:
            return 4.0 * self.f_in * self.n_vertices
        raise ValueError(t)

    def copy(self) -> "LayerIR":
        return dataclasses.replace(
            self,
            parent_ids=list(self.parent_ids),
            child_ids=list(self.child_ids),
            attrs=dict(self.attrs),
        )

    def short(self) -> str:
        extra = ""
        if self.layer_type == LayerType.AGGREGATE:
            extra = f" agg={self.agg_op.name}"
        if self.act_enabled:
            extra += f" act={self.act.name}"
        return (
            f"L{self.layer_id}:{self.layer_type.name}"
            f"({self.f_in}->{self.f_out}){extra}"
        )


class ModelIR:
    """IR of a GNN model: a DAG of LayerIRs (paper Listing 2)."""

    def __init__(self) -> None:
        self.layers: "OrderedDict[int, LayerIR]" = OrderedDict()
        self.graph_meta: Dict[str, Any] = {}
        self.weights: Dict[str, Any] = {}  # name -> array (host numpy/jnp)
        self.name: str = "model"

    # ------------------------------------------------------------------ #
    def add_layer(self, layer: LayerIR) -> None:
        assert layer.layer_id not in self.layers, layer.layer_id
        self.layers[layer.layer_id] = layer

    def next_id(self) -> int:
        return (max(self.layers) + 1) if self.layers else 1

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def total_complexity(self) -> float:
        return sum(l.complexity() for l in self.layers.values())

    # ------------------------------------------------------------------ #
    def topo_order(self) -> List[int]:
        """Topological order of layer ids."""
        indeg = {i: len(l.parent_ids) for i, l in self.layers.items()}
        ready = [i for i, d in indeg.items() if d == 0]
        out: List[int] = []
        while ready:
            ready.sort()
            i = ready.pop(0)
            out.append(i)
            for c in self.layers[i].child_ids:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(out) != len(self.layers):
            raise ValueError("cycle in ModelIR")
        return out

    def validate(self) -> None:
        for i, l in self.layers.items():
            assert l.layer_id == i
            for p in l.parent_ids:
                assert i in self.layers[p].child_ids, (i, p)
            for c in l.child_ids:
                assert i in self.layers[c].parent_ids, (i, c)
        self.topo_order()

    # ------------------------------------------------------------------ #
    def exchange(self, a_id: int, b_id: int) -> None:
        """Exchange an adjacent (parent a -> child b) pair in the DAG.

        Used by the order-optimization pass for {Aggregate, Linear} pairs.
        After the exchange, b takes a's position and a becomes b's child.
        Feature dimensions are rewired: the moved Linear keeps its (f_in,
        f_out); the Aggregate layer's width becomes the Linear's f_out
        (Theorem 1: Agg(H)·W == Agg(H·W) for linear AggOp).
        """
        a = self.layers[a_id]
        b = self.layers[b_id]
        assert a.child_ids == [b_id] and b.parent_ids == [a_id]
        # Rewire parents of a -> b, children of b -> a.
        for p in a.parent_ids:
            pl = self.layers[p]
            pl.child_ids = [b_id if c == a_id else c for c in pl.child_ids]
        for c in b.child_ids:
            cl = self.layers[c]
            cl.parent_ids = [a_id if p == b_id else p for p in cl.parent_ids]
        b.parent_ids, a.parent_ids = list(a.parent_ids), [b_id]
        a.child_ids, b.child_ids = list(b.child_ids), [a_id]
        # Downstream consumers referenced the old pair tail (b) by id in
        # attrs (vector-add operands, dynamic edge-weight sources) — the pair
        # output is now produced by a.
        for cid in a.child_ids:
            cl = self.layers[cid]
            if "operands" in cl.attrs:
                cl.attrs["operands"] = [
                    a_id if o == b_id else o for o in cl.attrs["operands"]]
            if cl.attrs.get("edge_weight_layer") == b_id:
                cl.attrs["edge_weight_layer"] = a_id
        # Fix widths: identify which one is the Aggregate.
        agg, lin = (a, b) if a.layer_type == LayerType.AGGREGATE else (b, a)
        assert agg.layer_type == LayerType.AGGREGATE
        assert lin.layer_type == LayerType.LINEAR
        # After exchange the Aggregate operates on the Linear's other side.
        if agg is a:
            # was Agg->Lin, becomes Lin->Agg: Agg now sees lin.f_out features
            agg.f_in = agg.f_out = lin.f_out
        else:
            # was Lin->Agg, becomes Agg->Lin: Agg now sees lin.f_in features
            agg.f_in = agg.f_out = lin.f_in

    # ------------------------------------------------------------------ #
    def replace_refs(self, old_id: int, new_id: int) -> None:
        """Repoint attrs references (vector-add operands, edge-weight
        sources) from ``old_id`` to ``new_id`` in every layer."""
        for l in self.layers.values():
            if "operands" in l.attrs:
                l.attrs["operands"] = [
                    new_id if o == old_id else o for o in l.attrs["operands"]]
            if l.attrs.get("edge_weight_layer") == old_id:
                l.attrs["edge_weight_layer"] = new_id

    def remove_layer(self, lid: int) -> None:
        """Remove a layer, splicing its parents to its children."""
        l = self.layers[lid]
        for p in l.parent_ids:
            pl = self.layers[p]
            pl.child_ids = [c for c in pl.child_ids if c != lid]
            for c in l.child_ids:
                if c not in pl.child_ids:
                    pl.child_ids.append(c)
        for c in l.child_ids:
            cl = self.layers[c]
            cl.parent_ids = [p for p in cl.parent_ids if p != lid]
            for p in l.parent_ids:
                if p not in cl.parent_ids:
                    cl.parent_ids.append(p)
        del self.layers[lid]

    def copy(self) -> "ModelIR":
        m = ModelIR()
        m.layers = OrderedDict((i, l.copy()) for i, l in self.layers.items())
        m.graph_meta = dict(self.graph_meta)
        m.weights = dict(self.weights)
        m.name = self.name
        return m

    def dump(self) -> str:
        return " | ".join(self.layers[i].short() for i in self.topo_order())
