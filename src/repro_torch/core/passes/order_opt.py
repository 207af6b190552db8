"""Compiler Step 1 — computation order optimization (paper §6.3, Alg. 5).

For every adjacent {Aggregate, Linear} pair where the aggregation operator is
linear (Definition 1) and the exchange lowers total complexity (Theorem 2),
exchange the two layers.  Applied to a fixpoint.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..ir import LayerType, ModelIR


@dataclasses.dataclass
class OrderOptReport:
    exchanges: List[Tuple[int, int]]
    complexity_before: float
    complexity_after: float

    @property
    def reduction(self) -> float:
        if self.complexity_before == 0:
            return 0.0
        return 1.0 - self.complexity_after / self.complexity_before


def _try_pairs(m: ModelIR) -> List[Tuple[int, int]]:
    """One sweep of Algorithm 5; returns pairs exchanged."""
    done: List[Tuple[int, int]] = []
    for lid in list(m.topo_order()):
        if lid not in m.layers:
            continue
        l = m.layers[lid]
        # Check: layer l has only one child m_.
        if len(l.child_ids) != 1:
            continue
        mid = l.child_ids[0]
        ml = m.layers[mid]
        # Check: layer m_ has only one parent (l).
        if len(ml.parent_ids) != 1:
            continue
        # Check: {Aggregate, Linear} pair (either order).
        pair = {l.layer_type, ml.layer_type}
        if pair != {LayerType.AGGREGATE, LayerType.LINEAR}:
            continue
        agg = l if l.layer_type == LayerType.AGGREGATE else ml
        lin = ml if agg is l else l
        # Check: aggregation operator is linear (Definition 1).
        if agg.agg_op is None or not agg.agg_op.is_linear:
            continue
        # Dynamic edge weights (GAT) give the Aggregate a second parent, so
        # they are already excluded by the single-parent check; be explicit:
        if "edge_weight_layer" in agg.attrs:
            continue
        # Fused epilogues pin the order (act(agg(x))·W != act(agg(x·W))).
        if "fused_act" in l.attrs:
            continue
        # Check: exchanging reduces complexity (Theorem 2).
        before = l.complexity() + ml.complexity()
        f1, f2 = lin.f_in, lin.f_out
        e, v = agg.n_edges, agg.n_vertices
        if l is agg:  # Aggregate->Linear, candidate Linear->Aggregate
            after = 2.0 * f1 * f2 * v + 2.0 * f2 * e
        else:         # Linear->Aggregate, candidate Aggregate->Linear
            after = 2.0 * f1 * e + 2.0 * f1 * f2 * v
        if after >= before:
            continue
        m.exchange(lid, mid)
        done.append((lid, mid))
    return done


def run(m: ModelIR, enabled: bool = True) -> OrderOptReport:
    before = m.total_complexity()
    exchanges: List[Tuple[int, int]] = []
    if enabled:
        while True:
            got = _try_pairs(m)
            if not got:
                break
            exchanges.extend(got)
    return OrderOptReport(exchanges, before, m.total_complexity())
