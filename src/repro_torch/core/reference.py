"""Plain torch execution of a ModelIR on a graph — the port's oracle.

It mirrors ``repro/core/reference.py`` layer for layer: every layer
materializes a full |V| x F intermediate, with no partitioning, fusion or
reordering, and aggregation is an edge scatter (``index_add_`` /
``scatter_reduce``).  It runs on whatever device ``x`` lies on, so it is
also the reference ``chip_smoke.py`` holds the overlay against on the card.

Numerics follow the JAX reference: GELU is the tanh approximation
(``jax.nn.gelu``'s default), LRELU's slope is 0.2 and PRELU's 0.25, an
empty MAX/MIN segment yields 0, and edge softmax maps an empty row's max
to 0 and clamps its denominator at 1e-12.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .graph import Graph
from .ir import Activation, AggOp, LayerIR, LayerType, ModelIR


def apply_activation(x: torch.Tensor, act: Activation) -> torch.Tensor:
    if act == Activation.NONE:
        return x
    if act == Activation.RELU:
        return torch.relu(x)
    if act == Activation.LRELU:
        return F.leaky_relu(x, 0.2)
    if act == Activation.PRELU:
        return torch.where(x >= 0, x, 0.25 * x)
    if act in (Activation.SWISH, Activation.SILU):
        return x * torch.sigmoid(x)
    if act == Activation.EXP:
        return torch.exp(x)
    if act == Activation.SIGMOID:
        return torch.sigmoid(x)
    if act == Activation.GELU:
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"activation {act} must be handled by caller")


def _segment_extreme(msg: torch.Tensor, dst: torch.Tensor, n: int,
                     reduce: str) -> torch.Tensor:
    """Per-destination max/min of ``msg`` rows; empty segments give 0."""
    fill = float("-inf") if reduce == "amax" else float("inf")
    shape = (n,) + tuple(msg.shape[1:])
    out = torch.full(shape, fill, dtype=msg.dtype, device=msg.device)
    idx = dst.view((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
    out = out.scatter_reduce(0, idx, msg, reduce, include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def edge_softmax(ew: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax of edge scores over incoming edges of each destination."""
    mx = _segment_extreme(ew, dst, n, "amax")
    ex = torch.exp(ew - mx[dst])
    den = torch.zeros(n, dtype=ew.dtype, device=ew.device).index_add_(
        0, dst, ex)
    return ex / torch.clamp(den[dst], min=1e-12)


def aggregate(x: torch.Tensor, g: Graph, op: AggOp,
              edge_w: Optional[torch.Tensor]) -> torch.Tensor:
    """out[dst] = AggOp_{e=(src,dst)} (w_e * x[src])   (paper Eq. 5)."""
    src, dst = _edges(g, x.device)
    w = (torch.as_tensor(g.weight, device=x.device).to(x.dtype)
         if edge_w is None else edge_w)
    msg = x[src] * w[:, None]
    n = g.n_vertices
    if op in (AggOp.SUM, AggOp.MEAN):
        s = torch.zeros((n, x.shape[1]), dtype=x.dtype,
                        device=x.device).index_add_(0, dst, msg)
        if op == AggOp.SUM:
            return s
        deg = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
            0, dst, torch.ones_like(w))
        return s / torch.clamp(deg, min=1.0)[:, None]
    if op == AggOp.MAX:
        return _segment_extreme(msg, dst, n, "amax")
    if op == AggOp.MIN:
        return _segment_extreme(msg, dst, n, "amin")
    raise ValueError(op)


def _edges(g: Graph, device) -> tuple:
    return (torch.as_tensor(np.asarray(g.src, np.int64), device=device),
            torch.as_tensor(np.asarray(g.dst, np.int64), device=device))


def _w(weights, key: str, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(weights[key]).to(device=x.device, dtype=x.dtype)


def run_reference(model: ModelIR, g: Graph, x,
                  weights: Optional[Dict[str, np.ndarray]] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Execute the IR layer by layer; returns the final layer's output.
    ``x`` is a tensor (numpy is taken as CPU); every intermediate lives on
    ``x``'s device, in ``dtype`` (float64 gives a reference whose own
    rounding is negligible next to an fp32 run's)."""
    x = torch.as_tensor(x).to(dtype)
    dev = x.device
    weights = weights if weights is not None else model.weights
    vals: Dict[int, torch.Tensor] = {}

    def inp(lid_or_input: int) -> torch.Tensor:
        return x if lid_or_input == -1 else vals[lid_or_input]

    out_id = None
    for lid in model.topo_order():
        l: LayerIR = model.layers[lid]
        feat_parents = [p for p in l.parent_ids
                        if p != l.attrs.get("edge_weight_layer")]
        h = vals[feat_parents[0]] if feat_parents else x

        if l.layer_type == LayerType.AGGREGATE:
            ewl = l.attrs.get("edge_weight_layer")
            ew = vals[ewl] if ewl is not None else None
            y = aggregate(h, g, l.agg_op, ew)
        elif l.layer_type == LayerType.LINEAR:
            y = h @ _w(weights, l.attrs["W"], x)
            if "b" in l.attrs:
                y = y + _w(weights, l.attrs["b"], x)
        elif l.layer_type == LayerType.VECTOR_INNER:
            src, dst = _edges(g, dev)
            if l.attrs.get("mode") == "pair_sum":
                y = h[src, 0] + h[dst, 1]
            else:
                y = torch.sum(h[src] * h[dst], dim=-1)
        elif l.layer_type == LayerType.VECTOR_ADD:
            a, b = l.attrs["operands"]
            y = l.attrs["alpha"] * inp(a) + l.attrs["beta"] * inp(b)
        elif l.layer_type == LayerType.ACTIVATION:
            if l.act == Activation.EDGE_SOFTMAX:
                y = edge_softmax(h, _edges(g, dev)[1], g.n_vertices)
            else:
                y = apply_activation(h, l.act)
        elif l.layer_type == LayerType.BATCHNORM:
            p = {k: _w(weights, l.attrs[k], x)
                 for k in ("mu", "sigma", "gamma", "beta")}
            eps = l.attrs.get("eps", 1e-5)
            y = (h - p["mu"]) / torch.sqrt(p["sigma"] ** 2 + eps)
            y = y * p["gamma"] + p["beta"]
        else:
            raise ValueError(l.layer_type)

        # Fused epilogues (set by the fusion pass): scale/shift then act.
        if "fused_scale" in l.attrs:
            y = (y * _w(weights, l.attrs["fused_scale"], x)
                 + _w(weights, l.attrs["fused_shift"], x))
        if "fused_act" in l.attrs:
            fa = Activation(l.attrs["fused_act"])
            if fa == Activation.EDGE_SOFTMAX:
                y = edge_softmax(y, _edges(g, dev)[1], g.n_vertices)
            else:
                y = apply_activation(y, fa)
        vals[lid] = y
        out_id = lid
    # Output = last layer in topo order with no children.
    sinks = [i for i, l in model.layers.items() if not l.child_ids]
    return vals[sinks[-1]] if sinks else vals[out_id]
