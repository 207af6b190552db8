"""Carry weights, graphs and models across into the port.

The port shares no objects with the JAX package: what crosses over is
plain data — numpy arrays and dicts of plain values.  A ``.gagi`` bundle
needs no conversion at all (``CompiledProgram.load`` reads either
package's bundles as they are).

* :func:`weights_from_numpy` — a weight dict as tensors on a device.
* :func:`graph_from_arrays` — a COO edge list as a port :class:`Graph`.
* :func:`layer_table` / :func:`model_from_arrays` — a model's layer DAG
  as a plain table (the per-layer fields of the program manifest plus
  type, widths and operators) and back into a port :class:`ModelIR`.
  ``layer_table`` reads any object with the ``ModelIR`` attributes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.ir import Activation, AggOp, LayerIR, LayerType, ModelIR


_WEIGHT_KEYS = ("W", "b", "mu", "sigma", "gamma", "beta", "fused_scale",
                "fused_shift")


def weights_from_numpy(weights: Dict[str, np.ndarray],
                       device="cuda") -> Dict[str, torch.Tensor]:
    """``{name: array}`` -> ``{name: float32 tensor on device}``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            for k, v in weights.items()}


def graph_from_arrays(n_vertices: int, src, dst, weight=None,
                      feat_dim: int = 0, n_classes: int = 0,
                      name: str = "graph") -> Graph:
    """COO arrays -> Graph (int32 endpoints, float32 weights; unit
    weights when ``weight`` is None)."""
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be matching 1-D arrays, got "
                         f"{src.shape} and {dst.shape}")
    w = (np.ones(src.shape, np.float32) if weight is None
         else np.ascontiguousarray(weight, np.float32))
    if w.shape != src.shape:
        raise ValueError(f"weight shape {w.shape} != edge count "
                         f"{src.shape}")
    if src.size and (min(src.min(), dst.min()) < 0
                     or max(src.max(), dst.max()) >= n_vertices):
        raise ValueError("edge endpoints out of range [0, n_vertices)")
    return Graph(n_vertices=int(n_vertices), src=src, dst=dst, weight=w,
                 feat_dim=int(feat_dim), n_classes=int(n_classes),
                 name=name)


def _plain(v: Any) -> Any:
    """Attribute values as plain Python (enum members by value)."""
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "value") and isinstance(getattr(v, "value"), int):
        return int(v.value)
    return v


def layer_table(model) -> dict:
    """A model's layer DAG as plain data: ``{"name", "graph_meta",
    "layers": {str(id): {...}}}``, enums by name, attrs as plain values.
    Works on any object with ``ModelIR``'s attributes."""
    layers = {}
    for lid, l in model.layers.items():
        layers[str(lid)] = {
            "type": l.layer_type.name,
            "parents": [int(p) for p in l.parent_ids],
            "children": [int(c) for c in l.child_ids],
            "f_in": int(l.f_in), "f_out": int(l.f_out),
            "n_vertices": int(l.n_vertices), "n_edges": int(l.n_edges),
            "agg_op": l.agg_op.name if l.agg_op is not None else None,
            "act": l.act.name, "act_enabled": bool(l.act_enabled),
            "batch_enabled": bool(l.batch_enabled),
            "attrs": {k: _plain(v) for k, v in l.attrs.items()},
        }
    return {"name": model.name, "graph_meta": dict(model.graph_meta),
            "layers": layers}


def model_from_arrays(layers: dict, weights: Dict[str, np.ndarray]
                      ) -> ModelIR:
    """Rebuild a port ModelIR from a :func:`layer_table` table and numpy
    weights (kept as float32 numpy arrays)."""
    m = ModelIR()
    m.name = layers.get("name", "model")
    m.graph_meta = dict(layers.get("graph_meta", {}))
    for key in sorted(layers["layers"], key=int):
        r = layers["layers"][key]
        m.add_layer(LayerIR(
            layer_type=LayerType[r["type"]], layer_id=int(key),
            parent_ids=[int(p) for p in r["parents"]],
            child_ids=[int(c) for c in r["children"]],
            f_in=int(r["f_in"]), f_out=int(r["f_out"]),
            n_vertices=int(r.get("n_vertices", 0)),
            n_edges=int(r.get("n_edges", 0)),
            agg_op=AggOp[r["agg_op"]] if r.get("agg_op") else None,
            act=Activation[r.get("act", "NONE")],
            act_enabled=bool(r.get("act_enabled", False)),
            batch_enabled=bool(r.get("batch_enabled", False)),
            attrs=dict(r.get("attrs", {}))))
    # weight-key attrs hold names (a vector-add's alpha/beta are floats)
    missing = {v for r in layers["layers"].values()
               for k, v in r.get("attrs", {}).items()
               if isinstance(v, str) and k in _WEIGHT_KEYS} - set(weights)
    if missing:
        raise KeyError(f"weights missing for {sorted(missing)}")
    m.weights = {k: np.asarray(v, np.float32) for k, v in weights.items()}
    m.validate()
    return m
