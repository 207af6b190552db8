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
* :func:`lm_params_from_arrays` — a decoder LM's parameter pytree (JAX's
  ``DecoderLM.init_params`` as nested dicts and tuples of numpy arrays,
  segments stacked on a leading ``rep`` axis) as the port model's state
  dict; :func:`lm_param_shapes` the same names with the shapes only (a MoE
  block's experts permuted to the port's E-major layout, ``PERMUTED``).  Both
  also take JAX's ``WhisperModel`` pytree (an ``encoder_decoder`` config):
  its encoder blocks, stacked on a leading layer axis, become
  ``encoder.blocks.{i}``, and its decoder the ``decoder.`` names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.ir import Activation, AggOp, LayerIR, LayerType, ModelIR
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import build_segments


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


# --------------------------------------------------------------------------- #
# Decoder LM weights.
# --------------------------------------------------------------------------- #
def _dict_leaves(prefix: str, node, r: Optional[int]
                 ) -> Iterator[Tuple[str, Any, Any]]:
    """(dotted name, leaf, r) for every leaf of a nest of dicts."""
    stack = [(prefix, node)]
    while stack:
        prefix, node = stack.pop()
        if isinstance(node, dict):
            stack.extend((f"{prefix}.{k}", v) for k, v in node.items())
        else:
            yield prefix, node, r


def _lm_leaves(cfg: ModelConfig, params) -> Iterator[Tuple[str, Any, Any]]:
    """(port name, JAX leaf, index on its leading axis or None) for every
    parameter.  Port layer i is the i-th block JAX's scan applies: segment
    s, repeat r, superblock position b, i.e.
    ``params["segments"][s][b][...][r]`` (a cross block's ``ln_x`` /
    ``xattn`` among them).  An encoder-decoder's encoder block i is
    ``params["encoder"]["blocks"][...][i]``, and its decoder is a decoder
    LM on ``cross_attn_every=1`` under ``decoder.``."""
    if cfg.encoder_decoder:
        for i in range(cfg.n_encoder_layers):
            yield from _dict_leaves(f"encoder.blocks.{i}",
                                    params["encoder"]["blocks"], i)
        yield "encoder.final_norm", params["encoder"]["final_norm"], None
        dec = dataclasses.replace(cfg, cross_attn_every=1,
                                  encoder_decoder=False)
        for name, leaf, r in _lm_leaves(dec, params["decoder"]):
            yield f"decoder.{name}", leaf, r
        return
    for name in ("embed", "final_norm", "head"):
        if name in params:              # "head": an untied LM head
            yield name, params[name], None
    i = 0
    for s, (sb, rep) in enumerate(build_segments(cfg)):
        for r in range(rep):
            for b in range(len(sb)):
                yield from _dict_leaves(f"layers.{i}",
                                        params["segments"][s][b], r)
                i += 1


# JAX's leaves that the port stores with their axes permuted: a MoE
# block's experts, (d, E, f) / (f, E, d) in JAX, E-major in the port.
PERMUTED = {"moe.wi": (1, 0, 2), "moe.wg": (1, 0, 2), "moe.wo": (1, 0, 2)}


def _axes(name: str) -> Optional[Tuple[int, ...]]:
    """The permutation from JAX's leaf to the port's parameter ``name``
    (None: the same axes)."""
    return PERMUTED.get(".".join(name.split(".")[-2:]))


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes, as JAX hands it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_arrays(cfg: ModelConfig, params) -> Dict[str,
                                                            torch.Tensor]:
    """JAX's decoder-LM pytree (``jax.tree.map(np.asarray,
    model.init_params(key))``) -> the port's state dict (CPU tensors, the
    arrays' dtypes; load with ``model.load_state_dict``).  A block's
    nested dicts become dotted names (hymba's ``layers.{i}.ssm.A_log``,
    xLSTM's ``layers.{i}.core.r_z``, a MoE block's
    ``layers.{i}.moe.shared.wi``).  A MoE block's ``wi`` / ``wg`` (d, E, f)
    and ``wo`` (f, E, d) are transposed to [E, d, f] / [E, f, d]
    (``PERMUTED``).  ``load_state_dict`` casts into each port parameter's
    dtype, which is its JAX leaf's (the fp32 leaves of a bf16 model, such
    as the MoE router, stay fp32), so no value is rounded on the way."""
    out = {}
    for name, leaf, r in _lm_leaves(cfg, params):
        a = leaf if r is None else np.asarray(leaf)[r]
        axes = _axes(name)
        out[name] = _to_tensor(a if axes is None
                               else np.transpose(np.asarray(a), axes))
    return out


def lm_param_shapes(cfg: ModelConfig, params) -> Dict[str, tuple]:
    """The names and shapes :func:`lm_params_from_arrays` would return,
    read from anything with a ``.shape`` (e.g. ``jax.eval_shape``'s
    ShapeDtypeStructs), without touching data."""
    out = {}
    for name, leaf, r in _lm_leaves(cfg, params):
        shape = tuple(leaf.shape[1:] if r is not None else leaf.shape)
        axes = _axes(name)
        out[name] = shape if axes is None else tuple(shape[i] for i in axes)
    return out
