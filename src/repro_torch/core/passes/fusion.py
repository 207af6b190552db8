"""Compiler Step 2 — layer fusion (paper §6.4).

Activation Fusion: an Activation layer is merged into its (single) producer
— Aggregate, Linear, Vector-Inner, or Vector-Add — eliminating one full
round-trip of the |V|xF (or |E|) intermediate through external memory.

BatchNorm Fusion: at inference the BN affine y = (x-mu)/sqrt(s^2+eps)*g + b
is folded into the adjacent Linear's weight and bias.  BN adjacent to a
non-Linear producer is kept but rewritten into a fused scale/shift epilogue.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..ir import Activation, LayerType, ModelIR


@dataclasses.dataclass
class FusionReport:
    fused_activations: List[int]
    fused_batchnorms: List[int]
    layers_before: int
    layers_after: int


_FUSABLE_PRODUCERS = {
    LayerType.AGGREGATE,
    LayerType.LINEAR,
    LayerType.VECTOR_INNER,
    LayerType.VECTOR_ADD,
}


def _fuse_activations(m: ModelIR) -> List[int]:
    fused = []
    for lid in list(m.topo_order()):
        if lid not in m.layers:
            continue
        l = m.layers[lid]
        if l.layer_type != LayerType.ACTIVATION:
            continue
        if len(l.parent_ids) != 1:
            continue
        p = m.layers[l.parent_ids[0]]
        if p.layer_type not in _FUSABLE_PRODUCERS:
            continue
        if len(p.child_ids) != 1:       # producer output consumed elsewhere
            continue
        if "fused_act" in p.attrs:      # chain of activations: fuse only one
            # Merge a second point-wise activation only if composable order
            # is preserved; keep it simple: leave the second one standalone.
            continue
        p.attrs["fused_act"] = int(l.act)
        p.act_enabled, p.act = True, l.act
        m.remove_layer(lid)
        m.replace_refs(lid, p.layer_id)
        fused.append(lid)
    return fused


def _fold_batchnorms(m: ModelIR) -> List[int]:
    fused = []
    for lid in list(m.topo_order()):
        if lid not in m.layers:
            continue
        l = m.layers[lid]
        if l.layer_type != LayerType.BATCHNORM:
            continue
        if len(l.parent_ids) != 1:
            continue
        p = m.layers[l.parent_ids[0]]
        if len(p.child_ids) != 1:
            continue
        mu = np.asarray(m.weights[l.attrs["mu"]], np.float32)
        sig = np.asarray(m.weights[l.attrs["sigma"]], np.float32)
        gam = np.asarray(m.weights[l.attrs["gamma"]], np.float32)
        bet = np.asarray(m.weights[l.attrs["beta"]], np.float32)
        eps = float(l.attrs.get("eps", 1e-5))
        scale = gam / np.sqrt(sig ** 2 + eps)
        shift = bet - mu * scale
        if (p.layer_type == LayerType.LINEAR
                and "fused_act" not in p.attrs):
            # Fold into weights: y = (xW + b)*scale + shift.
            W = np.asarray(m.weights[p.attrs["W"]], np.float32) * scale
            m.weights[p.attrs["W"]] = W
            bkey = p.attrs.get("b")
            if bkey is None:
                bkey = f"L{p.layer_id}.b"
                p.attrs["b"] = bkey
                b = np.zeros(p.f_out, np.float32)
            else:
                b = np.asarray(m.weights[bkey], np.float32) * scale
            m.weights[bkey] = b + shift
            m.remove_layer(lid)
            m.replace_refs(lid, p.layer_id)
            fused.append(lid)
        elif (p.layer_type in _FUSABLE_PRODUCERS
                and "fused_act" not in p.attrs
                and "fused_scale" not in p.attrs):
            # Producer is not a Linear (or already has an epilogue):
            # keep the affine as a fused scale/shift epilogue.
            skey, hkey = f"L{lid}.fscale", f"L{lid}.fshift"
            m.weights[skey], m.weights[hkey] = scale, shift
            p.attrs["fused_scale"] = skey
            p.attrs["fused_shift"] = hkey
            m.remove_layer(lid)
            m.replace_refs(lid, p.layer_id)
            fused.append(lid)
    return fused


def run(m: ModelIR, enabled: bool = True) -> FusionReport:
    n0 = m.num_layers
    if not enabled:
        return FusionReport([], [], n0, n0)
    # BN first (so Linear+BN+Act folds fully), then activations.
    bns = _fold_batchnorms(m)
    acts = _fuse_activations(m)
    return FusionReport(acts, bns, n0, m.num_layers)
