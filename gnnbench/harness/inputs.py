"""The cell's inputs, made from ``--seed``: the layers' weights, the pool
of feature matrices and the order in which requests draw from it.  The
same seed gives the same inputs; the program and the reference are
handed the same arrays."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

SEED_MOD = 1 << 63


@dataclasses.dataclass
class Inputs:
    linears: List[Tuple[torch.Tensor, torch.Tensor]]   # (W, b) on device
    features: torch.Tensor          # [pool, V, F] float32 on device
    items: list                     # pool item k as a request carries it
    order: np.random.Generator      # request i draws pool item order.integers


def make(cfg: dict, traffic: dict, family, seed: int, device) -> Inputs:
    """Weights N(0, 1/f_in) and biases N(0, bias_scale^2), then the
    feature pool N(0, scale^2), in two calls of one device generator."""
    seed %= SEED_MOD
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes = family.linear_shapes(cfg)
    flat = torch.randn(sum(a * b + b for a, b in shapes), generator=gen,
                       device=device)
    linears, off = [], 0
    for fi, fo in shapes:
        w = flat[off:off + fi * fo].view(fi, fo) / math.sqrt(fi)
        off += fi * fo
        b = flat[off:off + fo] * float(cfg["bias_scale"])
        linears.append((w, b))
        off += fo
    g = cfg["graph"]
    feats = torch.randn((traffic["pool"], g["n_vertices"], g["feat_dim"]),
                        generator=gen, device=device)
    feats.mul_(float(cfg["feature_scale"]))
    # Device placement: views of the pool; host placement: pageable
    # NumPy arrays.  Made once, so that making a request calls no torch.
    whole = feats.cpu().numpy() if traffic["placement"] == "host" else feats
    return Inputs(linears=linears, features=feats,
                  items=[whole[k] for k in range(whole.shape[0])],
                  order=np.random.default_rng([seed, 1]))


def bind_weights(model, linears) -> None:
    """Put the benchmark's weights into the program's model: its LINEAR
    layers in the order they run take ``linears`` in turn."""
    from repro_torch.core.ir import LayerType
    lin = [model.layers[i] for i in model.topo_order()
           if model.layers[i].layer_type == LayerType.LINEAR]
    if len(lin) != len(linears):
        raise ValueError(f"model has {len(lin)} LINEAR layers, the "
                         f"configuration {len(linears)}")
    for layer, (w, b) in zip(lin, linears):
        if (layer.f_in, layer.f_out) != tuple(w.shape):
            raise ValueError(f"layer {layer.layer_id} is {layer.f_in} x "
                             f"{layer.f_out}, the weight {tuple(w.shape)}")
        model.weights[layer.attrs["W"]] = w.cpu().numpy()
        model.weights[layer.attrs["b"]] = b.cpu().numpy()
