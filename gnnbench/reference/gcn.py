"""Plain reference of GCN: H' = act(A_hat H W + b), computed in the
published order (aggregate, then the weights), with A_hat recomputed
from the raw edges: self loops added, edge u -> v weighted
1 / sqrt(deg(u) deg(v)), deg the in-degree with self loops (PyG's
``gcn_norm``)."""
from __future__ import annotations

from typing import List, Tuple

import torch

from .common import Matmul, edges_with_self_loops, scatter_rows


def forward(x: torch.Tensor, src, dst, n: int,
            linears: List[Tuple[torch.Tensor, torch.Tensor]], cfg: dict,
            mm: Matmul = torch.matmul) -> torch.Tensor:
    """The model's output for features ``x`` [n, f], in ``x``'s dtype and
    on its device; ``linears`` are the (W, b) of each layer."""
    s, d = edges_with_self_loops(src, dst, n, x.device)
    deg = torch.bincount(d, minlength=n).to(x.dtype).clamp(min=1.0)
    inv = deg.rsqrt()
    w = inv[s] * inv[d]
    h = x
    for i, (wt, b) in enumerate(linears):
        h = mm(scatter_rows(h, s, d, w, n), wt.to(x.dtype)) + b.to(x.dtype)
        if i < len(linears) - 1:
            h = torch.relu(h)
    return h
