"""Plain reference of gat-dot (SuperGAT's dot-product attention, one
head): H = X W + b; e_uv = LReLU(<H_u, H_v>, slope) on every edge u -> v
of the graph with self loops added; alpha the softmax of e over the
edges into v (each destination's largest score subtracted first);
X'_v = act(sum_u alpha_uv H_u), act ReLU on every layer but the last."""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from .common import Matmul, edge_dots, edges_with_self_loops, scatter_rows


def forward(x: torch.Tensor, src, dst, n: int,
            linears: List[Tuple[torch.Tensor, torch.Tensor]], cfg: dict,
            mm: Matmul = torch.matmul) -> torch.Tensor:
    s, d = edges_with_self_loops(src, dst, n, x.device)
    slope = float(cfg["negative_slope"])
    h = x
    for i, (wt, b) in enumerate(linears):
        h = mm(h, wt.to(x.dtype)) + b.to(x.dtype)
        e = F.leaky_relu(edge_dots(h, s, d), slope)
        top = torch.full((n,), float("-inf"), dtype=e.dtype, device=e.device)
        top = top.scatter_reduce(0, d, e, "amax", include_self=True)
        a = torch.exp(e - top[d])
        den = torch.zeros(n, dtype=e.dtype, device=e.device).index_add_(
            0, d, a)
        h = scatter_rows(h, s, d, a / den[d], n)
        if i < len(linears) - 1:
            h = torch.relu(h)
    return h
