"""Plain PyTorch pieces the references share: edge lists, scatter sums
over edges in blocks (so that a float64 reference at Flickr's size holds
a few hundred MB of messages at a time), and the matrix product, which a
control may replace by a lower-precision one."""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch

EDGE_BLOCK = 1 << 18

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def edges_with_self_loops(src, dst, n: int, device
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 (src, dst) on ``device`` with a loop i -> i for every vertex."""
    v = torch.arange(n, dtype=torch.int64, device=device)
    s = torch.cat([torch.as_tensor(src, device=device).long(), v])
    d = torch.cat([torch.as_tensor(dst, device=device).long(), v])
    return s, d


def scatter_rows(h: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
                 w: torch.Tensor, n: int) -> torch.Tensor:
    """out[d_e] += w_e * h[s_e] over every edge e."""
    out = torch.zeros((n, h.shape[1]), dtype=h.dtype, device=h.device)
    for a in range(0, s.shape[0], EDGE_BLOCK):
        b = a + EDGE_BLOCK
        out.index_add_(0, d[a:b], h[s[a:b]] * w[a:b, None])
    return out


def edge_dots(h: torch.Tensor, s: torch.Tensor, d: torch.Tensor
              ) -> torch.Tensor:
    """<h[s_e], h[d_e]> for every edge e."""
    parts: List[torch.Tensor] = []
    for a in range(0, s.shape[0], EDGE_BLOCK):
        b = a + EDGE_BLOCK
        parts.append((h[s[a:b]] * h[d[a:b]]).sum(dim=1))
    return torch.cat(parts)
