"""Gradient compression with error feedback (torch; a port of
``repro/distributed/compression.py``).

``compress`` / ``decompress`` are per-leaf symmetric int8 quantization
with the scale max|g| / 127; ``ef_transform`` wraps a mapping of
gradients with error-feedback residual state, so the quantization error
is carried to the next step instead of being lost.  As in JAX, the path
is exercised numerically (quantize -> dequantize -> optimizer) on one
device; no collective carries the int8 payload here.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.amax(torch.abs(g)).to(torch.float32) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def init_error_feedback(params: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def ef_transform(grads: Mapping[str, torch.Tensor],
                 ef_state: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Simulate int8 communication of (grads + residual); returns the
    dequantized gradients and the updated residual state."""
    out, res = {}, {}
    for n, g in grads.items():
        corrected = g.to(torch.float32) + ef_state[n]
        q, s = compress(corrected)
        deq = decompress(q, s)
        out[n], res[n] = deq.to(g.dtype), corrected - deq
    return out, res
