"""Plain torch versions of the hand kernels (the ``ref.py`` contract).

They mirror ``repro/kernels/ref.py`` (``gemm_ref``, ``spdmm_ref``): the CPU
tests run them, and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  Matrix products here run in full fp32 only where the caller
has left ``torch.backends.cuda.matmul.allow_tf32`` False (the default,
which ``chip_smoke.py`` sets explicitly).
"""
from __future__ import annotations

import torch


def gemm_ref(x: torch.Tensor, w: torch.Tensor,
             out_dtype=torch.float32) -> torch.Tensor:
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def spdmm_ref(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
              out_dtype=torch.float32) -> torch.Tensor:
    """out[r] = sum_k vals[r,k] * h[cols[r,k]].  Zero-padded entries
    (vals == 0) contribute nothing, so no mask is needed."""
    gathered = h.float()[cols.long()]                   # [n1, w, f]
    out = torch.sum(gathered * vals.float()[..., None], dim=1)
    return out.to(out_dtype)
