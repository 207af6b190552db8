"""The comparison that decides ``correct``.

Every output held for the check (a sample of the window's answered
requests drawn from the seed) is compared with the plain reference run
in float64 on the request's own features.  The number compared is

    out_err = max over the sample of  max|y - ref| / max|ref|,

the worst entry's distance from the reference as a share of the largest
entry of that request's output.  Its limit is the configuration's
``check.out_err``.  A request that was sent and never answered, or an
output of the wrong shape or with a value that is not finite, fails.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .inputs import Inputs

# Answered requests held for the comparison, a sample drawn from the seed.
SAMPLE = 64


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product whose operands are first rounded to TF32 (10
    mantissa bits, round to nearest even), as the tensor cores take them:
    the precision a float32 configuration must not slip to."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return tf32(a.float()) @ tf32(b.float())


def reference_outputs(cell_ref, cfg: dict, graph_edges, inputs: Inputs,
                      items, dtype=torch.float64,
                      mm: Callable = torch.matmul) -> Dict[int, torch.Tensor]:
    """The reference's output for each pool item in ``items``."""
    src, dst = graph_edges
    n = cfg["graph"]["n_vertices"]
    lin = [(w.to(dtype), b.to(dtype)) for w, b in inputs.linears]
    return {k: cell_ref.forward(inputs.features[k].to(dtype), src, dst, n,
                                lin, cfg, mm=mm)
            for k in sorted(set(items))}


def out_err(got: torch.Tensor, want: torch.Tensor) -> float:
    if tuple(got.shape) != tuple(want.shape) or not bool(
            torch.isfinite(got).all()):
        return float("inf")
    want = want.double()
    scale = float(want.abs().max())
    return float((got.double() - want).abs().max()) / max(scale, 1e-30)


def judge(cfg: dict, kept: List[Tuple[int, int, torch.Tensor]],
          refs: Dict[int, torch.Tensor], unanswered: int
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit"}}) for the held outputs."""
    worst: Optional[float] = None
    for _, item, out in kept:
        e = out_err(out, refs[item])
        worst = e if worst is None else max(worst, e)
    limit = float(cfg["check"]["out_err"])
    checks = {
        "out_err": {"value": worst if worst is not None
                    and math.isfinite(worst) else "inf", "limit": limit},
        "unanswered": {"value": unanswered, "limit": 0},
    }
    ok = worst is not None and worst <= limit and unanswered == 0
    return ok, checks
