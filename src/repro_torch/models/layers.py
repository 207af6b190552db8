"""Shared neural layers: norms, RoPE, MLP, initializers (torch).

A port of ``repro/models/layers.py``.  Parameters are mappings of tensors
(``nn.ParameterDict`` inside the model, plain dicts in tests); every apply
function is shape-polymorphic over leading batch dims, accumulates norms
and softmax in fp32 and returns the input's dtype.  Initializers draw from
an explicit ``torch.Generator`` with the JAX initializers' scales (the
numbers differ from ``jax.random``'s; weights cross over with
``repro_torch.convert.lm_params_from_arrays``).

Three details the port keeps from the JAX functions: ``rms_norm`` scales
by ``1 + scale`` (zero-initialized scales), ``rope`` rotates the two
halves of the head dimension (not interleaved pairs), and ``swiglu`` gates
with ``h * sigmoid(g)`` (not ``h * silu(g)``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Union

import torch

Params = Mapping[str, torch.Tensor]


def dense_init(gen: torch.Generator, d_in: int,
               d_out: Union[int, Sequence[int]], dtype: torch.dtype,
               std: Optional[float] = None, device=None) -> torch.Tensor:
    """Normal(0, std) of shape (d_in, *d_out), drawn in fp32 and cast;
    ``std`` defaults to ``d_in ** -0.5``."""
    shape = (d_in,) + ((d_out,) if isinstance(d_out, int) else tuple(d_out))
    std = std if std is not None else d_in ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device or gen.device)
    return (x * std).to(dtype)


# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


# --------------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq
    sin, cos = torch.sin(ang), torch.cos(ang)      # [..., T, 1, half]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
def swiglu_init(gen: torch.Generator, d: int, f: int, dtype: torch.dtype,
                device=None) -> dict:
    return {
        "wi": dense_init(gen, d, f, dtype, device=device),
        "wg": dense_init(gen, d, f, dtype, device=device),
        "wo": dense_init(gen, f, d, dtype, device=device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, p["wi"])
    g = torch.matmul(x, p["wg"])
    h = h * torch.sigmoid(g.float()).to(h.dtype)
    return torch.matmul(h, p["wo"])


# --------------------------------------------------------------------------- #
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; fp32 logsumexp."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
