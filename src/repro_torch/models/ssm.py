"""Selective SSM head (Mamba-style) for the Hymba hybrid architecture
(torch; a port of ``repro/models/ssm.py``).

Per head: state h in R^{P x N} (P = head dim, N = ssm_state).
  h_t = exp(-softplus(dt_t) * A) * h_{t-1} + dt_t * (x_t outer B_t)
  y_t = h_t C_t + D * x_t
with input-dependent dt [B,T,H], B,C [B,T,N] (shared across heads, as in
Mamba), A [H] positive per head.  ``xs`` stays in the activation dtype;
``B``, ``C`` and ``dt`` are cast to fp32 after their products, and all
state math is fp32; ``y`` is cast back before ``w_out``.

Two full-sequence forms, as in JAX: :func:`ssm_scan_ssd` (mamba-2's dual
form, the config's default ``ssm_impl="ssd"``), a loop over chunks of
256 steps (the whole sequence when T is not a multiple of 256 or T <=
256) that carries the state only across chunk boundaries; and
:func:`ssm_scan` (``ssm_impl="assoc"``).  JAX computes the latter with an
associative scan inside each chunk; torch has none, so the port runs the
recurrence as a serial loop over the steps, which computes the same
function (held to JAX by tolerance, not by bits; chunking does not change
a serial recurrence, so the loop takes no chunk size).  :func:`ssm_decode_step`
carries the (B,H,P,N) fp32 state one token and, unlike JAX, which
returns a new state, writes it in place, so that a captured decode step
updates fixed storage.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .attention import _proj
from .layers import Params, dense_init


def ssm_init(gen: torch.Generator, d: int, n_heads: int, head_dim: int,
             state: int, dtype: torch.dtype, device=None) -> dict:
    """JAX ``ssm_init``'s leaves and dtypes: the projections in the model
    dtype, ``dt_bias``, ``A_log`` and ``D`` in fp32."""
    f32 = torch.float32
    return {
        "w_in": dense_init(gen, d, (n_heads, head_dim), dtype,
                           device=device),
        "w_bc": dense_init(gen, d, 2 * state, dtype, device=device),
        "w_dt": dense_init(gen, d, n_heads, dtype, device=device),
        "dt_bias": torch.zeros(n_heads, dtype=f32, device=device),
        "A_log": torch.zeros(n_heads, dtype=f32, device=device),
        "D": torch.full((n_heads,), 0.1, dtype=f32, device=device),
        "w_out": dense_init(gen, n_heads * head_dim, d, dtype,
                            device=device),
    }


def _gates(p: Params, x: torch.Tensor, state: int):
    xs = _proj(x, p["w_in"])                             # [B,T,H,P]
    bc = torch.matmul(x, p["w_bc"]).float()
    Bm, Cm = bc[..., :state], bc[..., state:]            # [B,T,N]
    z = torch.matmul(x, p["w_dt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(z, torch.zeros_like(z))         # [B,T,H] softplus
    A = torch.exp(p["A_log"])                            # [H] > 0
    decay = torch.exp(-dt * A)                           # [B,T,H]
    return xs, Bm, Cm, dt, decay


def _out(p: Params, y: torch.Tensor, xs: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """D skip, back to the activation dtype, then ``w_out``."""
    b, t, h, pdim = y.shape
    y = y + p["D"][:, None] * xs.float()
    return torch.matmul(y.reshape(b, t, h * pdim).to(dtype), p["w_out"])


def ssm_scan(p: Params, x: torch.Tensor, state: int) -> torch.Tensor:
    """The selective scan as a serial recurrence over the steps (JAX's
    chunked associative scan computes the same function).  x [B,T,D] ->
    y [B,T,D]."""
    xs, Bm, Cm, dt, decay = _gates(p, x, state)
    b, t, h, pdim = xs.shape
    u_x = dt[..., None] * xs.float()                     # [B,T,H,P]
    hs = torch.zeros(b, h, pdim, state, dtype=torch.float32,
                     device=x.device)
    ys = []
    for i in range(t):
        hs = (hs * decay[:, i, :, None, None]
              + u_x[:, i, :, :, None] * Bm[:, i, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cm[:, i]))
    return _out(p, torch.stack(ys, dim=1), xs, x.dtype)


def ssm_scan_ssd(p: Params, x: torch.Tensor, state: int,
                 chunk: int = 256) -> torch.Tensor:
    """SSD (mamba-2 duality) form of the selective scan, JAX's
    ``ssm_scan_ssd``: per chunk

      y_t = sum_{j<=t} [ (C_t . B_j) dt_j exp(L_t - L_j) ] x_j
            + exp(L_t) (C_t . h0)

    with L = cumsum(log decay) within the chunk; the decay differences
    are clipped to [-60, 0] and then masked to j <= t; the state exists
    only at chunk boundaries.  x [B,T,D] -> y [B,T,D]."""
    xs, Bm, Cm, dt, decay = _gates(p, x, state)
    b, t, h, pdim = xs.shape
    if t % chunk != 0 or t <= chunk:
        chunk = t
    nc = t // chunk
    xf = xs.float()
    logd = torch.log(torch.clamp(decay, min=1e-38))      # = -dt * A
    L = torch.cumsum(logd.reshape(b, nc, chunk, h), dim=2)   # per chunk
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    h0 = torch.zeros(b, h, pdim, state, dtype=torch.float32,
                     device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, bc, cc, dtc = xf[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl]
        lc = L[:, c]
        # intra-chunk: scores S[t,j] = (C_t.B_j) dt_j exp(L_t - L_j)
        cb = torch.einsum("btn,bjn->btj", cc, bc)            # [B,c,c]
        dec = torch.exp(torch.clamp(lc[:, :, None] - lc[:, None, :],
                                    -60.0, 0.0))             # [B,c,c,H]
        s = cb[..., None] * dtc[:, None] * dec
        s = s.masked_fill(~mask[None, :, :, None], 0.0)
        y = torch.einsum("btjh,bjhp->bthp", s, xc)
        # carry-in: exp(L_t) (C_t . h0)
        ch0 = torch.einsum("btn,bhpn->bthp", cc, h0)
        ys.append(y + torch.exp(lc)[..., None] * ch0)
        # chunk-boundary state
        l_end = lc[:, -1]                                    # [B,H]
        w = dtc * torch.exp(torch.clamp(l_end[:, None] - lc, -60.0, 0.0))
        h0 = (torch.einsum("bjh,bjhp,bjn->bhpn", w, xc, bc)
              + torch.exp(l_end)[..., None, None] * h0)
    return _out(p, torch.cat(ys, dim=1), xs, x.dtype)


def ssm_decode_init(batch: int, n_heads: int, head_dim: int, state: int,
                    device=None) -> torch.Tensor:
    return torch.zeros(batch, n_heads, head_dim, state, dtype=torch.float32,
                       device=device)


def ssm_decode_step(p: Params, x: torch.Tensor, h: torch.Tensor, state: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token.  x [B,1,D]; h [B,H,P,N] fp32, written in place and
    returned."""
    xs, Bm, Cm, dt, decay = _gates(p, x, state)
    u = (dt[..., None, None] * xs.float()[..., None]
         * Bm[:, :, None, None, :])[:, 0]
    h.copy_(h * decay[:, 0][..., None, None] + u)
    y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0])
    return _out(p, y[:, None], xs, x.dtype), h
