"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, in a parallel
quadratic form) and sLSTM (scalar memory with a true recurrence) (torch; a
port of ``repro/models/xlstm_blocks.py``).

mLSTM per head (d_h = head dim):
  C_t = f_t C_{t-1} + i_t v_t k_t^T          (C in R^{d_h x d_h})
  n_t = f_t n_{t-1} + i_t k_t
  y_t = (C_t q_t) / max(|n_t . q_t|, 1)
with an exp input gate and a sigmoid forget gate in log space, stabilized
by a running max m_t.  sLSTM per head: scalar cell c_t, normalizer n_t,
and a recurrent connection on the hidden state through ``r_z`` [dh, H,
dh] (``einsum("bhe,ehf->bhf", h_prev, r_z)``).

The gate weights ``w_i`` / ``w_f`` (and the sLSTM's ``r_z``), and
``f_bias`` are fp32 leaves in a bf16 model, as in JAX: products of the
bf16 activations with them run in fp32 (JAX's einsum promotes).  GELU is
JAX's default, the tanh approximation.

The stabilizer of both full-sequence forms, JAX's associative scan
``(a1 + a2, max(b1 + a2, b2))`` over (log f, log i), is computed as
``m_t = F_t + cummax_j(log i_j - F_j)`` with F = cumsum(log f): the same
function, rounded differently (held to JAX by tolerance).  The sLSTM
scan runs its recurrence as a loop over T (JAX's ``lax.scan``); what
does not depend on the hidden state (the gates, m, the normalizer n) is
computed for all steps before the loop, n as ``exp(logcumsumexp_j(log
i_j - F_j) - cummax_j(log i_j - F_j))``, JAX's recurrence for n
unrolled, so that a step runs only the recurrent product, tanh and two
updates.  The stabilizer starts at -1e30, in the scans and in the decode
caches.  The decode steps write C, n, m (mLSTM) and c, n, h, m (sLSTM)
in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .attention import _proj
from .layers import Params, dense_init

M_INIT = -1e30


def _f32_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btf,fh->bth", x, w)`` with an fp32 ``w``: the promoted
    (fp32) product."""
    return torch.matmul(x.float(), w)


def _stabilizer(logf: torch.Tensor, logi: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F, a, m) over dim 1: F = cumsum(logf), a = logi - F and the
    running max m_t = max_{j<=t} (logi_j + F_t - F_j)."""
    Fc = torch.cumsum(logf, dim=1)
    a = logi - Fc
    return Fc, a, Fc + torch.cummax(a, dim=1).values


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #
def mlstm_init(gen: torch.Generator, d: int, n_heads: int,
               dtype: torch.dtype, pf: float = 2.0, device=None) -> dict:
    dh = int(d * pf) // n_heads
    du = dh * n_heads
    f32 = torch.float32
    return {
        "w_up": dense_init(gen, d, du, dtype, device=device),
        "w_q": dense_init(gen, du, (n_heads, dh), dtype, device=device),
        "w_k": dense_init(gen, du, (n_heads, dh), dtype, device=device),
        "w_v": dense_init(gen, du, (n_heads, dh), dtype, device=device),
        "w_i": dense_init(gen, du, n_heads, f32, std=0.02, device=device),
        "w_f": dense_init(gen, du, n_heads, f32, std=0.02, device=device),
        "f_bias": torch.full((n_heads,), 3.0, dtype=f32, device=device),
        "w_down": dense_init(gen, du, d, dtype, device=device),
    }


def _mlstm_gates(p: Params, x: torch.Tensor):
    u = torch.matmul(x, p["w_up"])
    q, k, v = (_proj(u, p[n]) for n in ("w_q", "w_k", "w_v"))
    logi = _f32_proj(u, p["w_i"])
    logf = F.logsigmoid(_f32_proj(u, p["w_f"]) + p["f_bias"])
    return u, q, k, v, logi, logf


def _mlstm_out(p: Params, y: torch.Tensor, u: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """y [B,T,H,dh] fp32 to the activation dtype, gated by silu(u), then
    ``w_down``."""
    y = y.to(dtype).flatten(-2)
    y = y * F.silu(u.float()).to(y.dtype)
    return torch.matmul(y, p["w_down"])


def mlstm_scan(p: Params, x: torch.Tensor, chunk: int = 256
               ) -> torch.Tensor:
    """Full-sequence mLSTM via the stabilized quadratic form, JAX's
    ``mlstm_scan``: y_t = sum_j D[t,j] (q_t.k_j) v_j / max(|sum_j D[t,j]
    (q_t.k_j)|, 1) with D[t,j] = exp(logi_j + F_t - F_j - m_t) for j <=
    t, queries in chunks of ``chunk`` when T > chunk and chunk divides T.
    The same values as JAX; its gradient is finite where JAX's is NaN
    (from T of about 1,800 at xlstm-125m's gate scales).
    x [B,T,D] -> y [B,T,D]."""
    u, q, k, v, logi, logf = _mlstm_gates(p, x)
    b, t, h, dh = q.shape
    Fc, a, m = _stabilizer(logf, logi)                      # [B,T,H]
    kf = k.float() * (dh ** -0.5)
    vf = v.float()
    qf = q.float()
    jpos = torch.arange(t, device=x.device)

    def one_chunk(q0: int, q1: int) -> torch.Tensor:
        logD = (a[:, None] + Fc[:, q0:q1, None]
                - m[:, q0:q1, None])                        # [B,c,T,H]
        # Masked before the exp, not after as JAX's ``where`` does: a
        # later key's logD can pass exp's range (F falls ~0.05 a step), and
        # the backward of where(mask, exp(logD), 0) is then 0 * inf.
        mask = jpos[q0:q1, None] >= jpos[None, :]
        D = torch.exp(logD.masked_fill(~mask[None, :, :, None],
                                       float("-inf")))
        s = torch.einsum("bqhe,bkhe->bqkh", qf[:, q0:q1], kf) * D
        num = torch.einsum("bqkh,bkhe->bqhe", s, vf)
        den = torch.clamp(torch.abs(torch.sum(s, dim=2)), min=1.0)
        return num / den[..., None]

    if chunk and t > chunk and t % chunk == 0:
        y = torch.cat([one_chunk(c, c + chunk) for c in range(0, t, chunk)],
                      dim=1)
    else:
        y = one_chunk(0, t)
    return _mlstm_out(p, y, u, x.dtype)


def mlstm_decode_init(batch: int, n_heads: int, dh: int, device=None
                      ) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    return {
        "C": torch.zeros(batch, n_heads, dh, dh, dtype=f32, device=device),
        "n": torch.zeros(batch, n_heads, dh, dtype=f32, device=device),
        "m": torch.full((batch, n_heads), M_INIT, dtype=f32, device=device),
    }


def mlstm_decode_step(p: Params, x: torch.Tensor,
                      st: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token.  x [B,1,D]; ``st`` (C, n, m) written in place and
    returned."""
    u, q, k, v, logi, logf = _mlstm_gates(p, x)
    dh = q.shape[-1]
    logi, logf = logi[:, 0], logf[:, 0]
    m_new = torch.maximum(logf + st["m"], logi)
    f_ = torch.exp(logf + st["m"] - m_new)
    i_ = torch.exp(logi - m_new)
    kf = k[:, 0].float() * (dh ** -0.5)
    vf = v[:, 0].float()
    st["C"].copy_(st["C"] * f_[..., None, None]
                  + i_[..., None, None] * torch.einsum("bhe,bhf->bhef",
                                                       vf, kf))
    st["n"].copy_(st["n"] * f_[..., None] + i_[..., None] * kf)
    st["m"].copy_(m_new)
    qf = q[:, 0].float()
    num = torch.einsum("bhef,bhf->bhe", st["C"], qf)
    den = torch.clamp(torch.abs(torch.einsum("bhe,bhe->bh", st["n"], qf)),
                      min=1.0)
    return _mlstm_out(p, (num / den[..., None])[:, None], u, x.dtype), st


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #
def slstm_init(gen: torch.Generator, d: int, n_heads: int,
               dtype: torch.dtype, pf: float = 4 / 3, device=None) -> dict:
    dh = d // n_heads
    f32 = torch.float32
    return {
        "w_z": dense_init(gen, d, (n_heads, dh), dtype, device=device),
        "w_i": dense_init(gen, d, n_heads, f32, std=0.02, device=device),
        "w_f": dense_init(gen, d, n_heads, f32, std=0.02, device=device),
        "w_o": dense_init(gen, d, (n_heads, dh), dtype, device=device),
        "r_z": dense_init(gen, dh, (n_heads, dh), f32, std=0.02,
                          device=device),
        "f_bias": torch.full((n_heads,), 3.0, dtype=f32, device=device),
        "w_up": dense_init(gen, d, int(d * pf), dtype, device=device),
        "w_down": dense_init(gen, int(d * pf), d, dtype, device=device),
    }


def _slstm_inputs(p: Params, x: torch.Tensor):
    """The gates' input products: z, o [B,T,H,dh] and i, f [B,T,H], all
    fp32 (z and o rounded to the activation dtype first, as in JAX)."""
    z = _proj(x, p["w_z"]).float()
    o = _proj(x, p["w_o"]).float()
    return z, _f32_proj(x, p["w_i"]), _f32_proj(x, p["w_f"]), o


def _slstm_out(p: Params, hs: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    """Hidden states [B,T,H,dh] to the activation dtype, then the
    up-projection, tanh-approximate GELU and the down-projection."""
    u = torch.matmul(hs.flatten(-2).to(dtype), p["w_up"])
    u = F.gelu(u.float(), approximate="tanh").to(u.dtype)
    return torch.matmul(u, p["w_down"])


def slstm_scan(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Sequential sLSTM (true recurrence on h), JAX's ``slstm_scan``.
    x [B,T,D] -> y [B,T,D]."""
    b, t, d = x.shape
    z_in, i_in, f_in, o_in = _slstm_inputs(p, x)
    logf = F.logsigmoid(f_in + p["f_bias"])                  # [B,T,H]
    _, a, m = _stabilizer(logf, i_in)
    m_prev = torch.cat([torch.full_like(m[:, :1], M_INIT), m[:, :-1]], 1)
    fs = torch.exp(logf + m_prev - m)
    is_ = torch.exp(i_in - m)
    n = torch.exp(torch.logcumsumexp(a, dim=1) - torch.cummax(a, dim=1)
                  .values)                                   # n_t >= 1
    gate = torch.sigmoid(o_in) / torch.clamp(n, min=1.0)[..., None]

    def steps(v):                       # [B,T,H,...] -> [T,H,B,...]
        return (v[..., None] if v.dim() == 3 else v).permute(1, 2, 0, 3)
    z_in, fs, is_, gate = (steps(v) for v in (z_in, fs, is_, gate))
    r = p["r_z"].permute(1, 0, 2)                            # [H,E,F]
    h_heads, dh = r.shape[0], r.shape[2]
    c = torch.zeros(h_heads, b, dh, dtype=torch.float32, device=x.device)
    hcur = torch.zeros_like(c)
    hs = []
    for i in range(t):
        zt = torch.baddbmm(z_in[i], hcur, r)                 # [H,B,dh]
        c = torch.addcmul(fs[i] * c, is_[i], torch.tanh(zt))
        hcur = gate[i] * c
        hs.append(hcur)
    return _slstm_out(p, torch.stack(hs).permute(2, 0, 1, 3), x.dtype)


def slstm_decode_init(batch: int, n_heads: int, dh: int, device=None
                      ) -> Dict[str, torch.Tensor]:
    f32 = torch.float32
    st = {k: torch.zeros(batch, n_heads, dh, dtype=f32, device=device)
          for k in ("c", "n", "h")}
    st["m"] = torch.full((batch, n_heads), M_INIT, dtype=f32, device=device)
    return st


def slstm_decode_step(p: Params, x: torch.Tensor,
                      st: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token, JAX's step.  x [B,1,D]; ``st`` (c, n, h, m) written in
    place and returned."""
    z_t, i_t, f_t, o_t = (v[:, 0] for v in _slstm_inputs(p, x))
    z_t = z_t + torch.einsum("bhe,ehf->bhf", st["h"], p["r_z"])
    logf = F.logsigmoid(f_t + p["f_bias"])
    m_new = torch.maximum(logf + st["m"], i_t)
    fs = torch.exp(logf + st["m"] - m_new)[..., None]
    is_ = torch.exp(i_t - m_new)[..., None]
    st["c"].copy_(fs * st["c"] + is_ * torch.tanh(z_t))
    st["n"].copy_(fs * st["n"] + is_)
    st["h"].copy_(torch.sigmoid(o_t) * st["c"]
                  / torch.clamp(st["n"], min=1.0))
    st["m"].copy_(m_new)
    return _slstm_out(p, st["h"][:, None], x.dtype), st
