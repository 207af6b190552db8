"""GQA attention: full / sliding-window / cross, with query-chunked
online-softmax for long sequences, plus decode-step attention against a KV
cache (torch; a port of ``repro/models/attention.py``).

Shapes: x [B, T, D]; q [B, T, H, hd]; kv [B, S, Kh, hd].  GQA groups
G = H // Kh query heads per KV head: query head h reads KV head h // G.

Routes of :func:`attention`, chosen by what is computed, never by what
failed (nor by whether a gradient is wanted):

* causal self-attention (``kv_x`` None) with default positions
  (``positions`` None, i.e. ``arange(T)``), with or without a sliding
  window, goes to the flash kernel through :class:`_FlashAttention`: its
  forward is ``ops.flash_attention`` (on CPU tensors the plain version),
  which computes the same function as ``_sdpa`` with ``_mask_bias``
  there; its backward recomputes the plain function under autograd one
  query chunk at a time (JAX has no backward kernel either: it
  differentiates the same function in XLA);
* explicit positions, non-causal and cross-attention go to ``_sdpa``, or
  to ``_sdpa_chunked`` when T > ``chunk`` and ``chunk`` divides T, as in
  JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops, ref

from .layers import Params, dense_init, rms_norm, rope

NEG = -2.0e38


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
              hd: int, dtype: torch.dtype, qk_norm: bool = False,
              kv_input_dim: Optional[int] = None, device=None) -> dict:
    kvd = kv_input_dim or d_model
    p = {
        "wq": dense_init(gen, d_model, (n_heads, hd), dtype, device=device),
        "wk": dense_init(gen, kvd, (n_kv, hd), dtype, device=device),
        "wv": dense_init(gen, kvd, (n_kv, hd), dtype, device=device),
        "wo": dense_init(gen, n_heads * hd, d_model, dtype,
                         std=(n_heads * hd) ** -0.5, device=device),
    }
    if qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dtype, device=device)
        p["k_norm"] = torch.zeros(hd, dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhe->bthe", x, w)."""
    d, h, e = w.shape
    return torch.matmul(x, w.reshape(d, h * e)).unflatten(-1, (h, e))


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bthe,hed->btd", o, wo.reshape(h, e, -1))."""
    return torch.matmul(o.flatten(-2), wo)


def _qk_normalize(p: Params, q, k, eps):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    return q, k


def _mask_bias(qpos, kpos, causal: bool, window: int) -> torch.Tensor:
    """[Tq, Tk] additive bias from causal/sliding-window visibility."""
    dif = qpos[:, None] - kpos[None, :]
    ok = torch.ones(dif.shape, dtype=torch.bool, device=dif.device)
    if causal:
        ok &= dif >= 0
    if window > 0:
        ok &= dif < window
    zero = torch.zeros((), dtype=torch.float32, device=dif.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG))


def _sdpa(q, k, v, bias, scale):
    """q [B,Tq,H,hd], k/v [B,Tk,Kh,hd] -> [B,Tq,H,hd] (f32 softmax)."""
    b, tq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, tq, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    s = s + bias
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, tq, h, hd).to(q.dtype)


def _sdpa_chunked(q, k, v, qpos, kpos, causal, window, scale, chunk: int):
    """Query-chunked online-softmax attention (bounded memory; exact).  As
    in JAX, the probabilities are cast to the value dtype for the P.V
    product (fp32 accumulation) and the normalizer divides the output."""
    b, t, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    n_chunks = t // chunk
    qg = q.reshape(b, n_chunks, chunk, kh, g, hd)
    qpos_c = qpos.reshape(n_chunks, chunk)
    kf, vf = k.float(), v.float()
    outs = []
    for c in range(n_chunks):
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, c].float(), kf) * scale
        s = s + _mask_bias(qpos_c[c], kpos, causal, window)
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskd->bkgqd", e.to(v.dtype).float(), vf)
        outs.append(o / torch.clamp(den, min=1e-30))   # [b,kh,g,chunk,hd]
    o = torch.stack(outs)
    # [n_chunks, b, kh, g, chunk, hd] -> [b, t, h, hd]
    o = o.permute(1, 0, 4, 2, 3, 5).reshape(b, t, h, hd)
    return o.to(q.dtype)


# Query rows per chunk of the backward's recompute: its fp32 scores are
# [BH, BWD_CHUNK, <= T] at a time, not [BH, T, T].
BWD_CHUNK = 1024


def _plain_grads(q, k, v, do, window: int, chunk: int):
    """Gradients of ``ref.flash_attention_plain(q, k, v, True, window)``
    (self-attention, Tq == Tk) for the output gradient ``do``, recomputed
    one chunk of query rows at a time over the keys those rows can see
    (none after the chunk's last row; under a window none before its
    first row's window).  dk / dv sum over chunks in fp32."""
    t = q.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, t, chunk):
        q1 = min(t, q0 + chunk)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        with torch.enable_grad():
            qc = q[:, q0:q1].detach().requires_grad_()
            kc = k[:, k0:q1].detach().float().requires_grad_()
            vc = v[:, k0:q1].detach().float().requires_grad_()
            o = ref.flash_attention_plain(qc, kc, vc, True, window,
                                          q_offset=q0 - k0)
            gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc),
                                             do[:, q0:q1])
        dq[:, q0:q1] = gq
        dk[:, k0:q1] += gk
        dv[:, k0:q1] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Causal self-attention, windowed when ``window`` > 0, on the
    kernel's layout (q [BH, T, d], k / v [BH / G, T, d]).  Forward: the
    flash kernel (``ops.flash_attention``).  Backward: the plain function
    recomputed under autograd (:func:`_plain_grads`), in the spirit of
    JAX's ``jax.checkpoint`` of the chunk body; a backward kernel is later
    work."""

    @staticmethod
    def forward(ctx, q, k, v, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return ops.flash_attention(q, k, v, causal=True, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _plain_grads(q, k, v, do.contiguous(), ctx.window,
                                  BWD_CHUNK)
        return dq, dk, dv, None


def _flash(q, k, v, window: int = 0):
    """Causal self-attention through the flash kernel: heads to the
    kernel's [B*H, T, hd] layout (KV heads [B*Kh, T, hd]; query head
    b*H + h reads KV head b*Kh + h // G, which is (b*H + h) // G, so the
    kernel indexes grouped heads itself), and back to [B, T, H, hd]."""
    b, t, h, hd = q.shape
    kh = k.shape[2]

    def heads(x, n):
        return x.transpose(1, 2).reshape(b * n, t, hd).contiguous()

    o = _FlashAttention.apply(heads(q, h), heads(k, kh), heads(v, kh),
                              window)
    return o.reshape(b, h, t, hd).transpose(1, 2)


# --------------------------------------------------------------------------- #
def attention(p: Params, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None, *,
              causal: bool = True, window: int = 0,
              rope_theta: float = 1e4, eps: float = 1e-6,
              chunk: int = 0, kv_x: Optional[torch.Tensor] = None,
              use_rope: bool = True) -> torch.Tensor:
    """Self (or cross, via kv_x) attention over a full sequence.
    ``positions`` None means ``arange(T)``; see the module docstring for
    which route each call takes."""
    q = _proj(x, p["wq"])
    src = x if kv_x is None else kv_x
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    q, k = _qk_normalize(p, q, k, eps)
    hd = q.shape[-1]
    t = x.shape[1]
    flash = kv_x is None and causal and positions is None
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    if use_rope and kv_x is None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if flash:
        o = _flash(q, k, v, window)
    else:
        kpos = (positions if kv_x is None
                else torch.arange(src.shape[1], dtype=torch.int32,
                                  device=x.device))
        scale = hd ** -0.5
        if chunk and t > chunk and t % chunk == 0:
            o = _sdpa_chunked(q, k, v, positions, kpos,
                              causal and kv_x is None, window, scale, chunk)
        else:
            bias = _mask_bias(positions, kpos, causal and kv_x is None,
                              window)
            o = _sdpa(q, k, v, bias, scale)
    return _out_proj(o, p["wo"])


# --------------------------------------------------------------------------- #
# KV-cache decode path.
# --------------------------------------------------------------------------- #
def init_cache(batch: int, max_len: int, n_kv: int, hd: int,
               dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros(batch, max_len, n_kv, hd, dtype=dtype,
                         device=device),
        "v": torch.zeros(batch, max_len, n_kv, hd, dtype=dtype,
                         device=device),
    }


def decode_attention(p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: int, *,
                     window: int = 0, rope_theta: float = 1e4,
                     eps: float = 1e-6, cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x [B, 1, D]; cache k/v [B, S, Kh, hd]; pos: the
    current position (int).  Returns (out [B,1,D], cache).  Unlike JAX,
    which returns a new cache, the self-attention cache is written in
    place (one slot per step) and returned."""
    pos = int(pos)
    q = _proj(x, p["wq"])
    hd = q.shape[-1]
    if cross:
        # Cross-attention cache holds the projected encoder K/V (static).
        k, v = cache["k"], cache["v"]
        valid = torch.ones(k.shape[1], dtype=torch.bool, device=x.device)
    else:
        knew = _proj(x, p["wk"])
        vnew = _proj(x, p["wv"])
        q, knew = _qk_normalize(p, q, knew, eps)
        posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                          device=x.device)
        q = rope(q, posv, rope_theta)
        knew = rope(knew, posv, rope_theta)
        s_len = cache["k"].shape[1]
        slot = pos % s_len   # ring buffer; full caches have s_len > pos
        cache["k"][:, slot] = knew[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = vnew[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        # Ring-buffer slot -> absolute position (wraps for window caches);
        # unwritten slots map to negative positions (invalid).  Python's
        # sign of % (torch.remainder), not C's (torch.fmod).
        slots = torch.arange(s_len, dtype=torch.int64, device=x.device)
        abs_pos = pos - torch.remainder(pos - slots, s_len)
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        if window > 0:
            valid &= abs_pos > pos - window
    b, _, h, _ = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, 1, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                     k.float()) * (hd ** -0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pr, v.float())
    o = o.reshape(b, 1, h, hd).to(x.dtype)
    return _out_proj(o, p["wo"]), cache
