"""GQA attention: full / sliding-window / cross, with query-chunked
online-softmax for long sequences, plus decode-step attention against a KV
cache (torch; a port of ``repro/models/attention.py``).

Shapes: x [B, T, D]; q [B, T, H, hd]; kv [B, S, Kh, hd].  GQA groups
G = H // Kh query heads per KV head: query head h reads KV head h // G.

Routes of :func:`attention`, chosen by what is computed, never by what
failed (nor by whether a gradient is wanted):

* with default positions (``positions`` None, i.e. ``arange(T)``), three
  calls go to the flash kernel through :class:`_FlashAttention`: causal
  self-attention (``kv_x`` None), with or without a sliding window;
  non-causal self-attention with no window (whisper's encoder); and
  cross-attention (``kv_x`` given, no window: keys at ``arange(S)``,
  nothing masked, Tq = T and Tk = S, as in JAX, where
  ``causal and kv_x is None`` is false).  Its forward is
  ``ops.flash_attention`` (on CPU tensors the plain version), which
  computes the same function as ``_sdpa`` with ``_mask_bias`` there; its
  backward recomputes the plain function under autograd one query chunk
  at a time (JAX has no backward kernel either: it differentiates the
  same function in XLA), and the gradient reaches ``kv_x`` through the
  K / V projections;
* explicit positions, and non-causal self-attention under a window, go
  to ``_sdpa``, or to ``_sdpa_chunked`` when T > ``chunk`` and ``chunk``
  divides T, as in JAX.

Operands of two dtypes (bf16 weights over an fp32 ``kv_x``) are promoted
as JAX's einsum promotes them: K / V are then fp32, and the kernel runs
on q, k and v in the promoted dtype, its output cast back to q's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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
    """einsum("btd,dhe->bthe", x, w), in the promoted dtype of the two."""
    d, h, e = w.shape
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.reshape(d, h * e).to(dt)).unflatten(
        -1, (h, e))


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


def _plain_grads(q, k, v, do, causal: bool, window: int, chunk: int):
    """Gradients of ``ref.flash_attention_plain(q, k, v, causal, window)``
    (v and ``do`` of their own width dv <= d) for the output gradient
    ``do``, recomputed one chunk of query rows at
    a time over the keys those rows can see: causal (self-attention,
    Tq == Tk), none after the chunk's last row and, under a window, none
    before its first row's window; non-causal, all Tk keys.  dk / dv sum
    over chunks in fp32, in chunk order."""
    t, tk = q.shape[1], k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, t, chunk):
        q1 = min(t, q0 + chunk)
        if causal:
            k0, k1 = (max(0, q0 - window + 1) if window > 0 else 0), q1
        else:
            k0, k1 = 0, tk
        with torch.enable_grad():
            qc = q[:, q0:q1].detach().requires_grad_()
            kc = k[:, k0:k1].detach().float().requires_grad_()
            vc = v[:, k0:k1].detach().float().requires_grad_()
            o = ref.flash_attention_plain(qc, kc, vc, causal, window,
                                          q_offset=q0 - k0)
            gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc),
                                             do[:, q0:q1])
        dq[:, q0:q1] = gq
        dk[:, k0:k1] += gk
        dv[:, k0:k1] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Attention on the kernel's layout (q [BH, Tq, d], k [BH / G, Tk, d],
    v [BH / G, Tk, dv]): causal self-attention, windowed when ``window`` >
    0, or with
    ``causal`` off every key visible (non-causal self- and
    cross-attention).  Forward: the flash kernel
    (``ops.flash_attention``).  Backward: the plain function recomputed
    under autograd (:func:`_plain_grads`), in the spirit of JAX's
    ``jax.checkpoint`` of the chunk body; a backward kernel is later
    work."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return ops.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _plain_grads(q, k, v, do.contiguous(), ctx.causal,
                                  ctx.window, BWD_CHUNK)
        return dq, dk, dv, None, None


def _flash(q, k, v, window: int = 0, causal: bool = True):
    """Attention through the flash kernel: heads to the kernel's
    [B*H, Tq, hd] layout (KV heads [B*Kh, Tk, hd], each at its own length;
    query head b*H + h reads KV head b*Kh + h // G, which is (b*H + h) //
    G, so the kernel indexes grouped heads itself), and back to [B, Tq,
    H, dv]; v may be narrower than q and k (dv <= hd: MLA's V).  q, k and
    v share one dtype."""
    b, t, h, _ = q.shape

    def heads(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], x.shape[1],
                                         x.shape[3]).contiguous()

    o = _FlashAttention.apply(heads(q), heads(k), heads(v), causal, window)
    return o.reshape(b, h, t, o.shape[-1]).transpose(1, 2)


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
    cross = kv_x is not None
    flash = positions is None and ((causal and not cross) or window == 0)
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    if use_rope and kv_x is None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    if flash:
        dt = torch.promote_types(q.dtype, k.dtype)
        o = _flash(q.to(dt), k.to(dt), v.to(dt), window,
                   causal=causal and not cross).to(q.dtype)
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
                     cache: Dict[str, torch.Tensor],
                     pos: Union[int, torch.Tensor], *,
                     window: int = 0, rope_theta: float = 1e4,
                     eps: float = 1e-6, cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x [B, 1, D]; cache k/v [B, S, Kh, hd]; pos: the
    current position, an int or a 0-d integer tensor on x's device (as
    JAX's jitted step takes it: the ring slot and the visibility mask are
    then computed on the device, and a captured step reads the position
    from the tensor; both give the same bits).  Returns (out [B,1,D],
    cache).  Unlike JAX, which returns a new cache, the self-attention
    cache is written in place (one slot per step) and returned."""
    on_device = isinstance(pos, torch.Tensor)
    if not on_device:
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
        if on_device:
            posv = pos.to(torch.int32).reshape(1, 1).expand(x.shape[0], 1)
        else:
            posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                              device=x.device)
        q = rope(q, posv, rope_theta)
        knew = rope(knew, posv, rope_theta)
        s_len = cache["k"].shape[1]
        # Ring buffer; full caches have s_len > pos.
        if on_device:
            slot = torch.remainder(pos, s_len).reshape(1).to(torch.int64)
            cache["k"].index_copy_(1, slot, knew.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slot, vnew.to(cache["v"].dtype))
        else:
            slot = pos % s_len
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
