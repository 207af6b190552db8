"""Multi-head Latent Attention (deepseek-v3) (torch; a port of
``repro/models/mla.py``).

Prefill and train: queries from a low-rank projection (``q_lora``), K and V
expanded from the compressed latent ``c`` (``kv_lora``) plus one RoPE key
shared by every head (``qk_rope`` wide).  Decode: the absorbed form, whose
cache holds only ``c`` and ``k_rope`` per position; the per-head key
expansion is absorbed into the query (``q~ = q_nope W_uk^T``) and the
value expansion into the output, so a step never expands the history.

:func:`mla_attention` computes JAX's ``chunk_attn`` (scores ``q_nope .
k_nope + q_rope . k_rope`` scaled by ``(qk_nope + qk_rope) ** -0.5``,
causal ``qpos >= kpos``) as one attention of head dim ``dqk = qk_nope +
qk_rope``: Q is ``[q_nope | q_rope]``, K is ``[k_nope | k_rope]`` with
``k_rope`` broadcast over the heads, and V ``v_head_dim`` <= dqk wide.
The kernel's ``d ** -0.5`` is then JAX's scale.  With default positions
(``positions`` None) it goes through the flash kernel
(``attention._flash``, which takes V at its own width: deepseek-v3's dqk
= 192 and dv = 128); with explicit positions it is
``attention._sdpa_chunked``, query-chunked when ``chunk`` divides T as in
JAX, the plain route, on V zero-padded to dqk and the output sliced
back.  JAX's ``_constrain`` is a sharding hint that does
nothing on one device, so nothing stands for it here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import attention as A
from .config import ModelConfig
from .layers import Params, dense_init, rms_norm, rope


def mla_init(gen: Optional[torch.Generator], cfg: ModelConfig,
             dtype: torch.dtype, device=None) -> dict:
    d, h = cfg.d_model, cfg.n_heads

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)
    return {
        "w_dq": dense_init(gen, d, cfg.q_lora, dtype, device=device),
        "q_norm": zeros(cfg.q_lora),
        "w_uq": dense_init(gen, cfg.q_lora, (h, cfg.qk_nope + cfg.qk_rope),
                           dtype, device=device),
        "w_dkv": dense_init(gen, d, cfg.kv_lora + cfg.qk_rope, dtype,
                            device=device),
        "kv_norm": zeros(cfg.kv_lora),
        "w_uk": dense_init(gen, cfg.kv_lora, (h, cfg.qk_nope), dtype,
                           device=device),
        "w_uv": dense_init(gen, cfg.kv_lora, (h, cfg.v_head_dim), dtype,
                           device=device),
        "wo": dense_init(gen, h * cfg.v_head_dim, d, dtype, device=device),
    }


def _project_q(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = rms_norm(torch.matmul(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = A._proj(q, p["w_uq"])
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _latent_kv(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    ckv = torch.matmul(x, p["w_dkv"])
    c, k_rope = ckv[..., :cfg.kv_lora], ckv[..., cfg.kv_lora:]
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c, k_rope


def mla_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: Optional[torch.Tensor] = None,
                  chunk: int = 0) -> torch.Tensor:
    """Causal MLA over a full sequence, x [B, T, D] -> [B, T, D]; the route
    follows ``positions`` (module docstring)."""
    b, t, _ = x.shape
    h, dv = cfg.n_heads, cfg.v_head_dim
    dqk = cfg.qk_nope + cfg.qk_rope
    if dv > dqk:
        raise ValueError(f"mla_attention pads V ({dv} wide) to the query / "
                         f"key head dim ({dqk}); it cannot be wider")
    flash = positions is None
    if flash:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c, k_rope = _latent_kv(p, cfg, x, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([A._proj(c, p["w_uk"]),
                   k_rope[:, :, None, :].expand(b, t, h, cfg.qk_rope)],
                  dim=-1)
    v = A._proj(c, p["w_uv"])
    if flash:
        o = A._flash(q, k, v)
    else:
        step = chunk if chunk and t > chunk and t % chunk == 0 else t
        o = A._sdpa_chunked(q, k, F.pad(v, (0, dqk - dv)), positions,
                            positions, True, 0, dqk ** -0.5, step)[..., :dv]
    return A._out_proj(o.to(x.dtype), p["wo"])


def mla_cache_init(batch: int, max_len: int, cfg: ModelConfig,
                   dtype: torch.dtype, device=None
                   ) -> Dict[str, torch.Tensor]:
    return {
        "c": torch.zeros(batch, max_len, cfg.kv_lora, dtype=dtype,
                         device=device),
        "k_rope": torch.zeros(batch, max_len, cfg.qk_rope, dtype=dtype,
                              device=device),
    }


def mla_decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    cache: Dict[str, torch.Tensor],
                    pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed decode.  x [B, 1, D]; cache ``c`` [B, S, kv_lora] and
    ``k_rope`` [B, S, qk_rope], written in place at ``pos`` (an int, or a
    0-d integer tensor on x's device, as ``attention.decode_attention``
    takes it).  Scores, softmax and the latent output in fp32, as in JAX.
    Returns (out [B, 1, D], cache)."""
    b = x.shape[0]
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        posv = pos.to(torch.int32).reshape(1, 1).expand(b, 1)
    else:
        pos = int(pos)
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(p, cfg, x, posv)
    c_new, kr_new = _latent_kv(p, cfg, x, posv)
    cc, kr = cache["c"], cache["k_rope"]
    if on_device:
        slot = pos.reshape(1).to(torch.int64)
        cc.index_copy_(1, slot, c_new.to(cc.dtype))
        kr.index_copy_(1, slot, kr_new.to(kr.dtype))
    else:
        cc[:, pos] = c_new[:, 0].to(cc.dtype)
        kr[:, pos] = kr_new[:, 0].to(kr.dtype)
    q_abs = torch.einsum("bthe,rhe->bthr", q_nope, p["w_uk"])
    ccf = cc.float()
    s = torch.einsum("bthr,bsr->bhts", q_abs.float(), ccf)
    s = s + torch.einsum("bthe,bse->bhts", q_rope.float(), kr.float())
    s = s * (cfg.qk_nope + cfg.qk_rope) ** -0.5
    valid = torch.arange(cc.shape[1], device=x.device) <= pos
    s = torch.where(valid, s, torch.full_like(s, A.NEG))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhts,bsr->bthr", pr, ccf)
    o = torch.einsum("bthr,rhe->bthe", o_lat, p["w_uv"].float())
    return A._out_proj(o.to(x.dtype), p["wo"]), cache
