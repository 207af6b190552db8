"""Plain torch versions of the hand kernels (the ``ref.py`` contract).

They mirror ``repro/kernels/ref.py`` (``gemm_ref``, ``spdmm_ref``,
``sddmm_ref``): the CPU tests run them, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card.  ``sddmm_step_ref`` is the ACK's
whole SDDMM step (mask and accumulator around ``sddmm_ref``), the
function the SDDMM kernel computes, as ``spdmm_step_ref`` (accumulator
around ``spdmm_ref``) is the SpDMM kernel's, and ``spdmm_steps_ref``
(those steps chained) its step list's; each step and
``flash_attention_plain`` round their fp32 result once to an
``out_dtype``, as the kernels store it; ``flash_attention_plain`` is the
flash kernel's function in its own [BH, T, d] layout (JAX's
``flash_attention_ref`` transposed).  ``gemm_ref`` and ``spdmm_ref``
widen bf16 operands to fp32 before the product, as JAX's do, so they are
also the plain versions of the bf16 kernels.  Matrix products here run in full
fp32 only where the caller has left
``torch.backends.cuda.matmul.allow_tf32`` False (the default, which
``chip_smoke.py`` sets explicitly).
"""
from __future__ import annotations

from typing import Optional

import torch


def gemm_ref(x: torch.Tensor, w: torch.Tensor,
             out_dtype=torch.float32) -> torch.Tensor:
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def spdmm_ref(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
              out_dtype=torch.float32,
              row_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r] = sum_k vals[r,k] * h[cols[r,k]].  Zero-padded entries
    (vals == 0) contribute nothing, so no mask is needed.  ``row_len``
    [n1] (optional) keeps only slots k < row_len[r] of row r, as the
    kernel walks them."""
    v = vals.float()
    if row_len is not None:
        k = torch.arange(cols.shape[1], device=cols.device)
        v = torch.where(k[None, :] < row_len.long()[:, None], v,
                        torch.zeros_like(v))
    gathered = h.float()[cols.long()]                   # [n1, w, f]
    out = torch.sum(gathered * v[..., None], dim=1)
    return out.to(out_dtype)


def spdmm_step_ref(cols: torch.Tensor, vals: torch.Tensor, h: torch.Tensor,
                   acc: Optional[torch.Tensor] = None,
                   row_len: Optional[torch.Tensor] = None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """``acc + spdmm_ref(cols, vals, h, row_len=row_len)`` in fp32 (the
    SpDMM kernel's function), rounded once to ``out_dtype``; ``acc`` None
    is a zero accumulator."""
    y = spdmm_ref(cols, vals, h, row_len=row_len)
    return (y if acc is None else acc + y).to(out_dtype)


def spdmm_steps_ref(steps, h: torch.Tensor, acc: Optional[torch.Tensor],
                    n_src: int, out_dtype=torch.float32) -> torch.Tensor:
    """The function of a list of SpDMM steps (``kernels.ops.spdmm_steps``):
    ``spdmm_step_ref`` of each step ``(cols, vals, row_len, row_off)`` on
    rows [row_off, row_off + n_src) of h, in list order, chained through
    the fp32 accumulator; rounded once to ``out_dtype`` at the end."""
    for cols, vals, row_len, off in steps:
        acc = spdmm_step_ref(cols, vals, h[off:off + n_src], acc, row_len)
    return acc.to(out_dtype)


def densify_ref(cols: torch.Tensor, vals: torch.Tensor,
                n_src: int) -> torch.Tensor:
    """The dense [n1, n_src] block of an ELL tile: ``vals[r, k]`` added at
    (r, ``cols[r, k]``) one slot index k at a time, so a column that a row
    holds twice sums in slot order (within one k no two rows collide);
    columns outside [0, n_src) are dropped (sent to a spare column), as
    JAX's scatter drops them."""
    n1, w = cols.shape
    out = torch.zeros((n1, n_src + 1), dtype=torch.float32,
                      device=cols.device)
    rows = torch.arange(n1, device=cols.device)
    c = cols.long()
    c = torch.where((c >= 0) & (c < n_src), c, torch.full_like(c, n_src))
    v = vals.float()
    for k in range(w):
        out[rows, c[:, k]] = out[rows, c[:, k]] + v[:, k]
    return out[:, :n_src].contiguous()


def sddmm_ref(h_dst: torch.Tensor, h_src: torch.Tensor, cols: torch.Tensor,
              out_dtype=torch.float32) -> torch.Tensor:
    """score[r,k] = <h_dst[r], h_src[cols[r,k]]> (pad entries score the
    gathered row 0 -- callers mask with edge validity)."""
    gathered = h_src.float()[cols.long()]               # [n1, w, f]
    out = torch.einsum("rwf,rf->rw", gathered, h_dst.float())
    return out.to(out_dtype)


def sddmm_step_ref(h_dst: torch.Tensor, h_src: torch.Tensor,
                   cols: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   acc: Optional[torch.Tensor] = None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """``acc + where(mask, sddmm_ref(h_dst, h_src, cols), 0)`` in fp32,
    rounded once to ``out_dtype``; ``mask`` None scores every slot,
    ``acc`` None is a zero accumulator."""
    s = sddmm_ref(h_dst, h_src, cols)
    if mask is not None:
        s = torch.where(mask, s, torch.zeros_like(s))
    return (s if acc is None else acc + s).to(out_dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          window: int = 0, *, q_offset: int = 0,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The flash kernel's function: q [BH, Tq, d], k [BH / G, Tk, d], v
    [BH / G, Tk, dv] -> [BH, Tq, dv] in ``out_dtype`` (None: q's dtype);
    query head ``bh`` reads KV head ``bh // G``.  Scores ``q k^T d^-1/2`` in fp32; under
    ``causal`` the Pallas kernel's index mask ``qpos >= kpos`` (both
    counted from 0) and, for ``window`` W > 0, JAX's ``_mask_bias`` window
    ``qpos - kpos < W`` score masked pairs -1e30 (W = 0 is no window).  ``q_offset`` counts
    query rows from that position (a chunk of rows; the kernel has 0)."""
    d = q.shape[-1]
    g = q.shape[0] // k.shape[0]
    if g > 1:
        k, v = (x.repeat_interleave(g, dim=0) for x in (k, v))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if causal or window > 0:
        tq, tk = q.shape[-2], k.shape[-2]
        dif = (torch.arange(q_offset, q_offset + tq,
                            device=q.device)[:, None]
               - torch.arange(tk, device=q.device)[None, :])
        ok = dif >= 0 if causal else torch.ones_like(dif, dtype=torch.bool)
        if window > 0:
            ok = ok & (dif < window)
        s = torch.where(ok, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(out_dtype or q.dtype)
