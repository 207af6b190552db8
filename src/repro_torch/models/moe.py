"""Mixture-of-Experts FFN (kimi-k2, deepseek-v3) (torch; a port of
``repro/models/moe.py``).

Three functions share one parameter layout:

* :func:`moe_dense` — the oracle: every expert on every token, combined
  with the router weights in fp32.  Serving and the train step use it by
  default, as JAX's ``DecoderLM(moe_impl="dense")`` does.
* :func:`moe_a2a` — expert parallelism with capacity buffers: each mesh
  entry dispatches its tokens into per-expert buffers of ``cap`` slots,
  the buffers go to the entries that own the experts and come back
  processed; an assignment past its expert's capacity is dropped (the
  token keeps its residual).  The prefill path of ``moe_impl="a2a"``.
* :func:`moe_local` — the decode path of ``moe_impl="a2a"``: every entry
  sees every token, computes only its own experts (the others' go to a
  spill expert that is dropped), and the entries' outputs are summed.

Layout.  JAX stores ``wi`` / ``wg`` as (d, E, f) and ``wo`` as (f, E, d);
the port stores them E-major, ``wi`` / ``wg`` [E, d, f] and ``wo`` [E, f,
d], so each expert's matrix is contiguous and every expert product is a
``torch.bmm`` over E that copies no weight (``convert`` permutes JAX's
leaves).  The router [d, E] is fp32 in every model, as in JAX.  The
expert activation is ``h * sigmoid(g)``, JAX's, and the shared expert is
``layers.swiglu``.

The mesh.  JAX runs ``moe_a2a`` / ``moe_local`` inside ``shard_map`` over
the ``model`` axis of its (pod, data, model) mesh.  Here the one axis of
a :class:`repro_torch.launch.mesh.DeviceMesh` plays that axis and there is
no batch axis: entry i owns experts [i E / D, (i + 1) E / D).  In
``moe_a2a`` the tokens are split by sequence over the D entries when D
divides T and T > 1 (JAX's ``use_seq``), else every entry holds all of
them.  The all-to-all moves each capacity buffer's rows to the entry that
owns them with ``Tensor.to`` (no copy between virtual entries of one
device), and JAX's ``psum`` / ``pmean`` are sums over the entries in
mesh order.  Expert weights live on the model's device; an entry on
another device takes its slices with ``Tensor.to`` at each call.

Slots and drops are JAX's: an assignment's slot is the count of earlier
(token, slot) assignments to its expert in row-major [N * k] order, and
capacity is ``max(4, ceil(int(n k cf) / E))`` in ``moe_a2a`` and
``max(1, ...)`` in ``moe_local``, with n the entry's own token count.
Nothing here syncs with the host or indexes by a mask, so a decode step
through any of the three can be captured as a CUDA graph.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, swiglu, swiglu_init

Params = Mapping[str, torch.Tensor]


def _experts(gen: Optional[torch.Generator], e: int, d_in: int, d_out: int,
             dtype: torch.dtype, device) -> torch.Tensor:
    """[e, d_in, d_out] of ``dense_init``'s scale, drawn one expert at a
    time (kimi-k2's 384 experts of 7168 x 2048 are 10.5 GiB in bf16: one
    fp32 draw of all of them would be twice that again)."""
    device = device if device is not None else gen.device
    w = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    if gen is not None:
        for i in range(e):
            w[i] = dense_init(gen, d_in, d_out, dtype, device=device)
    return w


def moe_init(gen: Optional[torch.Generator], d: int, f: int, n_experts: int,
             dtype: torch.dtype, n_shared: int = 0, device=None) -> dict:
    """JAX ``moe_init``'s names, E-major (module docstring); ``gen`` None
    (the meta device) draws nothing."""
    p = {
        "router": dense_init(gen, d, n_experts, torch.float32, std=0.02,
                             device=device),
        "wi": _experts(gen, n_experts, d, f, dtype, device),
        "wg": _experts(gen, n_experts, d, f, dtype, device),
        "wo": _experts(gen, n_experts, f, d, dtype, device),
    }
    if n_shared:
        p["shared"] = swiglu_init(gen, d, f * n_shared, dtype, device=device)
    return p


def _router(p: Params, x: torch.Tensor, top_k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N, d] -> (weights [N, k] fp32, ids [N, k], aux loss).  fp32
    softmax; the top k in descending order, the lower expert first on
    ties (``lax.top_k``'s order, through a stable sort); weights
    renormalized (sum clamped at 1e-9); Switch's aux loss ``E sum_e f_e
    p_e`` with f from each token's first choice."""
    logits = torch.matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = srt[:, :top_k], idx[:, :top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(ids[:, 0], e).float().mean(dim=0)
    return w, ids, e * torch.sum(me * ce)


def _expert_ffn(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
                wo: torch.Tensor) -> torch.Tensor:
    """x [e, c, d] through experts wi / wg [e, d, f], wo [e, f, d]:
    ``(x wi * sigmoid(x wg)) wo`` per expert, the sigmoid in fp32."""
    h = torch.bmm(x, wi)
    g = torch.bmm(x, wg)
    h = h * torch.sigmoid(g.float()).to(h.dtype)
    return torch.bmm(h, wo)


def _shared(p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y + swiglu(p["shared"], x) if "shared" in p else y


# --------------------------------------------------------------------------- #
def moe_dense(p: Params, x: torch.Tensor, top_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle: every expert on every token.  x [B, T, d] -> (y, aux).
    The experts' outputs [E, N, d] combine with the router weights in
    fp32, as JAX's do."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    w, ids, aux = _router(p, xf, top_k)
    e = p["router"].shape[-1]
    cw = torch.zeros((b * t, e), dtype=torch.float32,
                     device=x.device).scatter_add(1, ids, w)
    out = _expert_ffn(xf.unsqueeze(0).expand(e, -1, -1), p["wi"], p["wg"],
                      p["wo"])
    y = torch.einsum("end,ne->nd", out.float(), cw)
    return _shared(p, x, y.reshape(b, t, d).to(x.dtype)), aux


# --------------------------------------------------------------------------- #
def _dispatch_local(xf: torch.Tensor, ids: torch.Tensor, n_experts: int,
                    cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter tokens xf [N, d] into per-expert capacity buffers by their
    expert ids [N, k].  Returns (buf [E, cap, d], slot [N, k] in [-1,
    cap), keep [N, k]): each assignment's slot is the number of earlier
    assignments to its expert in row-major order; one at slot >= cap is
    dropped (slot -1)."""
    n, k = ids.shape
    d = xf.shape[-1]
    flat_e = ids.reshape(-1).long()
    # JAX counts with a cumsum over a one-hot [N k, E], a scan that costs
    # about a third of kimi-k2's prefill on the card; a stable sort by
    # expert gives the same counts: an assignment's rank among its
    # expert's, which keep row-major order.
    order = torch.sort(flat_e, stable=True).indices
    count = torch.zeros(n_experts, dtype=torch.long,
                        device=xf.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(count, dim=0) - count
    rank = torch.arange(n * k, device=xf.device) - first[flat_e[order]]
    slot = torch.empty_like(flat_e).scatter_(0, order, rank)
    keep = slot < cap
    slot = torch.where(keep, slot, torch.full_like(slot, -1))
    # A kept assignment has a row of its own; the dropped ones all write
    # one spare row past the buffers, which is cut off.
    rows = torch.where(keep, flat_e * cap + slot,
                       torch.full_like(flat_e, n_experts * cap))
    buf = torch.zeros((n_experts * cap + 1, d), dtype=xf.dtype,
                      device=xf.device).index_copy(
        0, rows, xf.repeat_interleave(k, dim=0))
    return buf[:-1].view(n_experts, cap, d), slot.view(n, k), keep.view(n, k)


def _combine(out: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
             slot: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Each token's kept assignments read back from the processed buffers
    out [E, cap, d] and weighted (in out's dtype), then summed over the k
    slots in fp32: y [N, d] fp32."""
    e, cap, d = out.shape
    n, k = ids.shape
    rows = ids.reshape(-1).long() * cap + slot.reshape(-1).clamp(min=0)
    got = out.reshape(e * cap, d).index_select(0, rows)
    got = got * keep.reshape(-1, 1).to(got.dtype)
    got = got * w.reshape(-1, 1).to(got.dtype)
    return got.float().view(n, k, d).sum(dim=1)


def _capacity(n: int, top_k: int, cap_factor: float, e: int,
              least: int) -> int:
    """``max(least, ceil(int(n k cf) / E))``: JAX truncates n k cf to an
    integer before the ceiling division."""
    return max(least, -(-int(n * top_k * cap_factor) // e))


def _experts_per_entry(p: Params, mesh) -> int:
    e = p["router"].shape[-1]
    if e % mesh.size:
        raise ValueError(f"{e} experts do not split over a mesh of "
                         f"{mesh.size} entries")
    return e // mesh.size


def _owned(p: Params, i: int, e_loc: int, dev) -> Tuple[torch.Tensor, ...]:
    """Entry i's slices of wi / wg / wo, on its device."""
    lo = i * e_loc
    return tuple(p[n][lo:lo + e_loc].to(dev) for n in ("wi", "wg", "wo"))


def moe_a2a(p: Params, x: torch.Tensor, top_k: int, cap_factor: float,
            mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh`` (module docstring): routing on
    every token at once (so the aux loss is global), dispatch from each
    entry's token shard, an all-to-all to the experts' owners and one
    back.  x [B, T, d] -> (y, aux)."""
    b, t, d = x.shape
    e = p["router"].shape[-1]
    n_dev = mesh.size
    e_loc = _experts_per_entry(p, mesh)
    w, ids, aux = _router(p, x.reshape(b * t, d), top_k)
    w, ids = w.view(b, t, top_k), ids.view(b, t, top_k)
    use_seq = t % n_dev == 0 and t > 1
    tl = t // n_dev if use_seq else t
    n = b * tl
    cap = _capacity(n, top_k, cap_factor, e, 4)

    def shard(a, j, dev):
        a = a[:, j * tl:(j + 1) * tl] if use_seq else a
        return a.to(dev).reshape(n, a.shape[-1])

    devs = mesh.devices
    sent = []
    for j, dev in enumerate(devs):
        buf, slot, keep = _dispatch_local(shard(x, j, dev),
                                          shard(ids, j, dev), e, cap)
        sent.append((buf.view(n_dev, e_loc, cap, d), slot, keep))
    # All-to-all: entry i takes, from every source j, the rows of its own
    # experts; [source, e_loc, cap, d] is processed as e_loc batches of
    # n_dev * cap rows, then split back by source.
    done = []
    for i, dev in enumerate(devs):
        recv = torch.stack([sent[j][0][i].to(dev) for j in range(n_dev)])
        xin = recv.transpose(0, 1).reshape(e_loc, n_dev * cap, d)
        out = _expert_ffn(xin, *_owned(p, i, e_loc, dev))
        done.append(out.view(e_loc, n_dev, cap, d).transpose(0, 1))
    ys = []
    for j, dev in enumerate(devs):
        out = torch.cat([done[i][j].to(dev) for i in range(n_dev)])
        _, slot, keep = sent[j]
        y = _combine(out, shard(ids, j, dev), shard(w, j, dev), slot, keep)
        ys.append(y.view(b, tl, d).to(x.dtype).to(x.device))
    if use_seq:
        y = torch.cat(ys, dim=1)
    else:
        # Every entry held every token and computed the same y: JAX's
        # pmean, in the output dtype.
        y = ys[0]
        for other in ys[1:]:
            y = y + other
        y = y / n_dev
    return _shared(p, x, y), aux


def moe_local(p: Params, x: torch.Tensor, top_k: int, cap_factor: float,
              mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-path expert parallelism without the all-to-all: each entry
    keeps the assignments to its own experts (the rest go to a spill
    expert, dropped with its buffer), computes them over all N tokens,
    and the entries' fp32 outputs are summed in mesh order (JAX's
    ``psum``).  x [B, T, d] -> (y, aux)."""
    b, t, d = x.shape
    e = p["router"].shape[-1]
    e_loc = _experts_per_entry(p, mesh)
    w, ids, aux = _router(p, x.reshape(b * t, d), top_k)
    n = b * t
    cap = _capacity(n, top_k, cap_factor, e, 1)
    y = None
    for col, dev in enumerate(mesh.devices):
        xf, wl, loc = (a.to(dev) for a in (x.reshape(n, d), w,
                                             ids - col * e_loc))
        mine = (loc >= 0) & (loc < e_loc)
        wl = torch.where(mine, wl, torch.zeros_like(wl))
        loc = torch.where(mine, loc, torch.zeros_like(loc))
        buf, slot, keep = _dispatch_local(
            xf, torch.where(mine, loc, torch.full_like(loc, e_loc)),
            e_loc + 1, cap)
        out = _expert_ffn(buf[:e_loc], *_owned(p, col, e_loc, dev))
        part = _combine(out, loc, wl, slot, keep & mine).to(x.device)
        y = part if y is None else y + part
    return _shared(p, x, y.view(b, t, d).to(x.dtype)), aux
