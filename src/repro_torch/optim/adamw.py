"""AdamW, built in-house (torch; a port of ``repro/optim/adamw.py``).

State: first and second moments in fp32 and, optionally, fp32 master
params (bf16 models keep them).  The arithmetic is JAX's, in its order:
the global-norm clip of the fp32 gradients, bias corrections ``c1 = 1 -
b1^t`` and ``c2 = 1 - b2^t`` in fp32, ``p - lr * (m / c1 / (sqrt(v / c2)
+ eps) + wd * p)`` on the fp32 master (decoupled decay), and the cast
back to each param's dtype.

Params, gradients and moments are mappings of names to tensors (the
port's state-dict names, ``dict(model.named_parameters())``).  Unlike
JAX, which returns new arrays, :func:`adamw_update` writes the params and
the state's tensors in place (``torch._foreach_*`` over the lists) and
returns them, which keeps one copy of each on the card.  The step count
lives on the host (a 0-d int32 CPU tensor), so the bias corrections and
the learning rate need no device round trip.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-d int32, on the CPU
    mu: Tensors
    nu: Tensors
    master: Optional[Tensors]        # fp32 copy of params (None: none kept)


def adamw_init(params: Mapping[str, torch.Tensor],
               keep_master: bool = True) -> AdamWState:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    mu = {n: f32(p) for n, p in params.items()}
    nu = {n: f32(p) for n, p in params.items()}
    master = None
    if keep_master:
        master = {n: p.detach().to(torch.float32, copy=True)
                  for n, p in params.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32), mu, nu, master)


@torch.no_grad()
def clipped_f32(grads, grad_clip: float = 1.0):
    """fp32 copies of ``grads`` (a list), scaled in place by the global-norm
    clip ``min(1, grad_clip / max(|g|, 1e-9))`` (none when ``grad_clip``
    <= 0).  The norm is the norm of the per-tensor norms, in list order."""
    gf = [g.to(torch.float32, copy=True) for g in grads]
    if grad_clip > 0:
        gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gf)))
        scale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
        torch._foreach_mul_(gf, scale)
    return gf


@torch.no_grad()
def adamw_moments(gf, mu, nu, ref, step: torch.Tensor, lr,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1) -> None:
    """The elementwise part of the update, in place over lists of equal
    shapes: the moments ``mu`` / ``nu`` from the clipped fp32 gradients
    ``gf``, then the fp32 params ``ref`` (the master copy), for the step
    count ``step`` (already advanced).  Every operation is elementwise,
    so a slice of each tensor gets the bits of the whole's update.  The
    list ``gf`` is emptied once read, which frees its tensors where
    nothing else holds them."""
    t = step.to(torch.float32)
    c1 = float(1.0 - b1 ** t)
    c2 = float(1.0 - b2 ** t)
    lr = float(lr)
    torch._foreach_mul_(mu, b1)                      # b1 m + (1 - b1) g
    torch._foreach_add_(mu, torch._foreach_mul(gf, 1 - b1))
    g2 = torch._foreach_mul(gf, 1 - b2)              # (1 - b2) g g
    torch._foreach_mul_(g2, gf)
    gf.clear()
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, g2)
    del g2
    den = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu, c1)
    torch._foreach_div_(upd, den)
    del den
    torch._foreach_add_(upd, torch._foreach_mul(ref, weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(ref, upd)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: AdamWState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (params, new state), both updated in place.  Global-norm
    clipping, decoupled weight decay, bias correction; fp32 math
    throughout.  ``lr`` is a float or a 0-d tensor on the CPU."""
    names = list(params)
    ps = [params[n] for n in names]
    gf = clipped_f32([grads[n] for n in names], grad_clip)
    step = state.step + 1
    if state.master is not None:
        ref = [state.master[n] for n in names]
    else:
        ref = [p.detach().to(torch.float32) for p in ps]
    adamw_moments(gf, [state.mu[n] for n in names],
                  [state.nu[n] for n in names], ref, step, lr, b1, b2, eps,
                  weight_decay)
    for p, r in zip(ps, ref):
        p.copy_(r)                                   # cast to p's dtype
    return params, AdamWState(step, state.mu, state.nu, state.master)
