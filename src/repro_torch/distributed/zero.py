"""ZeRO-1: shard optimizer state over the data axis (torch; a port of
``repro/distributed/zero.py``).

The spec rule is JAX's: the AdamW moments and the fp32 master copy get an
extra partitioning over ``data`` along the first dimension that (a)
divides evenly and (b) is not already sharded by the tensor-parallel
rule (or, where it is, combined with that axis when the product
divides).  In JAX that is all: XLA then emits the reduce-scattered
gradient and the all-gathered parameters.  The port has no partitioner,
so :func:`make_zero_train_step` runs the schedule itself in one process:
master, mu and nu live as blocks on their mesh entries
(``sharding.blocks``), each entry updates its blocks elementwise from its
slices of the full gradient, and the parameters are rebuilt from the
master blocks.  The result is bit for bit ``steps.make_train_step``'s.

The rule runs, as in JAX, on JAX's leaves: a stacked parameter's spec has
a leading entry for JAX's layer dimension, which the rule may split over
``data`` (hymba's 32 layers at 16 data rows), and a MoE block's experts
are taken in JAX's (d, E, f) order, then permuted to the port's.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.optim import AdamWState, cosine_schedule
from repro_torch.optim.adamw import adamw_moments, clipped_f32

from .sharding import (_jax_order, _port_order, blocks, gather,
                       layer_slots, param_specs)


def zero_param_spec(spec, shape, mesh, axis: str = "data"):
    if axis not in mesh.axis_names:
        return spec
    n = mesh.shape[axis]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, parts)):
        if cur is None and dim % n == 0 and dim >= n:
            parts[i] = axis
            return tuple(parts)
        if cur is not None and not isinstance(cur, tuple) and cur != axis:
            # combine with existing tensor-parallel axis when divisible
            ax_total = n * mesh.shape[cur]
            if dim % ax_total == 0:
                parts[i] = (cur, axis)
                return tuple(parts)
    return spec


def _zero_spec(name: str, shape, spec, mesh, slot) -> tuple:
    """JAX's zero spec of the port parameter's leaf: the rule runs on
    JAX's axis order and, for a stacked parameter, on JAX's stacked
    [rep, ...] leaf, whose layer dimension keeps a leading entry."""
    jshape, jspec = _jax_order(name, shape), _jax_order(name, spec)
    if slot is not None:
        jshape, jspec = (slot[1],) + jshape, (None,) + jspec
    z = tuple(zero_param_spec(jspec, jshape, mesh))
    k = 0 if slot is None else 1
    return z[:k] + _port_order(name, z[k:])


def opt_state_specs(model, mesh) -> AdamWState:
    """Specs for AdamWState(step, mu, nu, master) of ``model``'s
    parameters, by name.  A parameter JAX stacks (``layer_slots``) gets
    the spec of JAX's stacked leaf: a leading entry for the layer
    dimension (ZeRO may split it over ``data``), then its own dims."""
    named = dict(model.named_parameters())
    slots = layer_slots(model)
    zspec = {n: _zero_spec(n, tuple(named[n].shape), spec, mesh,
                           slots.get(n))
             for n, spec in param_specs(named, mesh).items()}
    return AdamWState(step=(), mu=zspec, nu=zspec, master=zspec)


# --------------------------------------------------------------------------- #
def _held(model, mesh):
    """Per parameter, per mesh entry, the slices of its state that entry
    holds (None: none) under the zero specs."""
    named = dict(model.named_parameters())
    specs = opt_state_specs(model, mesh).master
    slots = layer_slots(model)
    return {n: blocks(p.shape, specs[n], mesh, slots.get(n))
            for n, p in named.items()}


def zero_init(model, mesh) -> AdamWState:
    """A fresh ZeRO-1 AdamW state of ``model``'s parameters on ``mesh``:
    ``mu``, ``nu`` and ``master`` map each name to one entry per mesh
    entry: that entry's block on its device, or None where it holds none
    (``sharding.blocks`` under :func:`opt_state_specs`); the step count is
    a 0-d int32 CPU tensor, as unsharded.  Like
    ``steps.init_train_state`` it turns gradients on for every
    parameter."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    held = _held(model, mesh)

    def zeros(n):
        return [None if sl is None else torch.zeros(
            tuple(s.stop - s.start for s in sl) + tuple(
                named[n].shape[len(sl):]), dtype=torch.float32, device=dev)
            for sl, dev in zip(held[n], mesh.devices)]

    mu = {n: zeros(n) for n in named}
    nu = {n: zeros(n) for n in named}
    master = {n: [None if sl is None else p.detach()[sl].to(
        dev, dtype=torch.float32, copy=True)
        for sl, dev in zip(held[n], mesh.devices)]
        for n, p in named.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32), mu, nu, master)


def zero_gather(state: AdamWState, model, mesh) -> AdamWState:
    """The unsharded state of :func:`zero_init`'s layout: each of mu, nu
    and master rebuilt on its parameter's device."""
    named = dict(model.named_parameters())
    specs = opt_state_specs(model, mesh).master
    slots = layer_slots(model)

    def full(d):
        return {n: gather(d[n], specs[n], mesh, p.shape, p.device,
                          slots.get(n)) for n, p in named.items()}

    return AdamWState(state.step, full(state.mu), full(state.nu),
                      full(state.master))


def make_zero_train_step(model, cfg, mesh, base_lr: float = 3e-4):
    """(params, zero_state, batch) -> (params, zero_state, metrics): the
    train step of ``steps.make_train_step`` with its AdamW state sharded
    ZeRO-1 over ``mesh`` (:func:`zero_init`; ``params`` is ``model``).
    The gradient's global-norm clip is taken from the full gradients
    exactly as the unsharded update takes it (a norm of shard norms would
    sum in another order); then each entry updates the blocks of mu, nu
    and master it holds from its slices of the clipped fp32 gradients, on
    its device, and every parameter is rebuilt from the master blocks.
    Loss, parameters and state are bit for bit the unsharded step's."""
    from repro_torch.models.steps import value_and_grad

    held = _held(model, mesh)

    def train_step(params, state: AdamWState, batch):
        _, loss, aux, grads = value_and_grad(params, cfg, batch)
        lr = cosine_schedule(state.step, base_lr)
        named = dict(params.named_parameters())
        names = list(named)
        gf = dict(zip(names, clipped_f32([grads[n] for n in names])))
        del grads
        step = state.step + 1
        for i, dev in enumerate(mesh.devices):
            mine = [n for n in names if held[n][i] is not None]
            if mine:
                adamw_moments([gf[n][held[n][i]].to(dev) for n in mine],
                              [state.mu[n][i] for n in mine],
                              [state.nu[n][i] for n in mine],
                              [state.master[n][i] for n in mine], step, lr)
        del gf
        with torch.no_grad():
            for n, p in named.items():
                for sl, m in zip(held[n], state.master[n]):
                    if sl is not None:
                        p[sl] = m.to(p.device)
        return params, AdamWState(step, state.mu, state.nu,
                                  state.master), {"loss": loss, "aux": aux,
                                                  "lr": lr}

    return train_step


def shard_bytes(state: AdamWState) -> Dict[int, int]:
    """Bytes of mu, nu and master each mesh entry holds, by entry."""
    out: Dict[int, int] = {}
    for part in (state.mu, state.nu, state.master):
        for shards in part.values():
            for i, s in enumerate(shards):
                if s is not None:
                    out[i] = out.get(i, 0) + s.numel() * s.element_size()
    return out
