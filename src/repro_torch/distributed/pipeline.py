"""Pipeline parallelism (GPipe schedule) over a mesh axis (torch; a port
of ``repro/distributed/pipeline.py``).

JAX runs the schedule as one SPMD program under ``shard_map``: at tick t,
stage s holds microbatch t - s, and activations move to the next stage
with ``ppermute``; n_micro + n_stages - 1 ticks in all (the bubble is
n_stages - 1 of them).  Here one process drives every stage: the same
ticks, stage s running ``stage_fn`` on its own entry's device whenever it
holds a microbatch (JAX's stages also compute on the bubble's zeros,
results it drops), each output moved to the next stage's entry with
``Tensor.to``, and the last stage's outputs gathered on the caller's
device.  The result is bit for bit ``stage_fn`` applied stage by stage to
each microbatch in turn.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Sequence[Any], x: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``x`` [n_micro, micro_batch, ...] through ``mesh.shape[axis]``
    stages of ``stage_fn(stage_params[s], h)`` in a GPipe schedule; each
    ``stage_params[s]`` lives on stage s's device (the entries of
    ``mesh.along(axis)``).  Returns [n_micro, ...] on ``x``'s device."""
    devs = mesh.along(axis).devices
    n_stages, n_micro = len(devs), x.shape[0]
    if len(stage_params) != n_stages:
        raise ValueError(f"{len(stage_params)} stage parameters for "
                         f"{n_stages} stages")
    held = [None] * n_stages            # the activation each stage holds
    out = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue                # the bubble
            h = x[mb].to(devs[0]) if s == 0 else held[s]
            y = stage_fn(stage_params[s], h)
            if s == n_stages - 1:
                out[mb] = y.to(x.device)
            else:
                nxt[s + 1] = y.to(devs[s + 1])
        held = nxt
    return torch.stack(out)
