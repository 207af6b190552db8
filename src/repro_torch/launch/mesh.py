"""Device meshes of the placement-scheduled multi-device executor (torch;
the counterpart of ``make_device_mesh`` in ``repro/launch/mesh.py``).

The port's mesh path is single-process, as the JAX one is: one Python
process drives every device of the mesh, and ``Engine.run`` returns one
tensor.  A mesh is therefore an ordered list of torch devices on one
axis, ``"dev"``; the halo exchange moves slabs between them with
``Tensor.to(device)`` (peer copies between distinct cards, no copy at
all on one device).

A device may appear more than once.  Each entry is then a *virtual
shard* of that device: its own destination blocks, its own shard order
and its own slabs, sharing the device's tile copies with the other
entries.  That is how a mesh is exercised on one card
(``DeviceMesh(["cuda:0"] * 4)``) or on the CPU (``DeviceMesh(["cpu"] *
4)``), the torch counterpart of JAX's
``--xla_force_host_platform_device_count``.

The LM's MoE blocks run on the same mesh (``DecoderLM(moe_impl="a2a",
mesh=...)``, ``models/moe.py``): its one axis plays the expert axis of
JAX's ``model`` axis, entry i owning experts [i E / D, (i + 1) E / D);
capacity buffers move between entries with ``Tensor.to`` and JAX's
``psum`` / ``pmean`` are sums in mesh order.  The LM's (data, model)
meshes (``make_production_mesh`` / ``make_local_mesh``) are not here:
sharded parameters and optimizer state belong to the distributed LM
stack (ROADMAP A15.11), which the port does not run yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _normalized(d) -> torch.device:
    """``d`` as a torch device with an explicit index on CUDA."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """An ordered 1-D mesh of torch devices on the axis ``"dev"``.

    ``devices`` keeps the given order (placement assigns destination
    blocks to positions in it) and may repeat a device; all entries are
    of one device type."""

    axis_names: Tuple[str, ...] = ("dev",)

    def __init__(self, devices: Sequence) -> None:
        devs = tuple(_normalized(d) for d in devices)
        if not devs:
            raise ValueError("a DeviceMesh needs at least one device")
        types = sorted({d.type for d in devs})
        if len(types) != 1:
            raise ValueError(f"a DeviceMesh holds one device type, got "
                             f"{types}")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)


def _available(device_type: str) -> Tuple[torch.device, ...]:
    if device_type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return tuple(torch.device("cuda", i) for i in range(n))
    if device_type == "cpu":
        return (torch.device("cpu"),)
    raise ValueError(f"unsupported device type {device_type!r}")


def make_device_mesh(n: Optional[int] = None,
                     device_type: str = "cuda") -> DeviceMesh:
    """The 1-D ``dev`` mesh over the first ``n`` distinct devices of
    ``device_type`` (every one when ``n`` is None).  Asking for more
    devices than there are raises ``ValueError``; a mesh of virtual
    shards on fewer devices is built explicitly with :class:`DeviceMesh`.
    The CPU counts as one device."""
    devs = _available(device_type)
    k = len(devs) if n is None else int(n)
    if k < 1 or k > len(devs):
        raise ValueError(
            f"make_device_mesh: asked for {k} {device_type} devices but "
            f"{len(devs)} are available")
    return DeviceMesh(devs[:k])
