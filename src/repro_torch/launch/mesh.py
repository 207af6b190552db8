"""Device meshes of the port (torch; the counterpart of
``repro/launch/mesh.py``).

The port's mesh path is single-process, as the JAX one is: one Python
process drives every device of the mesh, and ``Engine.run`` returns one
tensor.  A mesh is therefore an ordered list of torch devices laid out on
named axes, row-major (the last axis varies fastest, as in a JAX
``Mesh``'s device array); the halo exchange, the MoE all-to-all, ZeRO's
shards and the pipeline move tensors between entries with
``Tensor.to(device)`` (peer copies between distinct cards, no copy at all
on one device).

The GNN executor's mesh is 1-D on the axis ``"dev"`` (the default).  The
LM's meshes name JAX's axes: ``make_production_mesh`` is 16 x 16 on
(``data``, ``model``), or 2 x 16 x 16 on (``pod``, ``data``, ``model``),
and ``make_local_mesh`` a small (``data``, ``model``) one.
``distributed/sharding.py`` places parameters over them by JAX's rules;
``DecoderLM(moe_impl="a2a")`` runs its experts over the ``model`` axis
(:meth:`DeviceMesh.along`).

A device may appear more than once.  Each entry is then a *virtual
shard* of that device: its own destination blocks, its own shard order
and its own slabs (its own parameter shards), sharing the device's
memory with the other entries.  That is how a mesh is exercised on one
card (``DeviceMesh(["cuda:0"] * 4)``) or on the CPU (``DeviceMesh(["cpu"]
* 4)``), the torch counterpart of JAX's
``--xla_force_host_platform_device_count``.  A production mesh on the
``meta`` device is 256 or 512 meta entries: the dry-run's, which
allocates nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch


def _normalized(d) -> torch.device:
    """``d`` as a torch device with an explicit index on CUDA."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class DeviceMesh:
    """An ordered mesh of torch devices on named axes.

    ``devices`` keeps the given order, row-major over ``shape`` (entry i
    sits at :meth:`coords` (i)), and may repeat a device; all entries are
    of one device type.  ``shape`` None is the 1-D mesh ``(len(devices),)``
    on the axis ``"dev"``, which placement uses (destination blocks go to
    positions in it)."""

    def __init__(self, devices: Sequence,
                 shape: Optional[Sequence[int]] = None,
                 axis_names: Sequence[str] = ("dev",)) -> None:
        devs = tuple(_normalized(d) for d in devices)
        if not devs:
            raise ValueError("a DeviceMesh needs at least one device")
        types = sorted({d.type for d in devs})
        if len(types) != 1:
            raise ValueError(f"a DeviceMesh holds one device type, got "
                             f"{types}")
        sizes = (len(devs),) if shape is None else tuple(int(s)
                                                         for s in shape)
        names = tuple(axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a DeviceMesh needs one distinct name per "
                             f"axis, got shape {sizes} and names {names}")
        if math.prod(sizes) != len(devs) or min(sizes) < 1:
            raise ValueError(f"a mesh of shape {sizes} holds "
                             f"{math.prod(sizes)} entries, got {len(devs)}")
        self.devices = devs
        self.axis_sizes = sizes
        self.axis_names = names

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def coords(self, i: int) -> Dict[str, int]:
        """Entry i's position on each axis (row-major)."""
        out = {}
        for name, n in zip(reversed(self.axis_names),
                           reversed(self.axis_sizes)):
            i, out[name] = divmod(i, n)
        return {name: out[name] for name in self.axis_names}

    def index(self, coords: Dict[str, int]) -> int:
        """The entry at ``coords`` (every axis named)."""
        i = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            i = i * n + coords[name]
        return i

    def along(self, axis: str, **fixed: int) -> "DeviceMesh":
        """The 1-D mesh of the entries along ``axis`` with the other axes
        at ``fixed`` (0 where not given), named ``axis``: e.g. the
        ``model`` axis that ``moe_a2a`` runs its experts over."""
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        at = {name: fixed.get(name, 0) for name in self.axis_names}
        devs = []
        for j in range(self.shape[axis]):
            at[axis] = j
            devs.append(self.devices[self.index(at)])
        return DeviceMesh(devs, (len(devs),), (axis,))


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


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "meta") -> DeviceMesh:
    """JAX's production mesh: 16 x 16 = 256 entries on (``data``,
    ``model``), or 2 x 16 x 16 = 512 on (``pod``, ``data``, ``model``)
    with ``multi_pod``.  Every entry is ``device_type`` (the ``meta``
    device by default: the dry-run's, which allocates nothing)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return DeviceMesh([device_type] * math.prod(shape), shape, axes)


def make_local_mesh(n_data: int = 1, n_model: int = 1,
                    devices: Optional[Sequence] = None) -> DeviceMesh:
    """A small (``data``, ``model``) mesh of ``n_data * n_model`` entries:
    ``devices`` in row-major order (they may repeat a device), or, when
    None, the first that many distinct CUDA devices (``ValueError`` if
    there are fewer)."""
    n = n_data * n_model
    if devices is None:
        devices = make_device_mesh(n, "cuda").devices
    return DeviceMesh(devices, (n_data, n_model), ("data", "model"))
