"""Parameter / activation sharding rules for the (pod, data, model) mesh,
and their placement over a :class:`repro_torch.launch.mesh.DeviceMesh`
(torch; a port of ``repro/distributed/sharding.py``).

MaxText-style logical rules, resolved by parameter *name*: tensor-parallel
dimensions (vocab, heads, ffn, experts) map to the ``model`` axis; batch
maps to ``(pod, data)``; everything small is replicated.  ZeRO-1 adds a
``data`` partition to the optimizer state (``distributed/zero.py``).

The port has no ``PartitionSpec``: a spec is a tuple with one entry per
dimension of the tensor it places, each ``None`` (replicated), an axis
name or a tuple of axis names (the dimension split over their product,
the first axis major), as JAX's ``PartitionSpec`` entries are.

The rules are JAX's, so a port parameter's spec is by definition JAX's
spec of the same leaf (``convert._lm_leaves`` pairs them) with two
changes: JAX stacks a segment's layers on a leading dimension, which its
rule pads with ``None`` and the port does not have, so that entry is
dropped; and the leaves the port stores with permuted axes
(``convert.PERMUTED``: a MoE block's experts, E-major here) have their
entries permuted alike.  A MoE ``wi`` of JAX's (d, E, f) under (None,
model, None) is the port's [E, d, f] under (model, None, None).
Divisibility is checked on the port's shape.

Placement (:func:`shard` / :func:`gather`) is what the rules become in a
single process: one tensor per mesh entry, on that entry's device,
holding the entry's block; :func:`local_shape` is that block's shape.
ZeRO-1's specs may split JAX's stacked layer dimension over ``data``
(hymba's 32 layers on 16 data rows: two layers' state a row); a
per-layer tensor under such a spec (its ``slot``, :func:`layer_slots`)
is then held whole by the entries whose block of that dimension holds
its layer, and by no other.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.convert import _axes

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

Spec = Tuple  # one entry per dim: None, an axis name or a tuple of names

# rule: parameter leaf name -> base spec (without stacked dims)
_NAME_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": (MODEL_AXIS, None),
    "head": (None, MODEL_AXIS),
    # attention
    "wq": (None, MODEL_AXIS, None),
    "wk": (None, MODEL_AXIS, None),
    "wv": (None, MODEL_AXIS, None),
    "wo": (MODEL_AXIS, None),
    # mlp
    "wi": (None, MODEL_AXIS),
    "wg": (None, MODEL_AXIS),
    # moe (3D: d, E, f / f, E, d) — expert parallelism over model axis
    "moe_wi": (None, MODEL_AXIS, None),
    "moe_wg": (None, MODEL_AXIS, None),
    "moe_wo": (None, MODEL_AXIS, None),
    "router": (None, None),
    # mla
    "w_dq": (None, None),
    "w_uq": (None, MODEL_AXIS, None),
    "w_dkv": (None, None),
    "w_uk": (None, MODEL_AXIS, None),
    "w_uv": (None, MODEL_AXIS, None),
    # ssm / xlstm
    "w_in": (None, MODEL_AXIS, None),
    "w_out": (MODEL_AXIS, None),
    "w_up": (None, MODEL_AXIS),
    "w_down": (MODEL_AXIS, None),
    "w_q": (None, MODEL_AXIS, None),
    "w_k": (None, MODEL_AXIS, None),
    "w_v": (None, MODEL_AXIS, None),
    "w_z": (None, MODEL_AXIS, None),
    "w_o": (None, MODEL_AXIS, None),
}


def _axis_tuple(entry) -> Tuple[str, ...]:
    """A spec entry's axis names (none for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _stacked(name: str) -> bool:
    """Whether JAX stacks the leaf on a leading layer dimension: the
    port's ``layers.{i}.`` / ``encoder.blocks.{i}.`` parameters, the ones
    ``convert._lm_leaves`` reads at an index of that dimension."""
    return any(part.isdigit() for part in name.split("."))


def _divisible(spec: Sequence, shape: Tuple[int, ...], mesh) -> Spec:
    """``spec`` with every entry whose axes are not all on ``mesh``, or
    whose dimension they do not divide, replicated."""
    out = list(spec)
    for i, entry in enumerate(out):
        axes = _axis_tuple(entry)
        if axes and (any(a not in mesh.axis_names for a in axes)
                     or shape[i] % math.prod(mesh.shape[a]
                                             for a in axes) != 0):
            out[i] = None   # replicate non-divisible dims
    return tuple(out)


def param_spec(name: str, shape: Tuple[int, ...], mesh=None) -> Spec:
    """The spec of the port parameter ``name`` of ``shape`` (module
    docstring); with a mesh, non-divisible dims fall back to
    replication."""
    path = name.split(".")
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    key = f"moe_{leaf}" if parent == "moe" and leaf in ("wi", "wg",
                                                         "wo") else leaf
    base = _NAME_RULES.get(key)
    stacked = int(_stacked(name))
    ndim = len(shape)
    jax_ndim = ndim + stacked
    if base is None or len(base) > jax_ndim:
        return (None,) * ndim
    spec = ((None,) * (jax_ndim - len(base)) + tuple(base))[stacked:]
    axes = _axes(name)
    if axes is not None:
        spec = tuple(spec[i] for i in axes)
    return spec if mesh is None else _divisible(spec, shape, mesh)


def param_specs(model, mesh=None) -> Dict[str, Spec]:
    """Spec of every parameter of ``model`` (a port module, or a mapping
    of names to tensors), by name; with a mesh, non-divisible dims fall
    back to replication."""
    named = (model.items() if isinstance(model, dict)
             else model.named_parameters())
    return {n: param_spec(n, tuple(p.shape), mesh) for n, p in named}


# --------------------------------------------------------------------------- #
def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def _batch_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in mesh_batch_axes(mesh))


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    """Spec for [B, ...] arrays: shard batch over (pod, data) if it
    divides, else replicate."""
    ba = mesh_batch_axes(mesh)
    ok = batch % _batch_size(mesh) == 0
    return (ba if ok else None,) + (None,) * extra_dims


def kv_cache_spec(batch: int, mesh, n_kv: int, seq_len: int = 0) -> Spec:
    """[B, S, Kh, hd] caches: batch over (pod, data) when divisible, else
    sequence; heads over model when divisible — otherwise shard the
    SEQUENCE over model (flash-decode style: attention reduces partial
    softmax stats over the model axis).  Without this, GQA models whose
    kv heads don't divide the model axis (kimi/granite kv=8 vs 16) carry
    fully replicated caches."""
    ba = mesh_batch_axes(mesh)
    msz = mesh.shape[MODEL_AXIS]
    heads_divide = n_kv % msz == 0
    seq_divides = seq_len > 0 and seq_len % msz == 0
    if batch % _batch_size(mesh) == 0:
        if heads_divide:
            return (ba, None, MODEL_AXIS, None)
        if seq_divides:
            return (ba, MODEL_AXIS, None, None)
        return (ba, None, None, None)
    if heads_divide:
        return (None, ba, MODEL_AXIS, None)
    if seq_divides:
        return (None, (MODEL_AXIS,) + ba, None, None)
    return (None, ba, None, None)


def latent_cache_spec(batch: int, mesh) -> Spec:
    """[B, S, R] MLA latent caches (no head dim)."""
    ba = mesh_batch_axes(mesh)
    if batch % _batch_size(mesh) == 0:
        return (ba, None, None)
    return (None, ba, None)


def state_cache_spec(shape: Tuple[int, ...], mesh) -> Spec:
    """SSM/xLSTM state leaves [B, H, ...]: batch over (pod,data) when
    divisible, heads over model when divisible."""
    ba = mesh_batch_axes(mesh)
    parts = [None] * len(shape)
    if shape and shape[0] % _batch_size(mesh) == 0:
        parts[0] = ba
    if len(shape) > 1 and shape[1] % mesh.shape[MODEL_AXIS] == 0:
        parts[1] = MODEL_AXIS
    return tuple(parts)


def cache_spec(name: str, shape: Tuple[int, ...], batch: int,
               mesh) -> Spec:
    """The spec of a decode cache tensor of one layer (JAX's dry-run
    rule, ``_cache_shardings``, on the unstacked shape): K / V caches by
    :func:`kv_cache_spec`, MLA's latent ``c`` / ``k_rope`` [B, S, R] (S at
    least 4,096, which tells them from the sLSTM's [B, H, dh] ``c``) by
    :func:`latent_cache_spec`, every other state by
    :func:`state_cache_spec`."""
    if name in ("k", "v", "xk", "xv"):
        return kv_cache_spec(batch, mesh, shape[2], seq_len=shape[1])
    if name in ("c", "k_rope") and len(shape) == 3 and shape[1] >= 4096:
        return latent_cache_spec(batch, mesh)
    return state_cache_spec(shape, mesh)


# --------------------------------------------------------------------------- #
# JAX's stacked layer dimension.
# --------------------------------------------------------------------------- #
def layer_slots(model) -> Dict[str, Tuple[int, int]]:
    """``(r, rep)`` of every parameter JAX stacks: JAX keeps the rep
    repeats of one block position of a segment in one leaf [rep, ...], and
    this parameter is its slice r (``convert._lm_leaves``'s index).  An
    encoder-decoder's encoder blocks are one stack of
    ``n_encoder_layers``."""
    from repro_torch.models.transformer import build_segments
    slots: Dict[str, Tuple[int, int]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        k = next((j for j, q in enumerate(parts) if q.isdigit()), None)
        if k is None:
            continue
        i, owner = int(parts[k]), ".".join(parts[:k - 1])
        if parts[k - 1] == "blocks":             # whisper's encoder
            slots[name] = (i, len(model.get_submodule(f"{owner}.blocks"
                                                      if owner else
                                                      "blocks")))
            continue
        cfg = (model.get_submodule(owner) if owner else model).cfg
        lo = 0
        for sb, rep in build_segments(cfg):
            if i < lo + rep * len(sb):
                slots[name] = ((i - lo) // len(sb), rep)
                break
            lo += rep * len(sb)
    return slots


def _jax_order(name: str, seq: Sequence) -> tuple:
    """A port parameter's per-dimension entries in JAX's axis order."""
    axes = _axes(name)
    if axes is None:
        return tuple(seq)
    out = [None] * len(seq)
    for i, j in enumerate(axes):
        out[j] = seq[i]
    return tuple(out)


def _port_order(name: str, seq: Sequence) -> tuple:
    axes = _axes(name)
    return tuple(seq) if axes is None else tuple(seq[j] for j in axes)


# --------------------------------------------------------------------------- #
# Placement over a DeviceMesh.
# --------------------------------------------------------------------------- #
def _parts(spec: Sequence, mesh) -> Tuple[int, ...]:
    """How many blocks each dimension is split into."""
    return tuple(math.prod(mesh.shape[a] for a in _axis_tuple(e))
                 for e in spec)


def local_shape(shape: Sequence[int], spec: Sequence, mesh
                ) -> Tuple[int, ...]:
    """The shape of one entry's block of a ``shape`` tensor under
    ``spec`` (the dims ``spec`` names must be divisible, as
    :func:`param_spec` with a mesh makes them)."""
    out = []
    for dim, n in zip(shape, _parts(spec, mesh)):
        if dim % n:
            raise ValueError(f"dimension {dim} does not split into {n} "
                             f"blocks (spec {tuple(spec)})")
        out.append(dim // n)
    return tuple(out) + tuple(shape[len(spec):])


def _block(spec: Sequence, mesh, i: int) -> Tuple[int, ...]:
    """Entry i's block index along each dimension: over a tuple of axes,
    mixed-radix with the first axis major (JAX's device order)."""
    at = mesh.coords(i)
    out = []
    for e in spec:
        j = 0
        for a in _axis_tuple(e):
            j = j * mesh.shape[a] + at[a]
        out.append(j)
    return tuple(out)


def blocks(shape: Sequence[int], spec: Sequence, mesh, slot=None) -> list:
    """Entry by entry (mesh order), the slices of its block of a ``shape``
    tensor under ``spec``, or None for an entry that holds none of it.
    With ``slot`` = (r, rep) (:func:`layer_slots`) the tensor is slice r
    of JAX's stacked [rep, *shape] leaf and ``spec`` places that stacked
    shape: an entry holds the tensor only if its block along the layer
    dimension contains r."""
    lead = ()
    if slot is not None:
        r, rep = slot
        lead, spec = spec[:1], spec[1:]
        per = rep // _parts(lead, mesh)[0]
    loc = local_shape(shape, spec, mesh)
    out = []
    for i in range(mesh.size):
        at = _block(tuple(lead) + tuple(spec), mesh, i)
        if lead and at[0] != r // per:
            out.append(None)
            continue
        out.append(tuple(slice(j * n, (j + 1) * n)
                         for j, n in zip(at[len(lead):], loc)))
    return out


def held_nbytes(shape: Sequence[int], dtype: torch.dtype, spec: Sequence,
                mesh, slot=None) -> int:
    """Bytes of mesh entry 0's block (0 if it holds none; every entry
    holds as many over all the layers of a stack)."""
    if slot is not None:
        if slot[0] >= slot[1] // _parts(spec[:1], mesh)[0]:
            return 0                    # entry 0's layer block is the first
        spec = spec[1:]
    return math.prod(local_shape(shape, spec, mesh)) * torch.empty(
        (), dtype=dtype).element_size()


def shard(t: torch.Tensor, spec: Sequence, mesh, slot=None) -> list:
    """One entry per mesh entry, in mesh order: a copy of that entry's
    block of ``t`` on its device (entries holding the same block, over an
    axis ``spec`` does not name, each hold their own copy), or None where
    the entry holds none of it (``slot``: see :func:`blocks`)."""
    return [None if sl is None else t[sl].to(dev, copy=True)
            for sl, dev in zip(blocks(t.shape, spec, mesh, slot),
                               mesh.devices)]


def gather(shards: Sequence[Optional[torch.Tensor]], spec: Sequence, mesh,
           shape: Sequence[int], device, slot=None) -> torch.Tensor:
    """The full ``shape`` tensor rebuilt on ``device`` from :func:`shard`'s
    ``shards`` with ``Tensor.to``, each held block written in mesh
    order."""
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of "
                         f"{mesh.size} entries")
    dtype = next(s.dtype for s in shards if s is not None)
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    for sl, s in zip(blocks(shape, spec, mesh, slot), shards):
        if sl is not None:
            out[sl] = s.to(out.device)
    return out
