"""Static cost analysis of one step traced on the ``meta`` device (torch;
the counterpart of ``repro/launch/hlo_analysis.py``).

JAX's dry-run reads XLA's partitioned HLO: flops, HBM bytes and the
collectives GSPMD inserted, all per device.  The port has no HLO and no
SPMD partitioner.  :func:`analyze` instead runs the step eagerly on meta
tensors (nothing is allocated or computed) under a ``TorchDispatchMode``
and records, for every aten op:

  * flops      — the matmul family as 2*M*N*K, by the formulas of
                 ``torch.utils.flop_counter.FlopCounterMode``;
                 a kernel wrapper called on meta operands adds its
                 kernel's own formula (``kernels/ops.py``: flash counts
                 the (query, key) pairs its causal / window skip keeps);
  * hbm_bytes  — operand plus result bytes of every op that moves data
                 (views and allocations move none): each eager op is its
                 own fusion boundary; a kernel adds its own bytes;
  * peak_bytes — the peak of live bytes of the storages the step
                 allocates, each storage counted once (views share it) and
                 freed when its last reference dies (a weakref on the
                 storage), which is what the caching allocator holds less
                 its rounding.

The figures are of the whole (global) step.  Per-device flops and bytes
are the global figures over ``n_devices``: the even split, since nothing
here partitions the program.  JAX's are GSPMD's per-device program,
replicated work included, so the two differ where a partitioned program
repeats work.  Collective bytes are not traced: :func:`spec_collectives`
derives them from the sharding specs (its docstring lists each term),
with the ring scaling of :func:`ring_bytes`.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops

# Ops that allocate without moving data (their result is still live).
_NO_TRAFFIC = {
    torch.ops.aten.empty, torch.ops.aten.empty_like,
    torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
    torch.ops.aten.new_empty_strided,
}


@dataclasses.dataclass
class Costs:
    """One traced step (``HloCosts``' fields, per device, plus the live
    peak and the kernels' own share of the flops)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    unknown_trip_whiles: int = 0        # no loops to guess: always 0
    peak_bytes: float = 0.0
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def ring_bytes(kind: str, size: float, n: int) -> float:
    """Wire bytes per device of one collective over n devices, ring
    algorithm: all-reduce 2 S (n-1)/n; all-gather, reduce-scatter and
    all-to-all S (n-1)/n; collective-permute S.  S is the full buffer
    (JAX's analyzer takes the op's result, which for a reduce-scatter is
    the scattered piece)."""
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / max(n, 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return size * (n - 1) / max(n, 1)
    return float(size)                   # collective-permute


def _tensors(tree) -> list:
    """The tensors among an op's arguments or results (flat, or in
    lists and tuples, as aten passes them)."""
    out = []
    for a in tree:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class _Tracer(TorchDispatchMode):
    """Flops, bytes moved and the live peak of every aten op (module
    docstring).  Flops are ``FlopCounterMode``'s: its formula for the op
    where it has one, else the op's decomposition where aten has one
    (counted op by op), else none."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0.0
        self.live = self.peak = 0
        self._held: Dict[int, Any] = {}  # storage key -> its weakref

    def _track(self, st: torch.UntypedStorage) -> None:
        key = st._cdata
        if key in self._held:
            return
        nbytes = st.nbytes()

        def freed(_, key=key, nbytes=nbytes):
            self.live -= nbytes
            self._held.pop(key, None)

        self._held[key] = weakref.ref(st, freed)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        formula = flop_registry.get(packet)
        if formula is None:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.hbm_bytes += sum(t.numel() * t.element_size()
                                  for t in ins + outs)
        known = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if st._cdata not in known:
                self._track(st)
        return out


def analyze(fn: Callable, *args, n_devices: int = 1, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` (on meta tensors) and return its costs:
    flops and HBM bytes per device (the global trace over ``n_devices``),
    the global live peak of what it allocated, the kernels' formula flops
    by kernel (global).  ``collective_bytes`` is left empty."""
    kernel_flops: Dict[str, float] = {}
    kernel_bytes = [0.0]

    def sink(name, flops, nbytes):
        kernel_flops[name] = kernel_flops.get(name, 0.0) + flops
        kernel_bytes[0] += nbytes

    tracer = _Tracer()
    with tracer, ops.meta_costs(sink):
        fn(*args, **kwargs)
    flops = tracer.flops + sum(kernel_flops.values())
    return Costs(flops=flops / n_devices,
                 hbm_bytes=(tracer.hbm_bytes + kernel_bytes[0]) / n_devices,
                 peak_bytes=float(tracer.peak), kernel_flops=kernel_flops)


# --------------------------------------------------------------------------- #
# Collectives from the specs.
# --------------------------------------------------------------------------- #
_OUT_PROJECTIONS = ("wo", "w_out", "w_down")


def _elem(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def spec_collectives(model, cfg, cell, mesh) -> Dict[str, float]:
    """Wire bytes per device, by collective kind, of one step of ``cell``
    on ``mesh`` under the sharding and ZeRO specs:

    * ZeRO-1 (train): each parameter's gradient, at its tensor-parallel
      local shape and dtype, reduce-scattered over ``data`` and the
      updated parameter all-gathered over ``data`` where the zero spec
      adds ``data``, else all-reduced over ``data``; over ``pod`` too (a
      multi-pod mesh), the data-scattered gradient is all-reduced;
    * tensor parallelism: one all-reduce of the [B_local, T, d]
      activation (the model's dtype) over ``model`` after every output
      projection whose contracted dimension is sharded over ``model``
      (``wo`` / ``w_out`` / ``w_down`` of attention, MLP, shared expert,
      SSM and xLSTM blocks), three times in a train step (forward,
      rematerialized forward, backward);
    * expert parallelism: a MoE layer under ``moe_a2a`` moves its capacity
      buffers [E, cap, d] twice (to the experts' owners and back), an
      all-to-all over ``model`` each, three times in a train step; in
      decode (``moe_local``) the fp32 [B_local, 1, d] output is
      all-reduced over ``model`` instead.

    B_local is the batch over the batch axes when it divides, T the
    cell's sequence (whisper's decoder: its target length; 1 in decode).
    """
    from repro_torch.distributed.zero import opt_state_specs
    out: Dict[str, float] = {}

    def add(kind, size, n):
        if n > 1:
            out[kind] = out.get(kind, 0.0) + ring_bytes(kind, size, n)

    named = dict(model.named_parameters())
    specs = SH.param_specs(named, mesh)
    n_data = mesh.shape.get("data", 1)
    n_model = mesh.shape.get(SH.MODEL_AXIS, 1)
    passes = 3 if cell.kind == "train" else 1
    if cell.kind == "train":
        zspecs = opt_state_specs(model, mesh).master
        for n, p in named.items():
            size = SH.held_nbytes(p.shape, p.dtype, specs[n], mesh)
            if any("data" in SH._axis_tuple(e) for e in zspecs[n]):
                add("reduce-scatter", size, n_data)
                add("all-reduce", size / n_data, mesh.shape.get("pod", 1))
                add("all-gather", size, n_data)
            else:
                add("all-reduce", size, n_data * mesh.shape.get("pod", 1))
    b = cell.global_batch
    nb = SH._batch_size(mesh)
    b_loc = b // nb if b % nb == 0 else b
    dt = _elem(cfg.torch_dtype)
    for n, p in named.items():
        parts = n.split(".")
        if (parts[-1] in _OUT_PROJECTIONS and p.dim() == 2
                and SH.MODEL_AXIS in SH._axis_tuple(specs[n][0])):
            t = 1 if cell.kind == "decode" else (
                cfg.decoder_target_len if parts[0] == "decoder"
                else cell.seq_len)
            add("all-reduce", passes * b_loc * t * cfg.d_model * dt,
                n_model)
    n_moe = sum(1 for n in named if n.endswith("moe.router"))
    if n_moe and cell.kind == "decode":
        add("all-reduce", n_moe * b_loc * cfg.d_model * 4, n_model)
    elif n_moe:
        t = cell.seq_len
        t_loc = t // n_model if t % n_model == 0 and t > 1 else t
        cap = max(4, -(-int(b_loc * t_loc * cfg.top_k * cfg.capacity_factor)
                       // cfg.n_experts))
        buf = cfg.n_experts * cap * cfg.d_model * dt
        add("all-to-all", passes * 2 * n_moe * buf, n_model)
    return out

