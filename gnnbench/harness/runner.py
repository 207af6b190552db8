"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the check, and the result line."""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import check, graphgen, inputs as inputs_mod, serve, spec
from . import trace as trace_mod

BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    cfg: dict
    family: object
    n_vertices: int
    nnz: int                        # distinct non-zeros of A with loops
    peaks: Optional[dict]
    setup_s: float
    compile_s: float
    seconds: float                  # the window's length
    sent: List[serve.Done]          # answered requests sent in the window
    completed: int                  # of them, answered inside the window
    batch_sizes: List[int]          # batches dispatched in the window
    launches: Dict[str, int]        # kernel launches in the window
    replayed: Dict[str, int]        # of them, launched by replays
    trace: Optional[trace_mod.Trace] = None
    trace_batches: List[int] = dataclasses.field(default_factory=list)

    def work(self, kernel: str, batch_sizes: List[int]) -> Tuple[float, float]:
        """(flops, bytes) ``kernel`` needs for these batches."""
        flops = nbytes = 0.0
        for n in batch_sizes:
            f, b = self.family.work(self.cfg, self.n_vertices, self.nnz,
                                    n).get(kernel, (0.0, 0.0))
            flops, nbytes = flops + f, nbytes + b
        return flops, nbytes

    def roofline(self, kernel: str, patterns) -> Optional[float]:
        """Least time of ``kernel``'s work in the traced stretch over the
        device time of the kernels named by ``patterns``, in %."""
        if self.trace is None or self.peaks is None:
            return None
        dev = sum(s for name, s in self.trace.kernel_s.items()
                  if any(p in name for p in patterns))
        flops, nbytes = self.work(kernel, self.trace_batches)
        if dev <= 0 or flops <= 0:
            return None
        least = max(flops / self.peaks["fp32_flop_s"],
                    nbytes / self.peaks["hbm_bytes_s"])
        return 100.0 * least / dev

    @property
    def flops_per_request(self) -> float:
        return sum(f for f, _ in self.family.work(
            self.cfg, self.n_vertices, self.nnz, 1).values())


def _kernel_counts(ops) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(every launch, replays' launches) by kernel, SpDMM's in launches
    of the kernel rather than tile steps; read with no pass in flight."""
    run = {**ops.launch_totals(), **ops.kernel_launch_totals()}
    rep = {**ops.REPLAYED, **ops.KERNEL_REPLAYED}
    return run, rep


def _delta(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: b[k] - a[k] for k in b}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_proc: float, device: str = "cuda",
             log: Callable[[str], None] = lambda s: None) -> dict:
    """Run ``cell`` once; returns the result (the keys of the last line,
    ``checks`` last)."""
    from repro_torch.core import gnn_builders as B
    from repro_torch.core import graph as G
    from repro_torch.kernels import ops

    cfg, traffic, fam = cell.config, cell.traffic, cell.family
    on_card = device != "cpu"
    g = cfg["graph"]
    log(f"imports done at {time.perf_counter() - t_proc:.3f} s")
    src, dst = graphgen.edges(g)
    loops = graphgen.with_self_loops(src, dst, g["n_vertices"])
    nnz = graphgen.distinct_pairs(*loops, g["n_vertices"])
    graph = fam.program_graph(G, src, dst, cfg)
    model = fam.program_model(B, graph, cfg)
    log(f"graph and model built at {time.perf_counter() - t_proc:.3f} s")
    inputs = inputs_mod.make(cfg, traffic, fam, seed, device)
    inputs_mod.bind_weights(model, inputs.linears)
    pool = serve.TracedPool(traffic["n_overlays"], device=device,
                            verify=False)
    make = serve.request_maker(model, graph, inputs)
    log(f"graph, model and inputs ready at "
        f"{time.perf_counter() - t_proc:.3f} s")
    compile_s = serve.warm(pool, traffic, make, on_card, log)
    if on_card:
        torch.cuda.synchronize()
    run0, rep0 = _kernel_counts(ops)
    setup_s = time.perf_counter() - t_proc
    log(f"set-up {setup_s:.3f} s (compile {compile_s:.3f} s), window "
        f"{seconds} s")

    # ---- the measured window ------------------------------------------
    clients = serve.Clients(pool, traffic, make, inputs, seed,
                            keep=check.SAMPLE)
    start, close = clients.run(seconds)
    clients.shutdown()
    run1, rep1 = _kernel_counts(ops)
    # ---- window closed -------------------------------------------------
    sent = clients.done
    completed = sum(1 for d in sent if d.done <= close)
    ctx = Context(
        cfg=cfg, family=fam, n_vertices=g["n_vertices"], nnz=nnz,
        peaks=spec.peaks(torch.cuda.get_device_name(0)) if on_card
        else None, setup_s=setup_s, compile_s=compile_s,
        seconds=close - start, sent=sent, completed=completed,
        batch_sizes=clients.metrics.batch_sizes, launches=_delta(run0, run1),
        replayed=_delta(rep0, rep1))
    log(f"window: {len(sent)} answered of {len(sent) + clients.unanswered}"
        f" sent, {completed} inside {ctx.seconds:.3f} s; batches "
        f"{_hist(ctx.batch_sizes)}; launches {ctx.launches}, by replays "
        f"{ctx.replayed}")

    if trace and on_card:
        stretch = serve.Clients(pool, traffic, make, inputs, seed, keep=0)
        ctx.trace = trace_mod.run(
            lambda: stretch.run(trace_mod.STRETCH_S))
        stretch.shutdown()
        ctx.trace_batches = stretch.metrics.batch_sizes
        log(f"trace: {ctx.trace.events} device events over "
            f"{ctx.trace.window_s:.4f} s, busy {ctx.trace.busy_s:.4f} s, "
            f"batches {_hist(ctx.trace_batches)}, read in "
            f"{ctx.trace.read_s:.3f} s")

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if on_card else 0)}
    if ctx.trace is not None:
        device_info.update(busy_s=ctx.trace.busy_s,
                           window_s=ctx.trace.window_s)

    # ---- the program's state freed, then the reference -----------------
    kept, unanswered = clients.kept, clients.unanswered
    del clients, pool, make, model, graph
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = check.reference_outputs(cell.reference, cfg, (src, dst), inputs,
                                   [item for _, item, _ in kept])
    correct, checks = check.judge(cfg, kept, refs, unanswered)
    log(f"reference: {len(refs)} pool items for {len(kept)} held outputs "
        f"in {time.perf_counter() - t_ref:.3f} s")

    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(sent) + unanswered,
              "failed": unanswered, "metrics": metrics,
              "device": device_info}
    if ctx.trace is not None:
        ops_s: Dict[str, float] = {}
        for n, s in ctx.trace.kernel_s.items():
            ops_s[trace_mod.short(n)] = ops_s.get(trace_mod.short(n), 0.0) + s
        result["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in ops_s.items()),
                                 key=lambda x: -x[1])[:trace_mod.TOP],
            "idle_gaps": [[n, s] for n, s in ctx.trace.gaps]}
    result["checks"] = checks
    return result


def _hist(sizes: List[int]) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for s in sizes:
        out[s] = out.get(s, 0) + 1
    return dict(sorted(out.items()))


def banned_modules() -> List[str]:
    """Top-level names of JAX and the JAX package held in sys.modules,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))
