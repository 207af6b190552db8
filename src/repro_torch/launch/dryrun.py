"""Dry-run: trace every (architecture x input shape) cell on a production
mesh on the ``meta`` device and record its memory, costs and roofline
(torch; the counterpart of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # full sweep

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json (resumable:
cells with an artifact are skipped unless --force).  JAX's sweep keeps
its own ``artifacts/dryrun/``.

Where JAX lowers and compiles the cell's jitted step for 256 or 512
devices, the port builds the model on ``meta`` (MoE models with
``moe_impl="a2a"`` over the mesh's ``model`` axis, as JAX's ``run_cell``
does: the dense oracle would count every expert on every token) and runs
the step once under ``launch/op_analysis.py``.  The record keeps JAX's
keys.  ``memory.argument_bytes`` is exact: the bytes of one device's
blocks of the parameters, the AdamW state under ZeRO-1's specs (train;
the step count lives on the host) and the batch, or the caches (decode),
under the sharding specs.  ``temp_bytes`` is the traced live peak over
the devices (the even split, as the flops) less the step's new outputs;
outputs written in place are ``alias_bytes``.  The roofline prices the
per-device costs with an H100 SXM5 80 GB at 700 W (NVIDIA's data sheet):
989e12 bf16 dense FLOP/s, ``core/perfmodel.py``'s ``HBM_BW`` (3.35e12
B/s of HBM3) and 450e9 B/s of NVLink 4 a direction for collectives.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.zero import opt_state_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analyze, spec_collectives
from repro_torch.launch.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell
from repro_torch.models.steps import (build_model, init_train_state,
                                      input_specs, make_prefill_step,
                                      make_serve_step, make_train_step)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# long_500k runs only for sub-quadratic-capable archs (DESIGN.md §4):
LONG_OK = {"gemma3-12b", "gemma3-27b", "hymba-1.5b", "xlstm-125m"}


def cell_supported(arch: str, shape: str) -> Optional[str]:
    """None if runnable; otherwise the reason for the skip."""
    if shape == "long_500k" and arch not in LONG_OK:
        return ("pure full-attention arch: 512k decode needs sub-quadratic "
                "attention / bounded state (see DESIGN.md §4)")
    return None


def _nbytes(shape, dtype: torch.dtype, spec, mesh, slot=None) -> int:
    """Bytes of mesh entry 0's block (every entry holds as many)."""
    return SH.held_nbytes(tuple(shape), dtype, spec, mesh, slot)


def _batch_bytes(specs: Dict[str, torch.Tensor], mesh) -> int:
    total = 0
    for k, s in specs.items():
        spec = () if k == "pos" else SH.batch_spec(mesh, s.shape[0],
                                                   s.dim() - 1)
        total += _nbytes(s.shape, s.dtype, spec, mesh)
    return total


def init_cell_cache(model, cfg: ModelConfig, cell: ShapeCell):
    """The decode cell's cache from the model's own ``init_cache`` (an
    encoder-decoder's at its target length, over ``seq_len`` frames)."""
    if cfg.encoder_decoder:
        return model.init_cache(cell.global_batch, cfg.decoder_target_len,
                                cross_len=cell.seq_len)
    return model.init_cache(cell.global_batch, cell.seq_len)


def cache_bytes(cache, cell: ShapeCell, mesh) -> int:
    """One device's bytes of a per-layer cache list under the cache
    specs."""
    return sum(_nbytes(t.shape, t.dtype,
                       SH.cache_spec(name, tuple(t.shape),
                                     cell.global_batch, mesh), mesh)
               for layer in cache for name, t in layer.items())


def param_bytes(model, mesh) -> int:
    """One device's bytes of ``model``'s parameters under their specs."""
    named = dict(model.named_parameters())
    pspecs = SH.param_specs(named, mesh)
    return sum(_nbytes(p.shape, p.dtype, pspecs[n], mesh)
               for n, p in named.items())


def state_bytes(model, mesh) -> int:
    """One device's bytes of the fp32 master, mu and nu under ZeRO-1."""
    zspecs = opt_state_specs(model, mesh).master
    slots = SH.layer_slots(model)
    return 3 * sum(_nbytes(p.shape, torch.float32, zspecs[n], mesh,
                           slots.get(n))
                   for n, p in model.named_parameters())


def argument_bytes(model, cfg: ModelConfig, cell: ShapeCell, mesh) -> int:
    """One device's bytes of the step's arguments (module docstring)."""
    total = param_bytes(model, mesh)
    if cell.kind == "train":
        total += state_bytes(model, mesh)
    if cell.kind == "decode":
        total += cache_bytes(init_cell_cache(model, cfg, cell), cell, mesh)
    return total + _batch_bytes(input_specs(cfg, cell), mesh)


def analyze_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
                 record: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Trace one cell of ``cfg`` on ``mesh`` (its entries may be any
    device: the model is built on ``meta``) and return the record."""
    n_dev = mesh.size
    moe = cfg.is_moe and SH.MODEL_AXIS in mesh.axis_names
    model = build_model(cfg, device="meta", moe_impl="a2a" if moe
                        else "dense",
                        mesh=mesh.along(SH.MODEL_AXIS) if moe else None)
    rec: Dict[str, Any] = dict(record or {})
    rec.update({"n_devices": n_dev, "kind": cell.kind,
                "n_params": cfg.n_params(),
                "n_active_params": cfg.n_active_params(),
                "tokens": cell.tokens if cell.kind != "decode"
                else cell.global_batch})
    args = argument_bytes(model, cfg, cell, mesh)
    t0 = time.time()
    if cell.kind == "train":
        model, opt = init_train_state(model)
        costs = analyze(make_train_step(model, cfg), model, opt,
                        input_specs(cfg, cell), n_devices=n_dev)
        alias = args - _batch_bytes(input_specs(cfg, cell), mesh)
        new_out = 2 * 4                     # loss and aux, fp32 0-d
    elif cell.kind == "prefill":
        costs = analyze(make_prefill_step(model, cfg), model,
                        input_specs(cfg, cell), n_devices=n_dev)
        alias = 0
        new_out = _nbytes((cell.global_batch, cfg.vocab), cfg.torch_dtype,
                          SH.batch_spec(mesh, cell.global_batch, 1), mesh)
    else:
        cache = init_cell_cache(model, cfg, cell)
        alias = cache_bytes(cache, cell, mesh)
        dspecs = input_specs(cfg, cell)
        costs = analyze(make_serve_step(model, cfg), model, cache,
                        dspecs["token"], dspecs["pos"], n_devices=n_dev)
        new_out = _nbytes((cell.global_batch, 1), torch.int32,
                          SH.batch_spec(mesh, cell.global_batch, 1), mesh)
    rec["trace_s"] = round(time.time() - t0, 2)
    costs.collective_bytes = spec_collectives(model, cfg, cell, mesh)
    temp = max(0, int(costs.peak_bytes // n_dev) - new_out)
    out = new_out + alias
    rec["memory"] = {"argument_bytes": args, "output_bytes": out,
                     "temp_bytes": temp, "alias_bytes": alias,
                     "per_device_total": args + out + temp - alias}
    rec["analysis"] = {
        "flops_per_device": costs.flops,
        "hbm_bytes_per_device": costs.hbm_bytes,
        "collective_bytes_per_device": costs.collective_bytes,
        "total_collective_bytes_per_device": costs.total_collective_bytes,
        "unknown_trip_whiles": costs.unknown_trip_whiles,
        "kernel_flops": costs.kernel_flops,
    }
    rec["roofline"] = {
        "compute_s": costs.flops / PEAK_FLOPS,
        "memory_s": costs.hbm_bytes / HBM_BW,
        "collective_s": costs.total_collective_bytes / LINK_BW,
    }
    rec["roofline"]["dominant"] = max(rec["roofline"],
                                      key=rec["roofline"].get)
    return rec


def run_cell(arch: str, shape: str, mesh_kind: str,
             overrides: Optional[Dict[str, Any]] = None,
             tag: str = "") -> Dict[str, Any]:
    """One cell of the sweep on the production mesh (``"single"``: 16 x
    16, ``"multi"``: 2 x 16 x 16), on meta entries."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    return analyze_cell(cfg, SHAPES[shape], mesh, {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "overrides": overrides or {}, "tag": tag})


def artifact_path(arch, shape, mesh_kind, tag="") -> str:
    os.makedirs(ART_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(
        ART_DIR, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=[None] + list(SHAPES))
    ap.add_argument("--mesh", default=None, choices=[None, "single",
                                                     "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    results = []
    for arch in archs:
        for shape in shapes:
            reason = cell_supported(arch, shape)
            for mesh_kind in meshes:
                path = artifact_path(arch, shape, mesh_kind)
                if reason:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_kind, "skipped": reason}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[skip] {arch} {shape} {mesh_kind}: {reason}")
                    continue
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {arch} {shape} {mesh_kind}")
                    continue
                print(f"[run] {arch} {shape} {mesh_kind} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_kind)
                    rec["status"] = "ok"
                    print(f"  ok: trace={rec['trace_s']}s "
                          f"mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB "
                          f"dominant={rec['roofline']['dominant']}",
                          flush=True)
                except Exception as e:  # record failures, keep sweeping
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": str(e)[:2000],
                           "trace": traceback.format_exc()[-4000:]}
                    print(f"  ERROR: {str(e)[:300]}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                results.append(rec)
    print(f"done ({len(results)} cells run)")


if __name__ == "__main__":
    main()
