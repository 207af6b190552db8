"""CompiledProgram — the serializable unit the :class:`Engine` executes.

A compiled program is exactly what the paper ships to the accelerator:

  * the 128-bit instruction binary (``isa.assemble`` output) — the only
    thing the runtime *dispatches* from;
  * a weights + graph-metadata manifest — the DDR payload: model weights,
    the fiber-shard ELL tiles of the input graph, and the per-layer
    dataflow facts that do not belong in instructions (weight key names,
    vector-add operands, scalar coefficients).

``save``/``load`` round-trip the pair through a single ``.gagi`` file
(a zip of ``program.bin`` + ``manifest.json`` + ``data.npz``), so a model
compiled once can serve later sessions with zero recompilation.
"""
from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.ir import ModelIR
from repro_torch.core.passes.kernel_map import Program
from repro_torch.core.passes.partition import (ELLTile, PartitionConfig,
                                               PartitionedGraph)

MANIFEST_FORMAT = "gagi-program"
MANIFEST_VERSION = 1

# Layer attrs copied verbatim into the manifest: weight-key indirections
# and scalar coefficients the ISA cannot carry.
_WEIGHT_ATTRS = ("W", "b", "fused_scale", "fused_shift",
                 "mu", "sigma", "gamma", "beta")


def _layer_manifest(model: ModelIR) -> Dict[str, Dict[str, Any]]:
    layers: Dict[str, Dict[str, Any]] = {}
    for lid, l in model.layers.items():
        meta: Dict[str, Any] = {
            "parents": [int(p) for p in l.parent_ids],
        }
        ewl = l.attrs.get("edge_weight_layer")
        if ewl is not None:
            meta["edge_weight_layer"] = int(ewl)
        for k in _WEIGHT_ATTRS:
            if k in l.attrs:
                meta[k] = l.attrs[k]
        if "fused_act" in l.attrs:
            meta["fused_act"] = int(l.attrs["fused_act"])
        if "operands" in l.attrs:
            meta["operands"] = [int(o) for o in l.attrs["operands"]]
        if "alpha" in l.attrs:
            meta["alpha"] = float(l.attrs["alpha"])
            meta["beta"] = float(l.attrs["beta"])
        if "eps" in l.attrs:
            meta["eps"] = float(l.attrs["eps"])
        if "mode" in l.attrs:
            meta["mode"] = l.attrs["mode"]
        layers[str(lid)] = meta
    return layers


def tile_density_stats(pg: PartitionedGraph) -> dict:
    """Per-tile nnz/density summary (manifest ``tile_stats`` section),
    computed from the ELL metadata at every compile."""
    n1 = pg.config.n1
    tiles: Dict[str, dict] = {}
    total_nnz = 0
    padded_slots = 0
    for (j, k) in sorted(pg.tiles):
        slices = pg.tiles[(j, k)]
        nnz = sum(t.nnz for t in slices)
        width = sum(t.width for t in slices)
        slots = n1 * width
        total_nnz += nnz
        padded_slots += slots
        tiles[f"{j}:{k}"] = {
            "nnz": int(nnz),
            "slices": len(slices),
            "width": int(width),
            "density": round(nnz / slots, 6) if slots else 0.0,
        }
    return {
        "n_tiles": len(tiles),
        "total_nnz": int(total_nnz),
        "padded_slots": int(padded_slots),
        "mean_density": round(total_nnz / padded_slots, 6)
        if padded_slots else 0.0,
        "tiles": tiles,
    }


def build_manifest(program: Program, graph_name: str = "graph",
                   n_devices: Optional[int] = None) -> dict:
    """Everything `engine.run` needs beyond the binary + arrays.

    ``n_devices`` (set when the program is compiled for a mesh) adds a
    ``placement`` section: the per-device shard orders and halo sets of
    the multi-device executor.  Programs compiled without it still run
    on a mesh — the executor derives the placement from the binary, the
    same backward-compat path old ``.gagi`` bundles take.

    ``tile_stats`` records per-tile nnz/density from the ELL metadata —
    the observability a Dynasparse-style bind-time kernel remapper would
    key on (see ROADMAP)."""
    from repro_torch.core.passes.schedule import (placement_schedule,
                                                  residency_schedule)
    m, pg = program.model, program.pgraph
    sinks = [i for i, l in m.layers.items() if not l.child_ids]
    sink = sinks[-1] if sinks else m.topo_order()[-1]
    residency = residency_schedule(program)
    placement = (placement_schedule(program, n_devices, residency)
                 if n_devices is not None else None)
    return {
        "residency": residency,
        **({"placement": placement} if placement is not None else {}),
        "format": MANIFEST_FORMAT,
        "version": MANIFEST_VERSION,
        "model_name": m.name,
        "graph_name": graph_name,
        "geometry": {
            "n1": pg.config.n1,
            "n2": pg.config.n2,
            "width_cap": pg.config.width_cap,
            "n_blocks": pg.n_blocks,
            "n_vertices": pg.n_vertices,
            "n_edges": pg.n_edges,
            "n_pes": program.n_pes,
        },
        "sink": int(sink),
        "sink_f_out": int(m.layers[sink].f_out),
        "tile_stats": tile_density_stats(pg),
        "layers": _layer_manifest(m),
    }


@dataclasses.dataclass
class CompiledProgram:
    """A (binary, manifest, weights, tiles) bundle ready to execute.

    ``source`` optionally keeps the in-process :class:`CompileResult`
    (pass reports, the object-graph Program) for introspection and the
    analytic perf model; it is *never* touched by the execution path and
    is dropped by ``save``/``load``.
    """

    binary: bytes
    manifest: dict
    weights: Dict[str, np.ndarray]
    pgraph: PartitionedGraph
    t_loc: float = 0.0
    cache_key: str = ""
    # Execution-mode default ("device" | "host") set by
    # ``Engine.compile(residency=...)``; never serialized — a loaded
    # program runs device-resident unless the caller asks otherwise.
    default_residency: Optional[str] = dataclasses.field(
        default=None, compare=False)
    source: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    _plan: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)

    # ------------------------------------------------------------------ #
    @property
    def model_name(self) -> str:
        return self.manifest.get("model_name", "model")

    @property
    def graph_name(self) -> str:
        return self.manifest.get("graph_name", "graph")

    @property
    def binary_bytes(self) -> int:
        return len(self.binary)

    def instruction_count(self) -> int:
        import struct
        return struct.unpack_from("<IIII", self.binary, 0)[2]

    def plan(self):
        """Decode the binary into an execution plan (cached)."""
        if self._plan is None:
            from .decoder import decode_binary
            self._plan = decode_binary(self.binary)
        return self._plan

    # ------------------------------------------------------------------ #
    def save(self, path: str) -> None:
        """Serialize to a ``.gagi`` file (binary + manifest + arrays)."""
        arrays: Dict[str, np.ndarray] = {
            "inv_in_degree": np.asarray(self.pgraph.inv_in_degree),
        }
        for name, w in self.weights.items():
            arrays[f"w:{name}"] = np.asarray(w)
        for (j, k), slices in self.pgraph.tiles.items():
            for s, t in enumerate(slices):
                stem = f"t:{j}:{k}:{s}"
                arrays[stem + ":cols"] = t.cols
                arrays[stem + ":vals"] = t.vals
                arrays[stem + ":epos"] = t.edge_pos
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
            z.writestr("program.bin", self.binary)
            z.writestr("manifest.json", json.dumps(self.manifest, indent=1))
            z.writestr("data.npz", buf.getvalue())

    @staticmethod
    def load(path: str) -> "CompiledProgram":
        """Rebuild a program saved with :meth:`save`.

        The result carries no in-memory IR at all — execution is driven
        purely by the decoded binary plus the manifest arrays.
        """
        with zipfile.ZipFile(path, "r") as z:
            binary = z.read("program.bin")
            manifest = json.loads(z.read("manifest.json"))
            data = np.load(io.BytesIO(z.read("data.npz")))
        if manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"{path}: not a GraphAGILE program bundle")
        if manifest.get("version") != MANIFEST_VERSION:
            raise ValueError(
                f"{path}: manifest version {manifest.get('version')} "
                f"unsupported (expected {MANIFEST_VERSION})")

        weights: Dict[str, np.ndarray] = {}
        tile_parts: Dict[Tuple[int, int, int], Dict[str, np.ndarray]] = {}
        for key in data.files:
            if key.startswith("w:"):
                weights[key[2:]] = data[key]
            elif key.startswith("t:"):
                _, j, k, s, part = key.split(":")
                tile_parts.setdefault(
                    (int(j), int(k), int(s)), {})[part] = data[key]

        tiles: Dict[Tuple[int, int], List[ELLTile]] = {}
        for (j, k, s) in sorted(tile_parts):
            p = tile_parts[(j, k, s)]
            t = ELLTile(shard_row=j, shard_col=k, cols=p["cols"],
                        vals=p["vals"], edge_pos=p["epos"],
                        nnz=int((p["epos"] >= 0).sum()))
            tiles.setdefault((j, k), []).append(t)

        geo = manifest["geometry"]
        cfg = PartitionConfig(n1=int(geo["n1"]), n2=int(geo["n2"]),
                              width_cap=int(geo["width_cap"]))
        pg = PartitionedGraph(
            config=cfg, n_vertices=int(geo["n_vertices"]),
            n_edges=int(geo["n_edges"]), n_blocks=int(geo["n_blocks"]),
            tiles=tiles, inv_in_degree=data["inv_in_degree"])
        return CompiledProgram(binary=binary, manifest=manifest,
                               weights=weights, pgraph=pg)


def from_program(program: Program, binary: Optional[bytes] = None,
                 t_loc: float = 0.0, cache_key: str = "",
                 graph_name: str = "graph",
                 source: Optional[Any] = None,
                 n_devices: Optional[int] = None) -> CompiledProgram:
    """Wrap an object-graph :class:`Program` into a CompiledProgram.

    The manifest gains a ``dep_graph`` section — the RAW/WAR/WAW hazard
    DAG re-derived from the freshly assembled binary (see
    :mod:`repro_torch.verify.hazards`) — so every ``.gagi`` bundle carries
    its own dependence structure, as the JAX package's do."""
    from repro_torch.core.isa import assemble
    if binary is None:
        binary = assemble(program.all_instrs())
    weights = {k: np.asarray(v) for k, v in program.model.weights.items()}
    manifest = build_manifest(program, graph_name, n_devices=n_devices)
    manifest["dep_graph"] = _dep_graph_section(binary, manifest,
                                               program.pgraph)
    return CompiledProgram(
        binary=binary, manifest=manifest,
        weights=weights, pgraph=program.pgraph, t_loc=t_loc,
        cache_key=cache_key, source=source)


def _dep_graph_section(binary: bytes, manifest: dict, pgraph) -> dict:
    from repro_torch.verify.hazards import dep_graph_manifest
    from repro_torch.verify.model import build_model

    from .decoder import decode_binary
    plan = decode_binary(binary)
    model = build_model(plan, manifest["layers"], manifest["geometry"],
                        pgraph=pgraph)
    return dep_graph_manifest(model, manifest["layers"])
