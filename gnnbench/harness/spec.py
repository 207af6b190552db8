"""Finding a cell's files by the names ``BENCHMARK.json`` gives them."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    @property
    def family(self):
        return family(self.config["family"])

    @property
    def reference(self):
        return reference(self.config["family"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports."""
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(ROOT, cfg_entry["file"])),
        traffic=traffic(w["traffic"]),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def config(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def family(name: str):
    return importlib.import_module(f"gnnbench.models.{name}")


def reference(name: str):
    return importlib.import_module(f"gnnbench.reference.{name}")


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, loaded by path
    (a metric's name may hold '.' or '-')."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "gnnbench.metrics." + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str) -> Optional[dict]:
    """The data-sheet peaks of the card named ``kind``, or None."""
    table = _json(os.path.join(BENCH_DIR, "peaks.json"))
    for entry in table["cards"]:
        if entry["match"] in kind:
            return entry
    return None
