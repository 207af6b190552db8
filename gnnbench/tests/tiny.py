"""A tiny cell of each configuration, for runs on the CPU."""
import copy

from gnnbench.harness import spec

GRAPH = {"n_vertices": 300, "n_edges": 1500, "feat_dim": 24, "n_classes": 5}


def cell(config: str, traffic: str = "resident", **traffic_kw) -> spec.Cell:
    """``config`` under ``traffic`` at a 300-vertex graph, reporting the
    metrics of BENCHMARK.json's cell of ``config`` under "resident"."""
    cfg = copy.deepcopy(spec.config(config))
    cfg["graph"].update(GRAPH)
    cfg["hidden"] = 16
    tr = spec.traffic(traffic)
    tr.update(traffic_kw)
    full = spec.load_cell(f"{config}.resident")
    return spec.Cell(name=f"{config}.{traffic}", chips=1, config=cfg,
                     traffic=tr,
                     end_to_end=full.end_to_end, per_layer=full.per_layer)
