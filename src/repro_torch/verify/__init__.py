"""Static program analysis of GraphAGILE binaries (copies of the JAX
package's ``repro/verify/model.py`` and ``hazards.py``).

So far only what manifests need: :func:`build_model` derives the def/use
model of a decoded binary and :func:`dep_graph_manifest` folds its
hazard graph into the ``dep_graph`` manifest section, which makes the
port's manifests equal the JAX package's.  The checker suite, the trace
race detector and the report (``checks.py``, ``race.py``, ``report.py``)
are ROADMAP A14.
"""
from .hazards import (DEP_GRAPH_TILE_EDGE_CAP, HazardGraph, build_hazards,
                      dep_graph_manifest, sources_by_shard)
from .model import (DefUseModel, TileOp, build_model, layer_consumes,
                    tile_slices_from_stats)

__all__ = ["DEP_GRAPH_TILE_EDGE_CAP", "HazardGraph", "build_hazards",
           "dep_graph_manifest", "sources_by_shard", "DefUseModel",
           "TileOp", "build_model", "layer_consumes",
           "tile_slices_from_stats"]
