"""repro.livegraph — incremental graph mutation + versioned serving.

The compiler stack below this package treats a graph as a snapshot:
change an edge, recompile.  This package makes the deployed graph a
*living* object without giving up the compiled-program economics:

  * :class:`GraphDelta`       — validated, coalescible mutation log
    (add/remove edges, add vertices with features);
  * :class:`TileStore`        — incremental fiber-shard tile patching:
    a delta rebuilds only the (j, k) tiles it touches, with per-tile
    content hashes folded into a Merkle-style graph signature
    (``livegraph.tiles``);
  * :class:`GraphVersionStore` / :class:`GraphVersion` — copy-on-write
    immutable versions sharing untouched tiles, each binding compiled
    programs to its tiles without recompilation
    (``livegraph.versioning``);
  * :class:`LiveGraphServer`  — zero-downtime cutover: in-flight
    requests finish on version N while new admissions route to N+1;
    drained versions are reclaimed (``livegraph.swap``).

Quickstart::

    from repro_torch.livegraph import (GraphDelta, GraphVersionStore,
                                       LiveGraphServer)

    store = GraphVersionStore(graph, geometry=engine.geometry)
    live = LiveGraphServer(store)
    resp = engine.submit(InferenceRequest("b1", live, x))   # version 0

    delta = GraphDelta(live.n_vertices).add_edge(3, 7, 0.5)
    live.apply(delta)                                       # cut over
    resp = engine.submit(InferenceRequest("b1", live, x))   # version 1,
    # same compiled program, patched tiles — no recompile, bit-identical
    # to a cold compile of the mutated graph.
"""
from .delta import CoalescedDelta, GraphDelta
from .swap import LiveGraphServer, admit, resolve_version
from .tiles import (PatchStats, TileStore, as_graph_data,
                    tile_density_stats)
from .versioning import GraphVersion, GraphVersionStore

__all__ = [
    "CoalescedDelta", "GraphDelta", "GraphVersion", "GraphVersionStore",
    "LiveGraphServer", "PatchStats", "TileStore", "admit",
    "as_graph_data", "resolve_version", "tile_density_stats",
]
