"""The port's live graphs (``repro_torch.livegraph``) on device="cpu".

A twin of ``tests/test_livegraph.py`` over the port's Engine, runtime and
executor, plus parity with the JAX package:

  * the copied delta log and tile store give JAX's tiles, content hashes,
    structural and content signatures, patch statistics and canonical COO
    after the same deltas;
  * K deltas served incrementally through b1 / b3 / b6 and gat-dot are
    bit-identical to the port's own cold compile of the mutated graph on
    the device-resident, host-streaming and graph-as-data paths, and
    within rtol 2e-4 / atol 2e-5 of JAX's engine serving the same live
    graph;
  * content-only deltas keep the program-cache key, structural ones miss;
    batched serving on a version equals solo serving bit for bit; a
    cutover under load drops and misroutes nothing;
  * staging: a version uploads (``_Staged.uploaded``) and pins
    (``_HostTiles.nbytes``) exactly the bytes of the tiles its delta
    patched, sharing the rest with its parent, and reclaiming a version
    frees its own copies only;
  * gat-dot on a version whose edge ids have holes (net removals) reads
    no hole.

``test_livegraph.py::test_incremental_serving_on_mesh_path``'s twin runs a
live version on the port's mesh path (virtual CPU shards, D = 1 and 2),
bit for bit to a cold compile; what does not compose with a mesh (host
residency) is refused for a live run as for any other.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_models import build_gat_dot  # noqa: E402
from repro import livegraph as JL  # noqa: E402
from repro.core import gnn_builders as JB  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import InferenceRequest as JRequest  # noqa: E402
from repro.engine import graph_signature as j_graph_signature  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import (PartitionConfig,  # noqa: E402
                                               partition_graph)
from repro_torch.engine import (Engine, InferenceRequest,  # noqa: E402
                                graph_signature)
from repro_torch.engine.executor import (_host_tiles, _staged,  # noqa: E402
                                         _tile_share)
from repro_torch.livegraph import (GraphDelta, GraphVersionStore,  # noqa
                                   LiveGraphServer, as_graph_data,
                                   tile_density_stats)
from repro_torch.runtime import Metrics, OverlayPool, ServeLoop  # noqa: E402

GEOM = PartitionConfig(n1=32, n2=8)
JGEOM = JPC(n1=32, n2=8)
RTOL, ATOL = 2e-4, 2e-5
CPU = torch.device("cpu")
# Bytes per element of each staged tile kind, and whether it spans the
# [n1, w] slots, one entry a row, or the live slots.
KIND_BYTES = {"cols": (4, "slots"), "vals": (4, "slots"),
              "mask": (1, "slots"), "row_len": (4, "rows"),
              "live_pos": (8, "nnz"), "live_epos": (8, "nnz")}


def _g(nv=90, ne=400, f=12, c=4, seed=0, pkg=G):
    g = pkg.random_graph(nv, ne, seed=seed, dedupe=True).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _engine(**kw) -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu", **kw)


def _jengine() -> JEngine:
    return JEngine(geometry=JGEOM, n_pes=4, verify=False)


def _ops(g, rng, n_add=6, n_rm=2, weights=True):
    """A delta as a list of operations, built into either package's
    GraphDelta by :func:`_delta`."""
    ops = []
    for _ in range(n_add):
        u, v = map(int, rng.integers(0, g.n_vertices, 2))
        ops.append(("add", u, v,
                    float(rng.uniform(0.1, 1.0)) if weights else 1.0))
    for _ in range(n_rm):
        i = int(rng.integers(0, g.n_edges))
        ops.append(("rm", int(g.src[i]), int(g.dst[i])))
    return ops


def _delta(Delta, base_vertices, ops, feat_dim=0):
    d = Delta(base_vertices, feat_dim=feat_dim)
    for op in ops:
        if op[0] == "add":
            d.add_edge(*op[1:])
        elif op[0] == "rm":
            d.remove_edge(*op[1:])
        else:
            d.add_vertex(op[1])
    return d


def _kind_bytes(t, kind) -> int:
    item, over = KIND_BYTES[kind]
    n = {"slots": t.cols.size, "rows": t.cols.shape[0], "nnz": t.nnz}[over]
    return item * int(n)


def _patched_keys(v):
    return [tuple(map(int, k.split(":"))) for k in v.stats.patched]


# --------------------------------------------------------------------------- #
# GraphDelta: validation, coalescing, canonical order.
# --------------------------------------------------------------------------- #
def test_delta_validates_endpoints_and_weights():
    d = GraphDelta(10)
    with pytest.raises(IndexError):
        d.add_edge(10, 0)
    with pytest.raises(IndexError):
        d.remove_edge(0, -1)
    with pytest.raises(ValueError):
        d.add_edge(0, 1, float("nan"))
    v = d.add_vertex()
    assert v == 10
    d.add_edge(v, 3)
    with pytest.raises(IndexError):
        d.add_edge(11, 3)


def test_delta_coalesce_matches_jax():
    ops = [("add", 1, 2, 0.5), ("rm", 1, 2), ("rm", 3, 4),
           ("add", 3, 4, 2.0), ("add", 5, 6, 0.25), ("add", 5, 6, 0.75)]
    mine = _delta(GraphDelta, 10, ops).coalesce()
    theirs = _delta(JL.GraphDelta, 10, ops).coalesce()
    assert mine.removed_pairs == theirs.removed_pairs == [(1, 2), (3, 4)]
    assert mine.must_exist == theirs.must_exist == {(1, 2): False,
                                                    (3, 4): True}
    for f in ("add_src", "add_dst", "add_weight"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    d3 = GraphDelta(10).remove_edge(3, 4).remove_edge(3, 4)
    with pytest.raises(KeyError):
        d3.coalesce()


def test_delta_apply_to_matches_jax_and_refuses_missing_edges():
    g, jg = _g(), _g(pkg=JG)
    rng = np.random.default_rng(5)
    ops = _ops(g, rng, n_add=4, n_rm=3) + [("vertex", np.ones(12))]
    out = _delta(GraphDelta, g.n_vertices, ops, 12).apply_to(g)
    jout = _delta(JL.GraphDelta, jg.n_vertices, ops, 12).apply_to(jg)
    assert out.n_vertices == jout.n_vertices == g.n_vertices + 1
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(out, f), getattr(jout, f))
    key = g.src.astype(np.int64) * g.n_vertices + g.dst
    absent = (0, 1)
    while absent[0] * g.n_vertices + absent[1] in key:
        absent = (absent[0], absent[1] + 1)
    d = GraphDelta(g.n_vertices).remove_edge(*absent)
    with pytest.raises(KeyError):
        d.apply_to(g)
    store = GraphVersionStore(_g(), geometry=GEOM)
    with pytest.raises(KeyError):
        store.apply(d)
    assert len(store) == 1


# --------------------------------------------------------------------------- #
# Tile store: equal to JAX's, equal to a cold partition, copy-on-write.
# --------------------------------------------------------------------------- #
def test_tile_store_and_signatures_match_jax():
    rng = np.random.default_rng(11)
    g, jg = _g(seed=4), _g(seed=4, pkg=JG)
    store = GraphVersionStore(g, geometry=GEOM)
    jstore = JL.GraphVersionStore(jg, geometry=JGEOM)
    for k in range(5):
        ops = _ops(g, rng)
        if k == 2:
            ops += [("vertex", None)] * 40      # grows the tile grid
            ops.append(("add", g.n_vertices + 39, 0, 0.5))
        v = store.apply(_delta(GraphDelta, store.head.n_vertices, ops))
        jv = jstore.apply(_delta(JL.GraphDelta, jstore.head.n_vertices,
                                 ops))
        g = v.as_graph()
        s, js = v.store, jv.store
        assert sorted(s.tiles) == sorted(js.tiles)
        for jk in s.tiles:
            assert len(s.tiles[jk]) == len(js.tiles[jk])
            for a, b in zip(s.tiles[jk], js.tiles[jk]):
                np.testing.assert_array_equal(a.cols, b.cols)
                np.testing.assert_array_equal(a.vals, b.vals)
                np.testing.assert_array_equal(a.edge_pos, b.edge_pos)
                assert a.nnz == b.nnz
        assert s.hashes == js.hashes
        assert v.structural_signature == jv.structural_signature
        assert v.content_signature == jv.content_signature
        assert v.stats.as_dict() == jv.stats.as_dict()
        assert v.stats.patched == jv.stats.patched
        assert (s.eid_capacity, s.live_edges, s.next_seq) == \
            (js.eid_capacity, js.live_edges, js.next_seq)
        np.testing.assert_array_equal(s.free_eids, js.free_eids)
        np.testing.assert_array_equal(v.pgraph.inv_in_degree,
                                      jv.pgraph.inv_in_degree)
        assert tile_density_stats(v.pgraph) == \
            JL.tile_density_stats(jv.pgraph)
        assert graph_signature(g) == j_graph_signature(jv.as_graph())
        jcoo = jv.as_graph()
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(g, f), getattr(jcoo, f))
        gd, jgd = as_graph_data(v.pgraph), JL.as_graph_data(jv.pgraph)
        assert set(gd["tiles"]) == set(jgd["tiles"])
        for key, t in gd["tiles"].items():
            for kind, a in t.items():
                np.testing.assert_array_equal(a, jgd["tiles"][key][kind])


def test_incremental_tiles_match_cold_partition():
    rng = np.random.default_rng(11)
    g_ref = _g(seed=4)
    store = GraphVersionStore(g_ref, geometry=GEOM)
    prev = store.head
    for k in range(6):
        d = _delta(GraphDelta, g_ref.n_vertices, _ops(g_ref, rng))
        g_ref = d.apply_to(g_ref)
        v = store.apply(d)
        pg_live, pg_cold = v.pgraph, partition_graph(g_ref, GEOM)
        assert set(pg_live.tiles) == set(pg_cold.tiles)
        for jk in pg_cold.tiles:
            for a, b in zip(pg_live.tiles[jk], pg_cold.tiles[jk]):
                np.testing.assert_array_equal(a.cols, b.cols)
                np.testing.assert_array_equal(a.vals, b.vals)
                np.testing.assert_array_equal(a.edge_pos >= 0,
                                              b.edge_pos >= 0)
                assert a.nnz == b.nnz
        np.testing.assert_array_equal(pg_live.inv_in_degree,
                                      pg_cold.inv_in_degree)
        eids = np.concatenate([t.edge_pos[t.edge_pos >= 0]
                               for ts in pg_live.tiles.values()
                               for t in ts])
        assert eids.shape[0] == np.unique(eids).shape[0]
        assert eids.max() < pg_live.n_edges
        touched = set(_patched_keys(v))
        shared = [jk for jk in pg_live.tiles if jk not in touched]
        assert shared
        for jk in shared:
            assert v.store.tiles[jk] is prev.store.tiles[jk]
        assert v.stats.tiles_retained == len(shared)
        prev = v


def test_eid_reuse_bounds_capacity_under_churn():
    g = _g()
    store = GraphVersionStore(g, geometry=GEOM)
    for r in range(4):
        i = 3 * r
        d = GraphDelta(store.head.n_vertices)
        d.remove_edge(int(g.src[i]), int(g.dst[i]))
        d.add_edge(int(g.src[i]), int(g.dst[i]), float(g.weight[i]))
        g = d.apply_to(g)
        store.apply(d)
    assert store.head.store.eid_capacity == store.head.store.live_edges


def test_content_delta_keeps_cache_key_structural_delta_misses():
    g = _g(seed=7)
    store = GraphVersionStore(g, geometry=GEOM)
    v0 = store.head
    sig0, con0 = v0.structural_signature, v0.content_signature
    i = 9
    d = GraphDelta(g.n_vertices)
    d.remove_edge(int(g.src[i]), int(g.dst[i]))
    d.add_edge(int(g.src[i]), int(g.dst[i]), 123.0)
    v1 = store.apply(d)
    assert v1.structural_signature == sig0
    assert v1.content_signature != con0
    assert graph_signature(v1.as_graph()) == graph_signature(v0.as_graph())
    assert not v1.stats.structural_change
    # a tile emptied by a delta keeps its slice count: content-only
    jk, te = min(v1.store.edges.items(), key=lambda kv: kv[1].n)
    d2 = GraphDelta(v1.n_vertices)
    for u, w_ in zip(te.src.tolist(), te.dst.tolist()):
        d2.remove_edge(u, w_)
    v2 = store.apply(d2)
    assert len(v2.store.tiles[jk]) == len(v1.store.tiles[jk])
    assert all(t.nnz == 0 for t in v2.store.tiles[jk])
    assert v2.structural_signature == sig0
    # a brand-new tile is structural
    d3 = GraphDelta(v2.n_vertices)
    for _ in range(7):
        w = d3.add_vertex()
    d3.add_edge(0, w)
    v3 = store.apply(d3)
    assert v3.stats.tiles_created >= 1 and v3.stats.structural_change
    assert graph_signature(v3.as_graph()) != graph_signature(v2.as_graph())


# --------------------------------------------------------------------------- #
# Incremental serving == cold compile, on every path; == JAX's engine.
# --------------------------------------------------------------------------- #
def _model(name, g, pkg):
    return name if name != "gat-dot" else build_gat_dot(pkg, g)


@pytest.mark.parametrize("name", ["b1", "b3", "b6", "gat-dot"])
def test_incremental_serving_bit_identical_to_cold_and_jax(name):
    rng = np.random.default_rng(23)
    g_ref, jg = _g(seed=1), _g(seed=1, pkg=JG)
    store = GraphVersionStore(g_ref, geometry=GEOM)
    live = LiveGraphServer(store)
    jlive = JL.LiveGraphServer(JL.GraphVersionStore(jg, geometry=JGEOM))
    model, jmodel = _model(name, g_ref, TB), _model(name, jg, JB)
    eng, jeng = _engine(), _jengine()
    x0 = G.random_features(g_ref, seed=2)
    eng.submit(InferenceRequest(model, live, x0))
    for k in range(3):
        ops = _ops(g_ref, rng, n_add=5, n_rm=1)
        if k == 1:
            ops += [("vertex", np.zeros(g_ref.feat_dim, np.float32)),
                    ("add", g_ref.n_vertices,
                     int(rng.integers(0, g_ref.n_vertices)), 0.4)]
        d = _delta(GraphDelta, g_ref.n_vertices, ops, g_ref.feat_dim)
        jlive.apply(_delta(JL.GraphDelta, g_ref.n_vertices, ops,
                           g_ref.feat_dim))
        g_ref = d.apply_to(g_ref)
        live.apply(d)
    x = np.zeros((g_ref.n_vertices, g_ref.feat_dim), np.float32)
    x[:x0.shape[0]] = x0

    cold = _engine()
    y_cold = cold.run(cold.compile(model, g_ref), x)
    resp = eng.submit(InferenceRequest(model, live, x))
    assert resp.cache_hit and eng.stats.compiles == 1
    assert resp.graph_name.endswith("@v3")
    assert torch.equal(resp.output, y_cold)
    prog = eng.compile(model, live)
    assert torch.equal(eng.run(prog, x, residency="host"), y_cold)
    gd = as_graph_data(live.active.pgraph)
    assert torch.equal(eng.run(prog, x, graph_data=gd), y_cold)
    assert eng.stats.compiles == 1

    jy = jeng.submit(JRequest(jmodel, jlive, x)).output
    np.testing.assert_allclose(resp.output.numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)


def test_gat_dot_on_version_with_edge_id_holes():
    """Net removals leave holes in the edge-id space (capacity > live
    edges); SDDMM scores, the edge softmax and the dynamic-weight
    aggregation move through live slots only and never read one."""
    g, jg = _g(seed=5), _g(seed=5, pkg=JG)
    store = GraphVersionStore(g, geometry=GEOM)
    jstore = JL.GraphVersionStore(jg, geometry=JGEOM)
    ops = [("rm", int(g.src[i]), int(g.dst[i])) for i in (3, 40, 41, 200)]
    ops.append(("add", 7, 8, 0.5))
    v = store.apply(_delta(GraphDelta, g.n_vertices, ops))
    jv = jstore.apply(_delta(JL.GraphDelta, g.n_vertices, ops))
    assert v.store.eid_capacity - v.store.live_edges >= 3
    model = build_gat_dot(TB, g)
    eng = _engine()
    eng.compile(model, store.get(0).as_graph())
    x = G.random_features(g, seed=3)
    prog = eng.compile(model, v.as_graph())
    assert eng.stats.compiles == 1
    y = eng.run(prog, x)
    cold = _engine()
    g1 = v.as_graph()
    assert torch.equal(y, cold.run(cold.compile(model, dataclasses.replace(
        g1, name="cold")), x))
    assert torch.equal(eng.run(prog, x, residency="host"), y)
    jeng = _jengine()
    jy = jeng.run(jeng.compile(build_gat_dot(JB, jg), jv.as_graph()), x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_live_run_on_mesh_path_is_refused_until_ported():
    """The mesh path runs live versions now (the twin below); a live run
    that asks for a mesh together with host residency is still refused,
    as JAX refuses it."""
    from repro_torch.launch.mesh import DeviceMesh
    store = GraphVersionStore(_g(), geometry=GEOM)
    live = LiveGraphServer(store)
    eng = _engine()
    prog = eng.compile("b1", live)
    x = G.random_features(store.head.as_graph(), seed=1)
    with pytest.raises(ValueError, match="does not compose"):
        eng.run(prog, x, mesh=DeviceMesh(["cpu"] * 2), graph=live,
                residency="host")
    assert torch.equal(eng.run(prog, x, mesh=1, graph=live),
                       eng.run(prog, x, graph=live))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("model", ["b1", "gat-dot"])
def test_incremental_serving_on_mesh_path(d, model):
    """A content delta served on the mesh path (virtual CPU shards):
    the rebound program stages the patched tiles per mesh device and
    gives a cold compile's bits; JAX's 1-device mesh agrees."""
    from repro_torch.launch.mesh import DeviceMesh
    rng = np.random.default_rng(29)
    g_ref, jg_ref = _g(seed=6), _g(seed=6, pkg=JG)
    store = GraphVersionStore(g_ref, geometry=GEOM)
    jstore = JL.GraphVersionStore(jg_ref, geometry=JGEOM)
    live, jlive = LiveGraphServer(store), JL.LiveGraphServer(jstore)
    mk = (lambda B, g: build_gat_dot(B, g)) if model == "gat-dot" else \
        (lambda B, g: model)
    eng = _engine()
    eng.compile(mk(TB, g_ref), live, mesh=d)
    # Content only: existing pairs re-weighted, one edge removed.
    picks = rng.choice(g_ref.n_edges, 4, replace=False)
    ops = [op for i in picks[:3] for op in (
        ("rm", int(g_ref.src[i]), int(g_ref.dst[i])),
        ("add", int(g_ref.src[i]), int(g_ref.dst[i]),
         float(rng.uniform(0.1, 1.0))))]
    ops.append(("rm", int(g_ref.src[picks[3]]), int(g_ref.dst[picks[3]])))
    live.apply(_delta(GraphDelta, g_ref.n_vertices, ops))
    jlive.apply(_delta(JL.GraphDelta, g_ref.n_vertices, ops))
    g1 = store.head.as_graph()
    x = G.random_features(g1, seed=3)
    prog = eng.compile(mk(TB, g_ref), live, mesh=d)
    y_mesh = eng.run(prog, x, mesh=DeviceMesh(["cpu"] * d))
    assert eng.stats.compiles == 1                 # content delta: a hit
    cold = _engine()
    y_cold = cold.run(cold.compile(mk(TB, g1), dataclasses.replace(
        g1, name="cold")), x)
    assert torch.equal(y_mesh, y_cold)
    assert torch.equal(eng.run(prog, x, graph=live), y_mesh)
    jeng = _jengine()
    jy = jeng.run(jeng.compile(mk(JB, jg_ref), jlive), x, mesh=1)
    np.testing.assert_allclose(y_mesh.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_batched_serving_on_live_version():
    g = _g(seed=9)
    live = LiveGraphServer(GraphVersionStore(g, geometry=GEOM))
    eng = _engine()
    xs = [G.random_features(g, seed=s) for s in (1, 2, 3)]
    resps = eng.submit_batch([InferenceRequest("b1", live, x) for x in xs])
    singles = [eng.submit(InferenceRequest("b1", live, x)) for x in xs]
    for b, s in zip(resps, singles):
        assert torch.equal(b.output, s.output)     # the port's rule: bits
    assert live.snapshot()["inflight"] == {}
    v0g = live.active.as_graph()
    live.apply(GraphDelta(live.n_vertices).add_edge(1, 2, 0.5))
    v1g = live.active.as_graph()
    with pytest.raises(ValueError, match="mix graph versions"):
        eng.submit_batch([InferenceRequest("b1", v0g, xs[0]),
                          InferenceRequest("b1", v1g, xs[1])])


def test_run_with_graph_rebinds_to_the_version():
    g = _g(seed=13)
    live = LiveGraphServer(GraphVersionStore(g, geometry=GEOM))
    eng = _engine()
    prog = eng.compile("b1", live)
    d = GraphDelta(g.n_vertices).add_edge(3, 5, 0.7)
    g1 = d.apply_to(g)
    live.apply(d)
    x = G.random_features(g, seed=4)
    cold = _engine()
    want = cold.run(cold.compile("b1", g1), x)
    assert torch.equal(eng.run(prog, x, graph=live), want)
    assert torch.equal(eng.run_batch(prog, torch.as_tensor(x)[None],
                                     graph=live)[0], want)


# --------------------------------------------------------------------------- #
# Cutover under load.
# --------------------------------------------------------------------------- #
def test_cutover_under_load_zero_dropped_zero_misrouted():
    g = _g(seed=12)
    store = GraphVersionStore(g, geometry=GEOM)
    pool = OverlayPool(n_overlays=2, geometry=GEOM, n_pes=4, device="cpu")
    live = LiveGraphServer(store, metrics=pool.metrics)
    loop = ServeLoop(pool, max_batch=4, max_wait_us=1e9)
    rng = np.random.default_rng(31)
    feats = [G.random_features(g, seed=s) for s in range(4)]
    ref_eng = _engine()
    y_ref = {0: {i: ref_eng.run(ref_eng.compile("b1", store.head.as_graph()),
                                f) for i, f in enumerate(feats)}}
    expected, n = {}, 0
    try:
        for phase in range(3):
            for i in range(6):
                rid = f"p{phase}r{i}"
                loop.submit(InferenceRequest("b1", live, feats[i % 4],
                                             request_id=rid))
                expected[rid] = (live.active.vid, i % 4)
                n += 1
            if phase < 2:
                d = _delta(GraphDelta, g.n_vertices,
                           _ops(g, rng, n_add=2, n_rm=0))
                v = live.apply(d)
                y_ref[v.vid] = {i: ref_eng.run(ref_eng.compile(
                    "b1", v.as_graph()), f) for i, f in enumerate(feats)}
        resps = loop.drain()
    finally:
        loop.shutdown()
    assert len(resps) == n
    by_rid = {r.request_id: r for r in resps}
    for rid, (vid, fi) in expected.items():
        r = by_rid[rid]
        assert r.graph_name.endswith(f"@v{vid}")
        assert torch.equal(r.output, y_ref[vid][fi]), rid
    assert sorted(store.versions()) == [live.active.vid]
    assert live.reclaimed == [0, 1] and live.cutovers == 2
    assert sum(e.stats.compiles for e in pool.engines) == 1
    lg = pool.metrics.snapshot(max_batch=4)["livegraph"]
    assert lg["active_version"] == live.active.vid
    assert lg["cutovers"] == 2 and lg["versions_reclaimed"] == 2
    assert sum(lg["requests_per_version"].values()) == n


def test_metrics_without_live_graphs_have_no_livegraph_section():
    assert "livegraph" not in Metrics().snapshot()


# --------------------------------------------------------------------------- #
# Staging: a version uploads and pins only its patched tiles.
# --------------------------------------------------------------------------- #
def test_staging_counts_only_patched_tiles():
    g = G.random_graph(150, 900, seed=8, degree="powerlaw",
                       dedupe=True).gcn_normalized()
    g.feat_dim, g.n_classes = 12, 4
    store = GraphVersionStore(g, geometry=GEOM)
    eng = _engine()
    x = G.random_features(g, seed=1)
    v0 = store.head
    eng.run(eng.compile("b6", v0.as_graph()), x)          # reads the mask
    eng.run(eng.compile("b6", v0.as_graph()), x, residency="host")
    st0 = _staged(v0.pgraph, CPU)
    ht0 = _host_tiles(v0.pgraph, False)
    kinds, host_kinds = st0.kinds(), sorted(ht0._rows)
    assert "cols" in kinds and "cols" in host_kinds
    rng = np.random.default_rng(2)
    v1 = store.apply(_delta(GraphDelta, g.n_vertices,
                            _ops(g, rng, n_add=3, n_rm=2)))
    patched = _patched_keys(v1)
    assert 0 < len(patched) < len(v1.pgraph.tiles)
    st1 = _staged(v1.pgraph, CPU)          # made when v1 was applied
    inv = v1.pgraph.inv_in_degree.nbytes
    assert st1.uploaded == inv
    y1 = eng.run(eng.compile("b6", v1.as_graph()), x)
    want = inv + sum(_kind_bytes(t, kind) for jk in patched
                     for t in v1.pgraph.tiles[jk] for kind in kinds)
    assert st1.kinds() == kinds and st1.uploaded == want
    # untouched tiles are the parent's device tensors
    jk = next(k for k in v1.pgraph.tiles if k not in patched)
    assert st1.tiles("cols")[(*jk, 0)] is st0.tiles("cols")[(*jk, 0)]

    assert torch.equal(eng.run(eng.compile("b6", v1.as_graph()), x,
                               residency="host"), y1)
    ht1 = _host_tiles(v1.pgraph, False)
    rows = sorted({j for j, _ in patched})
    a = 16
    want_host = sum(
        (_kind_bytes(t, kind) // KIND_BYTES[kind][0] + a - 1) // a * a
        * KIND_BYTES[kind][0]
        for j in rows for (jj, k), ts in v1.pgraph.tiles.items() if jj == j
        for t in ts for kind in host_kinds)
    assert ht1.nbytes == want_host
    j_shared = next((j for j in range(v1.pgraph.n_blocks) if j not in rows),
                    None)
    if j_shared is not None:
        assert ht1.row("cols", j_shared)[0] is ht0.row("cols", j_shared)[0]


def _entries_of(share, *versions) -> int:
    """Share entries made from the tiles of ``versions`` (other tests'
    graphs may hold entries of their own in the same process)."""
    ids = {id(t) for v in versions for ts in v.pgraph.tiles.values()
           for t in ts}
    return sum(all(id(t) in ids for t in e[0])
               for e in list(share._entries.values()))


def test_reclaim_frees_own_tiles_and_keeps_shared_ones():
    g = _g(seed=21)
    store = GraphVersionStore(g, geometry=GEOM)
    live = LiveGraphServer(store)
    eng = _engine()
    x = G.random_features(g, seed=1)
    share = _tile_share(str(CPU))
    eng.submit(InferenceRequest("b1", live, x))
    v0 = store.head
    n0 = 3 * sum(len(ts) for ts in v0.pgraph.tiles.values())
    assert _entries_of(share, v0) == n0          # cols, vals, row_len
    d = GraphDelta(g.n_vertices).add_edge(0, 1, 0.5).add_edge(40, 70, 0.5)
    v1 = live.apply(d)                      # v0 idle: reclaimed at once
    assert live.reclaimed == [0] and "_staged" not in v0.pgraph.__dict__
    own = 3 * sum(len(v0.pgraph.tiles[jk]) for jk in _patched_keys(v1))
    assert own > 0
    assert _entries_of(share, v0, v1) == n0 - own
    eng.submit(InferenceRequest("b1", live, x))     # v1 stages its own
    assert _entries_of(share, v0, v1) == n0
    cold = _engine()
    g1 = v1.as_graph()
    assert torch.equal(eng.submit(InferenceRequest("b1", live, x)).output,
                       cold.run(cold.compile("b1", dataclasses.replace(
                           g1, name="cold")), x))
    v2 = live.apply(GraphDelta(v1.n_vertices).add_edge(2, 3, 0.5))
    assert live.reclaimed == [0, 1]
    v2.release_bindings()
    assert _entries_of(share, v0, v1, v2) == 0


# --------------------------------------------------------------------------- #
# Satellites: CSR token, manifest tile stats, geometry, block growth.
# --------------------------------------------------------------------------- #
def test_in_csr_mutation_token_invalidates():
    g = _g()
    csr0 = g.in_csr()
    assert g.in_csr() is csr0
    g.src[0] = (g.src[0] + 1) % g.n_vertices
    assert g.in_csr() is csr0
    assert g.invalidate_views() == 1
    assert g.in_csr() is not csr0


def test_graph_signature_tracks_mutation_token():
    g = _g()
    s0 = graph_signature(g)
    g.weight[0] += 1.0
    assert graph_signature(g) == s0
    g.invalidate_views()
    assert graph_signature(g) != s0


def test_manifest_tile_stats_present_and_rebind_refreshes(tmp_path):
    g = _g(seed=2)
    eng = _engine()
    prog = eng.compile("b1", g)
    ts = prog.manifest["tile_stats"]
    assert ts == tile_density_stats(prog.pgraph)
    assert ts["total_nnz"] == prog.pgraph.total_nnz()
    path = str(tmp_path / "live.gagi")
    prog.save(path)
    assert eng.load(path).manifest["tile_stats"] == ts
    live = LiveGraphServer(GraphVersionStore(g, geometry=GEOM))
    eng.submit(InferenceRequest("b1", live, G.random_features(g, seed=1)))
    live.apply(GraphDelta(g.n_vertices).add_edge(0, 1, 0.5)
               .add_edge(2, 3, 0.5))
    bound = eng.compile("b1", live)
    assert bound.manifest["graph_version"] == 1
    assert bound.manifest["tile_stats"]["total_nnz"] == ts["total_nnz"] + 2
    assert bound.manifest["graph_name"].endswith("@v1")
    assert "content_signature" in bound.manifest
    assert "graph_version" not in prog.manifest


def test_version_bind_refuses_geometry_mismatch():
    g = _g()
    store = GraphVersionStore(g, geometry=GEOM)
    other = Engine(geometry=PartitionConfig(n1=64, n2=8), n_pes=4,
                   device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        store.head.bind(other.compile("b1", g))


def test_block_growth_changes_structure_and_stays_correct():
    g = _g(nv=60, ne=260, seed=15)
    store = GraphVersionStore(g, geometry=GEOM)
    live = LiveGraphServer(store)
    eng = _engine()
    eng.compile("b1", live)
    nb0 = store.head.pgraph.n_blocks
    d = GraphDelta(g.n_vertices, feat_dim=g.feat_dim)
    first = d.add_vertex()
    for _ in range(GEOM.n1):
        d.add_vertex()
    d.add_edge(first, 0, 1.0)
    g_ref = d.apply_to(g)
    v = live.apply(d)
    assert v.pgraph.n_blocks == nb0 + 1 and v.stats.structural_change
    x = G.random_features(g_ref, seed=8)
    resp = eng.submit(InferenceRequest("b1", live, x))
    assert not resp.cache_hit and eng.stats.compiles == 2
    cold = _engine()
    assert torch.equal(resp.output,
                       cold.run(cold.compile("b1", g_ref), x))


def test_a_version_inherits_through_an_unstaged_parent():
    """v1 and v2 applied back to back, v1 never run: v2 still holds v0's
    copies of the tiles it shares with it, so retiring v0 and v1 frees
    only the tiles v2 does not hold."""
    g = _g(seed=25)
    store = GraphVersionStore(g, geometry=GEOM)
    live = LiveGraphServer(store)
    eng = _engine()
    x = G.random_features(g, seed=1)
    eng.submit(InferenceRequest("b1", live, x))
    v0 = store.head
    rng = np.random.default_rng(4)
    v1 = store.apply(_delta(GraphDelta, g.n_vertices, _ops(g, rng)))
    v2 = store.apply(_delta(GraphDelta, g.n_vertices,
                            _ops(v1.as_graph(), rng)))
    live.cutover(v2)                         # v0 reclaimed, v1 never ran
    assert store.drop(1) and live.reclaimed == [0]
    share = _tile_share(str(CPU))
    kept = 3 * sum(1 for ts in v2.pgraph.tiles.values() for t in ts
                   if any(t is u for us in v0.pgraph.tiles.values()
                          for u in us))
    assert kept > 0 and _entries_of(share, v0, v1, v2) == kept
    st2 = _staged(v2.pgraph, CPU)
    eng.submit(InferenceRequest("b1", live, x))
    own = sum(_kind_bytes(t, kind) for ts in v2.pgraph.tiles.values()
              for t in ts if not any(t is u for us in v0.pgraph.tiles
                                     .values() for u in us)
              for kind in ("cols", "row_len", "vals"))
    assert st2.uploaded == v2.pgraph.inv_in_degree.nbytes + own
