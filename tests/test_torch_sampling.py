"""The port's mini-batch sampling layer and graph-as-data execution on
device="cpu".

A twin of ``tests/test_sampling.py`` over ``repro_torch.sampling`` and the
port's Engine, plus parity with the JAX package:

  * the copied CSR, sampler, bucket and layout functions give JAX's arrays
    exactly on the same numpy inputs;
  * padded (bucketed, graph-as-data) execution equals the unpadded
    subgraph run bit for bit in the port for b1 (GCN), b6 (GAT) and b3
    (SAGE), on both ACK backends, and is within rtol 2e-4 / atol 2e-5 of
    JAX's padded run;
  * batched bucketed lanes equal single runs bit for bit (the port's rule,
    stronger than JAX's 1e-5);
  * mixed topology sources, ``residency="host"`` with ``graph_data`` and
    malformed ``graph_data`` (out-of-range columns or edge ids, a missing
    or extra tile key, a wrong tile shape, a short ``inv_in_degree``) are
    refused;
  * the service reaches a program-cache hit rate >= 0.9 on power-law
    traffic, ``warm`` compiles its buckets, and results are deterministic
    across cache states.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_models import build_gat_dot  # noqa: E402
from repro import sampling as JS  # noqa: E402
from repro.core import gnn_builders as JB  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import InferenceRequest as JRequest  # noqa: E402
from repro.engine import stack_graph_data as j_stack  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import (Engine, InferenceRequest,  # noqa: E402
                                stack_graph_data)
from repro_torch.sampling import (SamplingService, TargetRequest,  # noqa
                                  bucket_for, build_csr, in_csr,
                                  layout_graph, sample_ego, template_graph)

GEOM = PartitionConfig(n1=32, n2=8)
JGEOM = JPC(n1=32, n2=8)
RTOL, ATOL = 2e-4, 2e-5


def _parent(nv=400, ne=2400, f=16, c=4, seed=3, pkg=G):
    g = pkg.random_graph(nv, ne, seed=seed, degree="powerlaw", dedupe=True)
    g.feat_dim, g.n_classes = f, c
    return g


def _engine(**kw) -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu", **kw)


def _jengine() -> JEngine:
    return JEngine(geometry=JGEOM, n_pes=4, verify=False)


def _same_graph(a, b):
    for field in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.n_vertices, a.feat_dim, a.n_classes, a.name) == \
        (b.n_vertices, b.feat_dim, b.n_classes, b.name)


# --------------------------------------------------------------------------- #
# CSR view + graph satellites.
# --------------------------------------------------------------------------- #
def test_csr_matches_coo_and_is_memoized():
    g = _parent()
    csr = g.in_csr()
    assert csr is g.in_csr()                    # memo: same object
    indeg = np.bincount(g.dst, minlength=g.n_vertices)
    assert np.array_equal(np.diff(csr.indptr), indeg)
    for v in (0, 7, g.n_vertices - 1):
        srcs, ws, eids = csr.in_neighbors(v)
        assert np.all(g.dst[eids] == v)
        assert np.array_equal(g.src[eids], srcs)
        assert np.array_equal(g.weight[eids], ws)
        assert np.all(np.diff(srcs) >= 0)       # src-sorted runs
    g2 = g.with_self_loops()                    # rebinding => fresh CSR
    assert g2.in_csr().n_edges == g.n_edges + g.n_vertices
    g.invalidate_views()                        # in-place mutation token
    assert g.in_csr() is not csr


def test_csr_equals_jax():
    gt, gj = _parent(), _parent(pkg=JG)
    _same_graph(gt, gj)
    a, b = build_csr(gt), JS.build_csr(gj)
    for field in ("indptr", "src", "weight", "edge_id"):
        got, want = getattr(a, field), getattr(b, field)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert a.max_in_degree() == b.max_in_degree()


def test_random_graph_alpha_and_dedupe():
    flat = G.random_graph(300, 3000, seed=5, degree="powerlaw", alpha=0.3)
    steep = G.random_graph(300, 3000, seed=5, degree="powerlaw", alpha=2.0)
    assert steep.in_degree().max() > flat.in_degree().max()

    gd = G.random_graph(50, 2000, seed=5, degree="powerlaw", dedupe=True)
    pairs = set(zip(gd.src.tolist(), gd.dst.tolist()))
    assert len(pairs) == gd.n_edges             # no duplicate edges
    assert float(gd.weight.sum()) == 2000.0     # multiplicity preserved


# --------------------------------------------------------------------------- #
# Sampler.
# --------------------------------------------------------------------------- #
def test_sampler_deterministic_targets_first_and_caps():
    g = _parent()
    a = sample_ego(g, [5, 9, 77], (6, 4), seed=11)
    b = sample_ego(g, [5, 9, 77], (6, 4), seed=11)
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.graph.src, b.graph.src)
    assert np.array_equal(a.graph.dst, b.graph.dst)
    assert np.array_equal(a.targets, np.arange(3))
    assert np.array_equal(a.vertices[:3], [5, 9, 77])
    assert [len(h) for h in a.hops][0] == 3

    indeg = np.bincount(a.graph.dst, minlength=a.graph.n_vertices)
    for hop, cap in zip(a.hops, (6, 4)):
        assert np.all(indeg[hop] <= cap)
    assert np.all(indeg[a.hops[-1]] == 0)

    c = sample_ego(g, [5, 9, 77], (6, 4), seed=12)
    assert not (np.array_equal(a.vertices, c.vertices)
                and np.array_equal(a.graph.src, c.graph.src))


@pytest.mark.parametrize("targets,fanouts,seed", [
    ([5, 9, 77], (6, 4), 11), ([3], ("full",), 0), ([1, 2, 3, 4], (3,), 7),
    ([0, 399], (25, 10), 2)])
def test_sampler_equals_jax(targets, fanouts, seed):
    gt, gj = _parent(), _parent(pkg=JG)
    a = sample_ego(gt, targets, fanouts, seed=seed)
    b = JS.sample_ego(gj, targets, fanouts, seed=seed)
    _same_graph(a.graph, b.graph)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.targets, b.targets)
    assert len(a.hops) == len(b.hops)
    for x, y in zip(a.hops, b.hops):
        np.testing.assert_array_equal(x, y)


def test_sampler_full_fallback_keeps_every_in_edge():
    g = _parent()
    ego = sample_ego(g, [3], ("full",), seed=0)
    assert ego.graph.n_edges == in_csr(g).in_degree(3)


def test_sampler_rejects_bad_targets():
    g = _parent()
    with pytest.raises(ValueError):
        sample_ego(g, [], (4,))
    with pytest.raises(ValueError):
        sample_ego(g, [1, 1], (4,))
    with pytest.raises(ValueError):
        sample_ego(g, [g.n_vertices], (4,))
    with pytest.raises(ValueError):
        sample_ego(g, [0], (0,))


# --------------------------------------------------------------------------- #
# Buckets: canonical template layout.
# --------------------------------------------------------------------------- #
def test_template_partitions_to_canonical_layout():
    from repro_torch.core.passes.partition import partition_graph
    g = _parent()
    sub = sample_ego(g, [5, 9, 77], (6, 4), seed=11).graph.gcn_normalized()
    bucket = bucket_for(sub, GEOM)
    for field in (bucket.n_vertices, bucket.n_edges, bucket.width):
        assert field & (field - 1) == 0          # powers of two
    tpl = template_graph(bucket, GEOM)
    pg = partition_graph(tpl, GEOM)
    nb = bucket.n_blocks(GEOM.n1)
    assert set(pg.tiles) == {(j, k) for j in range(nb) for k in range(nb)}
    assert all(len(ts) == 1 and ts[0].width == bucket.width
               for ts in pg.tiles.values())
    assert pg.n_edges == bucket.n_edges


@pytest.mark.parametrize("targets,fanouts,seed", [
    ([5, 9, 77], (6, 4), 11), ([5], (2,), 0), ([10, 20, 30, 40], (8, 8), 3)])
def test_buckets_and_layout_equal_jax(targets, fanouts, seed):
    gt, gj = _parent(), _parent(pkg=JG)
    st = sample_ego(gt, targets, fanouts, seed=seed).graph.gcn_normalized()
    sj = JS.sample_ego(gj, targets, fanouts, seed=seed).graph.gcn_normalized()
    bt, bj = bucket_for(st, GEOM), JS.bucket_for(sj, JGEOM)
    assert dataclasses.asdict(bt) == dataclasses.asdict(bj)
    assert bt.key == bj.key
    _same_graph(template_graph(bt, GEOM), JS.template_graph(bj, JGEOM))
    lt, lj = layout_graph(st, bt, GEOM), JS.layout_graph(sj, bj, JGEOM)
    assert set(lt["tiles"]) == set(lj["tiles"])
    for key, tile in lt["tiles"].items():
        assert set(tile) == set(lj["tiles"][key])
        for kind, a in tile.items():
            b = lj["tiles"][key][kind]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(lt["inv_in_degree"],
                                  lj["inv_in_degree"])


def test_layout_rejects_oversized_graph():
    g = _parent()
    small = sample_ego(g, [5], (2,), seed=0).graph
    bucket = bucket_for(small, GEOM)
    big = sample_ego(g, [5, 9, 77, 100, 200], (8, 8), seed=0).graph
    with pytest.raises(ValueError):
        layout_graph(big.gcn_normalized(), bucket, GEOM)


def test_stack_graph_data_equals_jax_and_zero_lanes_are_inert():
    g = _parent(nv=400, ne=24000)
    X = G.random_features(g, seed=1)
    reqs = [_bucketed_pair(g, "b1", [5 + i, 90 + i], (6, 4), seed=11 + i,
                           X=X)[1] for i in range(3)]
    gds = [r.graph_data for r in reqs]
    mine, theirs = stack_graph_data(gds, 4), j_stack(gds, 4)
    for key, tile in mine["tiles"].items():
        for kind, a in tile.items():
            assert a.shape[0] == 4
            np.testing.assert_array_equal(
                a, np.asarray(theirs["tiles"][key][kind]))
    np.testing.assert_array_equal(mine["inv_in_degree"],
                                  np.asarray(theirs["inv_in_degree"]))
    # The zero-filled fourth lane computes on an empty graph: it does not
    # touch the real lanes, which equal their single runs bit for bit.
    eng = _engine()
    prog = eng.compile("b1", reqs[0].graph)
    xs = np.stack([r.features for r in reqs] + [reqs[0].features])
    ys = eng.run_batch(prog, xs, graph_data=mine)
    for n, r in enumerate(reqs):
        assert torch.equal(ys[n], eng.run(prog, r.features,
                                          graph_data=r.graph_data))
    empty = {"tiles": {k: {kind: np.zeros_like(a) for kind, a in t.items()}
                       for k, t in gds[0]["tiles"].items()},
             "inv_in_degree": np.zeros_like(gds[0]["inv_in_degree"])}
    assert torch.equal(ys[3], eng.run(prog, xs[3], graph_data=empty))


# --------------------------------------------------------------------------- #
# Padding inertness through the engine: bucketed graph-as-data execution
# equals the unpadded subgraph run bit for bit.
# --------------------------------------------------------------------------- #
def _bucketed_pair(g, model, targets, fanouts, seed, X=None):
    X = G.random_features(g, seed=1) if X is None else X
    ego = sample_ego(g, targets, fanouts, seed=seed)
    sub = ego.graph.gcn_normalized()
    bucket = bucket_for(sub, GEOM)
    tpl = template_graph(bucket, GEOM)
    gd = layout_graph(sub, bucket, GEOM)
    x_sub = X[ego.vertices]
    x_pad = np.zeros((bucket.n_vertices, g.feat_dim), np.float32)
    x_pad[: x_sub.shape[0]] = x_sub
    unpadded = InferenceRequest(model=model, graph=sub, features=x_sub)
    bucketed = InferenceRequest(model=model, graph=tpl, features=x_pad,
                                graph_data=gd)
    return unpadded, bucketed, ego


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("model", ["b1", "b6", "b3"])  # GCN, GAT, SAGE
def test_padded_execution_is_bit_identical(model, backend):
    g = _parent()
    unpadded, bucketed, ego = _bucketed_pair(
        g, model, [5, 9, 77], (6, 4), seed=11)
    eng = _engine(backend=backend)
    y_ref = eng.submit(unpadded).output
    y_bkt = eng.submit(bucketed).output
    # every real vertex row — not just the targets — is exact
    assert torch.equal(y_bkt[: y_ref.shape[0]], y_ref)
    assert eng.exec_stats.h2d_bytes > 0
    # ... and JAX's padded run of the same request agrees
    je = _jengine()
    gj = _parent(pkg=JG)
    jb = _jax_bucketed(gj, model, [5, 9, 77], (6, 4), seed=11)
    y_jax = np.asarray(je.submit(jb).output)
    np.testing.assert_allclose(y_bkt.numpy(), y_jax, rtol=RTOL, atol=ATOL)


def _jax_bucketed(g, model, targets, fanouts, seed):
    """JAX's bucketed request for the same sample (``model`` a name or a
    builder taking the builder module and the graph)."""
    X = JG.random_features(g, seed=1)
    ego = JS.sample_ego(g, targets, fanouts, seed=seed)
    sub = ego.graph.gcn_normalized()
    bucket = JS.bucket_for(sub, JGEOM)
    gd = JS.layout_graph(sub, bucket, JGEOM)
    x_pad = np.zeros((bucket.n_vertices, g.feat_dim), np.float32)
    x_pad[: ego.vertices.shape[0]] = X[ego.vertices]
    model = model(JB, g) if callable(model) else model
    return JRequest(model=model, graph=JS.template_graph(bucket, JGEOM),
                    features=jnp.asarray(x_pad), graph_data=gd)


@pytest.mark.parametrize("lrelu", [True, False])
def test_padded_gat_dot_is_bit_identical(lrelu):
    """Dot-mode SDDMM scores, the edge softmax (standalone, or fused into
    the scoring layer) and the dynamic-weight aggregation, each lane on
    its own tiles; with the LeakyReLU also JAX's padded run agrees (JAX
    cannot run the fused form)."""
    g = _parent()
    X = G.random_features(g, seed=1)
    ego = sample_ego(g, [5, 9, 77], (6, 4), seed=11)
    sub = ego.graph.gcn_normalized()
    bucket = bucket_for(sub, GEOM)
    tpl = template_graph(bucket, GEOM)
    x_pad = np.zeros((bucket.n_vertices, g.feat_dim), np.float32)
    x_pad[: ego.vertices.shape[0]] = X[ego.vertices]
    eng = _engine(backend="cuda")
    # one model for both graphs (same feat_dim / n_classes)
    model = build_gat_dot(TB, sub, hidden=8, lrelu=lrelu)
    y_ref = eng.run(eng.compile(model, sub), X[ego.vertices])
    y_bkt = eng.run(eng.compile(model, tpl), x_pad,
                    graph_data=layout_graph(sub, bucket, GEOM))
    assert torch.equal(y_bkt[: y_ref.shape[0]], y_ref)
    if lrelu:
        jb = _jax_bucketed(
            _parent(pkg=JG),
            lambda B, gg: build_gat_dot(B, gg, hidden=8), [5, 9, 77],
            (6, 4), seed=11)
        y_jax = np.asarray(_jengine().submit(jb).output)
        np.testing.assert_allclose(y_bkt.numpy(), y_jax, rtol=RTOL,
                                   atol=ATOL)


def test_bucket_cache_key_collides_across_users():
    g = _parent()
    eng = _engine()
    keys = set()
    for seed in (11, 12, 13):
        _, bucketed, _ = _bucketed_pair(g, "b1", [5, 9, 77], (6, 4),
                                        seed=seed)
        keys.add(eng.cache_key(bucketed.model, bucketed.graph))
    assert len(keys) == 1        # different subgraphs, one program


@pytest.mark.parametrize("model", ["b1", "b6"])
def test_batched_bucketed_equals_single(model):
    # dense parent: fanout-saturated sampling keeps every user's ego
    # network in one geometry bucket (asserted below)
    g = _parent(nv=400, ne=24000)
    eng = _engine(backend="cuda")
    reqs = []
    for i, seed in enumerate((11, 12, 13)):
        _, bucketed, _ = _bucketed_pair(g, model, [5 + i, 90 + i], (6, 4),
                                        seed=seed)
        bucketed.request_id = f"r{i}"
        reqs.append(bucketed)
    assert len({eng.cache_key(r.model, r.graph) for r in reqs}) == 1
    singles = [eng.submit(r).output for r in reqs]
    batched = eng.submit_batch(reqs)
    assert all(r.batch_size == 3 for r in batched)
    for got, want in zip(batched, singles):
        assert torch.equal(got.output, want)       # bit for bit


def test_forced_gemm_bucket_program_runs_per_lane():
    """A remapped bucket program densifies each lane's own tiles (no
    block cache across lanes): lanes equal singles bit for bit, and the
    GEMM path agrees with the SpDMM one within the remap tests' 1e-4."""
    g = _parent(nv=400, ne=24000)
    eng = _engine(backend="cuda")
    reqs = [_bucketed_pair(g, "b1", [5 + i, 90 + i], (6, 4), seed=11 + i)[1]
            for i in range(2)]
    prog = eng.compile("b1", reqs[0].graph)
    rp = eng.remap(prog, force="gemm")
    xs = np.stack([r.features for r in reqs])
    gd = stack_graph_data([r.graph_data for r in reqs], 2)
    ys = eng.run_batch(rp, xs, graph_data=gd)
    assert eng.exec_stats.tiles_remapped > 0
    for n, r in enumerate(reqs):
        assert torch.equal(ys[n], eng.run(rp, r.features,
                                          graph_data=r.graph_data))
        np.testing.assert_allclose(
            ys[n].numpy(), eng.run(prog, r.features,
                                   graph_data=r.graph_data).numpy(),
            rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# Refusals.
# --------------------------------------------------------------------------- #
def test_submit_batch_rejects_mixed_topology_sources():
    g = _parent()
    eng = _engine()
    _, bucketed, _ = _bucketed_pair(g, "b1", [5], (4,), seed=1)
    baked = InferenceRequest(model="b1", graph=bucketed.graph,
                             features=bucketed.features)
    with pytest.raises(ValueError, match="mix"):
        eng.submit_batch([bucketed, baked])


def _bad(gd, what):
    gd = {"tiles": {k: dict(t) for k, t in gd["tiles"].items()},
          "inv_in_degree": gd["inv_in_degree"]}
    key = sorted(gd["tiles"])[-1]
    tile = gd["tiles"][key]
    if what == "cols":
        tile["cols"] = tile["cols"].copy()
        tile["cols"][0, 0] = GEOM.n1            # one past the block
    elif what == "negative cols":
        tile["cols"] = tile["cols"].copy()
        tile["cols"][-1, -1] = -1
    elif what == "epos":
        tile["mask"], tile["epos"] = tile["mask"].copy(), tile["epos"].copy()
        tile["mask"][0, 0], tile["epos"][0, 0] = True, 10 ** 6
    elif what == "missing key":
        del gd["tiles"][key]
    elif what == "extra key":
        gd["tiles"]["99:0:0"] = tile
    elif what == "missing kind":
        del tile["epos"]
    elif what == "shape":
        tile["vals"] = tile["vals"][:, :-1]
    elif what == "inv_in_degree":
        gd["inv_in_degree"] = gd["inv_in_degree"][:-1]
    return gd


@pytest.mark.parametrize("what", ["cols", "negative cols", "epos",
                                  "missing key", "extra key",
                                  "missing kind", "shape",
                                  "inv_in_degree"])
def test_malformed_graph_data_is_refused(what):
    g = _parent()
    _, bucketed, _ = _bucketed_pair(g, "b6", [5, 9, 77], (6, 4), seed=11)
    eng = _engine(backend="cuda")
    prog = eng.compile("b6", bucketed.graph)
    bad = _bad(bucketed.graph_data, what)
    with pytest.raises(ValueError, match="graph_data"):
        eng.run(prog, bucketed.features, graph_data=bad)
    with pytest.raises(ValueError, match="graph_data"):
        eng.submit_batch([bucketed, dataclasses.replace(bucketed,
                                                        graph_data=bad)])
    assert eng.exec_stats.runs == 0          # no pass began


def test_host_residency_with_graph_data_is_refused():
    g = _parent()
    _, bucketed, _ = _bucketed_pair(g, "b1", [5, 9, 77], (6, 4), seed=11)
    eng = _engine()
    prog = eng.compile("b1", bucketed.graph)
    with pytest.raises(ValueError, match="device-resident only"):
        eng.run(prog, bucketed.features, graph_data=bucketed.graph_data,
                residency="host")
    with pytest.raises(ValueError, match="device-resident only"):
        eng.run_batch(prog, np.stack([bucketed.features]),
                      graph_data=stack_graph_data([bucketed.graph_data], 1),
                      residency="host")
    host = eng.compile("b1", bucketed.graph, residency="host")
    with pytest.raises(ValueError, match="device-resident only"):
        eng.run(host, bucketed.features, graph_data=bucketed.graph_data)


# --------------------------------------------------------------------------- #
# SamplingService: pool-integrated per-user serving (acceptance).
# --------------------------------------------------------------------------- #
def test_service_hit_rate_on_power_law_traffic():
    """Mixed target counts + fanouts on an RE-class power-law graph:
    bucketing collapses the request stream onto few programs, so the
    pool's program-cache hit rate reaches >= 0.9 after warmup."""
    g = _parent(nv=466, ne=60000, f=16, c=5, seed=1)
    X = G.random_features(g, seed=2)
    svc = SamplingService(g, X, n_overlays=2, geometry=GEOM, n_pes=4,
                          device="cpu", max_batch=4, max_wait_us=1e6)
    rng = np.random.default_rng(0)

    def mk(i):
        t = rng.choice(g.n_vertices, size=int(rng.integers(1, 4)),
                       replace=False)
        fan = [(6, 4), (4, 2), (6, 2)][i % 3]
        return TargetRequest(targets=[int(v) for v in t], model="b1",
                             fanouts=fan, request_id=f"u{i}",
                             seed=100 + i)

    try:
        svc.serve([mk(i) for i in range(12)])           # warmup
        h0 = sum(e.stats.cache_hits for e in svc.pool.engines)
        n0 = sum(e.stats.requests for e in svc.pool.engines)
        resps = svc.serve([mk(i) for i in range(12, 44)])
        h1 = sum(e.stats.cache_hits for e in svc.pool.engines)
        n1 = sum(e.stats.requests for e in svc.pool.engines)

        assert (h1 - h0) / (n1 - n0) >= 0.9             # acceptance
        assert [r.request_id for r in resps] == \
            [f"u{i}" for i in range(12, 44)]
        assert all(r.logits.shape == (len(r.targets), g.n_classes)
                   for r in resps)
        assert max(r.batch_size for r in resps) > 1     # coalescing real
        snap = svc.stats_snapshot()
        assert snap["distinct_buckets"] < 10
    finally:
        svc.shutdown()


def test_service_warm_precompiles_buckets():
    """After ``warm()`` every same-bucket request is a program-cache
    hit — the steady-state contract the GPU smoke run relies on."""
    g = _parent(nv=400, ne=24000)
    X = G.random_features(g, seed=2)
    svc = SamplingService(g, X, n_overlays=1, geometry=GEOM, n_pes=4,
                          device="cpu", max_batch=4, max_wait_us=1e6)
    try:
        warmed = svc.warm([TargetRequest(targets=[5, 9], fanouts=(6, 4),
                                         seed=1)])
        assert warmed == 1
        assert svc.bucket_counts == {}          # warm-up is not counted
        resps = svc.serve([
            TargetRequest(targets=[10 + i, 200 + i], fanouts=(6, 4),
                          seed=50 + i, request_id=f"w{i}")
            for i in range(4)])
        assert all(r.cache_hit for r in resps)
    finally:
        svc.shutdown()


def test_service_is_deterministic_across_cache_states():
    """The same TargetRequest answered on a cold engine (compile) and on
    a warm one (cached program) yields identical logits, which equal the
    unpadded subgraph's rows served through Engine.submit."""
    g = _parent()
    X = G.random_features(g, seed=2)
    req = TargetRequest(targets=[5, 9], model="b1", fanouts=(6, 4),
                        seed=7)
    svc = SamplingService(g, X, n_overlays=1, geometry=GEOM, n_pes=4,
                          device="cpu", max_batch=1, max_wait_us=1e6)
    try:
        cold = svc.submit(req)
        warm = svc.submit(req)
        assert not cold.cache_hit and warm.cache_hit
        assert torch.equal(cold.logits, warm.logits)
        assert np.array_equal(cold.targets, [5, 9])
        ego = sample_ego(g, [5, 9], (6, 4), seed=7)
        y = _engine().submit(InferenceRequest(
            "b1", ego.graph.gcn_normalized(), X[ego.vertices])).output
        assert torch.equal(warm.logits, y[:2])
    finally:
        svc.shutdown()
