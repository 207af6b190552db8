"""The port's sparsity-adaptive kernel remapping on the CPU.

A twin of ``tests/test_remap.py``: the
remapped encoding is self-describing (forced SpDMM restores the canonical
bytes, forced GEMM round-trips), a forced-GEMM binary runs with the same
bits on both of the port's residency paths, auto remap restricted to
spdmm/skip is bit-exact, MAX/MIN layers keep SpDMM, skip-empty elision
equals a cold compile of the drained graph, and the density sources and
calibrated constants behave as in the JAX package.  Live graphs: a
delta that drains a tile serves a skip-empty remapped program bit for bit
like a cold compile, and a rebind re-prices only the tiles the delta
patched (records and binary words equal to JAX's rebind).  Verify passes
remapped programs and bundles and catches a tampered record or a GEMM
with no record.  Against the JAX package (rtol 2e-4 / atol 2e-5):
forced-GEMM runs, ``densify_tile`` and ``ACK.gemm_agg`` (with a row that
holds one column twice), and the per-tile ``exec_profile``.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ack as jack  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro import livegraph as JL  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch.core import ack as tack  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.ir import AggOp  # noqa: E402
from repro_torch.core.isa import (HEADER_BYTES, Instr,  # noqa: E402
                                  Opcode, disassemble)
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.core.passes.remap import (_scan_groups,  # noqa: E402
                                           remap_program, resolve_density)
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.livegraph import GraphDelta, GraphVersionStore  # noqa: E402
from repro_torch.verify import verify_gagi, verify_program  # noqa: E402

GEOM = PartitionConfig(n1=32, n2=8)
RTOL, ATOL = 2e-4, 2e-5


def _g(nv=90, ne=400, f=12, c=4, seed=0, pkg=G):
    g = pkg.random_graph(nv, ne, seed=seed).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _engine(**kw) -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu", **kw)


def _jengine() -> JEngine:
    return JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)


# --------------------------------------------------------------------------- #
# Restore round-trip: the remapped encoding is self-describing.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["b1", "b2", "b3", "b4", "b6", "b7"])
def test_forced_spdmm_restores_canonical(name):
    eng = _engine()
    prog = eng.compile(name, _g(seed=3))
    rp = eng.remap(prog, force="spdmm")
    assert rp.binary == prog.binary
    assert rp.manifest["remap"]["counts"]["gemm"] == 0
    assert rp.manifest["remap"]["counts"]["skip"] == 0


@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
def test_forced_gemm_roundtrips_through_restore(name):
    eng = _engine()
    prog = eng.compile(name, _g(seed=3))
    rp = eng.remap(prog, force="gemm")
    assert rp.binary != prog.binary
    assert rp.manifest["remap"]["counts"]["gemm"] > 0
    back = remap_program(rp, force="spdmm")
    assert back.binary == prog.binary


# --------------------------------------------------------------------------- #
# Execution: forced GEMM on both residency paths.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forced_gemm_bit_identical_across_paths(name, backend):
    g = _g(seed=21)
    x = G.random_features(g, seed=2)
    eng = _engine(backend=backend)
    prog = eng.compile(name, g)
    y0 = eng.run(prog, x)
    rp = eng.remap(prog, force="gemm")
    y_dev = eng.run(rp, x)
    st = eng.exec_stats
    assert st.tiles_remapped == rp.manifest["remap"]["remapped_ops"] > 0
    assert st.tile_ops_by_mode.get("gemm", 0) > 0
    y_host = eng.run(rp, x, residency="host")
    assert eng.exec_stats.tiles_remapped == st.tiles_remapped
    # dense-aggregate GEMM reassociates the per-edge sums: allclose vs
    # the sparse path, but bit-exact across residency paths.
    np.testing.assert_allclose(y_dev.numpy(), y0.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(y_dev, y_host)
    xs = np.stack([x, x * -0.5])
    yb = eng.run_batch(rp, xs)
    assert torch.equal(yb[0], y_dev)
    assert torch.equal(eng.run_batch(rp, xs, residency="host"), yb)


def test_auto_remap_spdmm_skip_is_bit_identical():
    """Restricting modes to spdmm/skip makes auto remap a bit-exact
    transformation (skip only fires on truly empty tiles)."""
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    eng = _engine()
    prog = eng.compile("b1", g)
    y0 = eng.run(prog, x)
    rp = eng.remap(prog, modes=("spdmm", "skip"))
    assert rp.manifest["remap"]["counts"]["gemm"] == 0
    assert torch.equal(eng.run(rp, x), y0)
    assert torch.equal(eng.run(rp, x, residency="host"), y0)


def test_forced_gemm_honors_nonlinear_aggops():
    """A globally-gemm'd program keeps SPDMM encodings inside MAX/MIN
    aggregate layers: a GCN whose first aggregation is MAX, its second
    SUM (b3, SAGE-mean, has no MAX layer here), run on both residencies
    and against JAX's run of the same forced remap."""
    from repro.core import gnn_builders as JB
    from repro.core.ir import AggOp as JAgg
    from repro_torch.core import gnn_builders as TB
    gj, gt = _g(seed=3, pkg=JG), _g(seed=3)
    x = G.random_features(gt, seed=5)
    models = []
    for B, cls, g in ((JB, JAgg, gj), (TB, AggOp, gt)):
        m = B.build_gcn(g, 8, 2)
        aggs = [l for _, l in sorted(m.layers.items())
                if l.layer_type.name == "AGGREGATE"]
        aggs[0].agg_op = cls(int(AggOp.MAX))
        models.append(m)
    eng = _engine(backend="cuda")
    rp = eng.remap(eng.compile(models[1], gt), force="gemm")
    instrs = disassemble(rp.binary)
    by_agg = {}
    for grp in _scan_groups(instrs):
        by_agg.setdefault(int(grp.agg), set()).add(instrs[grp.compute].op)
    assert set(by_agg) == {int(AggOp.MAX), int(AggOp.SUM)}
    for agg, ops in by_agg.items():
        if agg in (int(AggOp.SUM), int(AggOp.MEAN)):
            assert ops == {Opcode.GEMM}
        else:
            assert ops == {Opcode.SPDMM}
    y = eng.run(rp, x)
    assert torch.equal(eng.run(rp, x, residency="host"), y)
    je = _jengine()
    jr = je.remap(je.compile(models[0], gj), force="gemm")
    assert jr.binary == rp.binary
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(je.run(jr, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# Skip-empty elision.
# --------------------------------------------------------------------------- #
def _drained(prog, jk):
    """``prog`` over a copy of its partitioned graph whose tile ``jk`` has
    lost every edge (slices kept, all pad), as a live-graph delta that
    removes those edges leaves it."""
    pg = prog.pgraph
    tiles = dict(pg.tiles)
    tiles[jk] = [dataclasses.replace(
        t, cols=np.zeros_like(t.cols), vals=np.zeros_like(t.vals),
        edge_pos=np.full_like(t.edge_pos, -1), nnz=0) for t in pg.tiles[jk]]
    # ... and whose tile stats say so, as a rebind refreshes them
    man = copy.deepcopy(prog.manifest)
    man["tile_stats"]["tiles"][f"{jk[0]}:{jk[1]}"].update(nnz=0,
                                                           density=0.0)
    return dataclasses.replace(prog, manifest=man, pgraph=dataclasses.replace(
        pg, tiles=tiles), _plan=None)


def test_skip_empty_elision_bit_identical_to_cold():
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    eng = _engine()
    prog = eng.compile("b1", g)
    n1 = GEOM.n1
    jk = min(prog.pgraph.tiles,
             key=lambda k: sum(t.nnz for t in prog.pgraph.tiles[k]))
    rp = eng.remap(_drained(prog, jk), modes=("spdmm", "skip"))
    rec = rp.manifest["remap"]
    assert rp.cache_key == prog.cache_key
    assert rec["tiles"][f"{jk[0]}:{jk[1]}"]["mode"] == "skip"
    assert rec["counts"]["skip"] >= 1 and rec["skipped_tile_ops"] > 0

    y = eng.run(rp, x)
    assert eng.exec_stats.tiles_skipped == rec["skipped_tile_ops"]
    assert torch.equal(eng.run(rp, x, residency="host"), y)
    assert eng.exec_stats.tiles_skipped == rec["skipped_tile_ops"]

    keep = ~((g.dst // n1 == jk[0]) & (g.src // n1 == jk[1]))
    g1 = dataclasses.replace(g, src=g.src[keep], dst=g.dst[keep],
                             weight=g.weight[keep])
    cold = _engine()
    assert torch.equal(y, cold.run(cold.compile("b1", g1), x))


# --------------------------------------------------------------------------- #
# Density sources and constants.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("residency", ["device", "host"])
def test_exec_profile_density_source(residency):
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    eng = _engine()
    prog = eng.compile("b1", g)
    with pytest.raises(ValueError):
        resolve_density(prog, "exec_profile")
    eng.executor.profile_tiles = True
    eng.run(prog, x, residency=residency)
    stats, src = resolve_density(prog, "exec_profile")
    assert src == "exec_profile"
    pg_nnz = {f"{j}:{k}": sum(t.nnz for t in ts)
              for (j, k), ts in prog.pgraph.tiles.items()}
    assert {jk: s["nnz"] for jk, s in stats.items()} == pg_nnz
    rp = eng.remap(prog, source="exec_profile")
    assert rp.manifest["remap"]["source"] == "exec_profile"


def test_calibrated_constants_change_signature():
    eng = _engine()
    prog = eng.compile("b1", _g(seed=3))
    r_default = eng.remap(prog)
    r_cal = eng.remap(prog, report={"peak_flops": 1e12, "vpu_flops": 1e9,
                                    "hbm_bw": 1e10})
    assert not r_default.manifest["remap"]["calibrated"]
    assert r_cal.manifest["remap"]["calibrated"]
    assert r_default.manifest["remap"]["signature"] != \
        r_cal.manifest["remap"]["signature"]


def test_remap_updates_the_cache_entry_and_probe_decides_every_tile():
    g = _g(seed=3)
    x = G.random_features(g, seed=1)
    eng = _engine()
    prog = eng.compile("b1", g)
    rp = eng.remap(prog, force="gemm")
    hit = eng.compile("b1", g)
    assert hit.binary == rp.binary and hit.default_residency is None
    assert torch.equal(eng.run(hit, x), eng.run(rp, x))
    # probe=True times the port's ACK (perf_counter on the CPU): a
    # decision for every tile, recorded as probed
    pr = eng.remap(prog, probe=True)
    rec = pr.manifest["remap"]
    assert rec["probe"] and not rec["calibrated"]
    assert set(rec["tiles"]) == {f"{j}:{k}" for j, k in prog.pgraph.tiles}
    assert sum(rec["counts"].values()) == len(rec["tiles"])
    np.testing.assert_allclose(eng.run(pr, x).numpy(),
                               eng.run(prog, x).numpy(), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------- #
# Against the JAX package.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
def test_forced_gemm_matches_jax(name):
    gj, gt = _g(seed=21, pkg=JG), _g(seed=21)
    x = G.random_features(gt, seed=2)
    je = _jengine()
    jr = je.remap(je.compile(name, gj), force="gemm")
    y_jax = np.asarray(je.run(jr, jnp.asarray(x)))
    eng = _engine(backend="cuda")
    tr = eng.remap(eng.compile(name, gt), force="gemm")
    assert tr.binary == jr.binary
    for residency in ("device", "host"):
        y = eng.run(tr, x, residency=residency)
        np.testing.assert_allclose(y.numpy(), y_jax, rtol=RTOL, atol=ATOL)
        assert eng.exec_stats.tiles_remapped == je.exec_stats.tiles_remapped


@pytest.mark.parametrize("n_src,w", [
    pytest.param(32, 12, id="32"), pytest.param(45, 12, id="45"),
    pytest.param(4097, 12, id="4097"), pytest.param(45, 40, id="45-w40")])
def test_densify_and_gemm_agg_match_jax(n_src, w):
    r = np.random.default_rng(4)
    n1, f = 32, 8
    mask = r.random((n1, w)) > 0.3
    cols = np.where(mask, r.integers(0, n_src, (n1, w)), 0).astype(np.int32)
    vals = np.where(mask, r.normal(0, 1, (n1, w)), 0.0).astype(np.float32)
    cols[5, :4] = 7                     # one column four times in a row
    vals[5, :4] = [0.1, 1e4, -1e4, 0.3]
    if w > 32:
        # One column in every slot of a row (past one 32-slot chunk),
        # with zeros of either sign and sums that cancel.
        cols[6] = 3
        vals[6] = r.normal(0, 1, w) * np.where(r.random(w) > 0.5, 1e4, 1.0)
        vals[6, :8] = [-0.0, 2.5, -2.5, -0.0, 0.0, 1e4, -1e4, -0.0]
        vals[6, 30:36] = [-0.0, 0.0, -0.0, 7.0, -0.0, 0.0]
    h = r.normal(0, 1, (n_src, f)).astype(np.float32)
    acc = r.normal(0, 1, (n1, f)).astype(np.float32)
    want = np.asarray(jack.densify_tile(jnp.asarray(cols),
                                        jnp.asarray(vals), n_src=n_src))
    tc, tv = torch.from_numpy(cols), torch.from_numpy(vals)
    dense = tack.densify_tile(tc, tv, n_src)
    np.testing.assert_allclose(dense.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(dense, tack.densify_tile(tc, tv, n_src))
    # the duplicates sum in slot order: ((0.1 + 1e4) - 1e4) + 0.3
    s = np.float32(0.0)
    for v in vals[5, :4]:
        s = np.float32(s + v)
    assert dense[5, 7].item() == float(s)
    if w > 32:
        s = np.float32(0.0)
        for v in vals[6]:
            s = np.float32(s + v)
        got = dense[6, 3].numpy()
        assert got.view(np.int32) == s.view(np.int32)
        assert float(dense[6].abs().sum() - abs(dense[6, 3])) == 0.0
    j_out = np.asarray(jack.ACK().gemm_agg(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(h),
        jnp.asarray(acc)))
    for backend in ("torch", "cuda"):
        got = tack.ACK(backend).gemm_agg(tc, tv, torch.from_numpy(h),
                                          torch.from_numpy(acc))
        np.testing.assert_allclose(got.numpy(), j_out, rtol=1e-5,
                                   atol=1e-4)


def test_exec_profile_matches_jax():
    gj, gt = _g(seed=7, pkg=JG), _g(seed=7)
    x = G.random_features(gt, seed=4)
    je = _jengine()
    je._executor.profile_tiles = True
    jp = je.remap(je.compile("b1", gj), force="gemm")
    je.run(jp, jnp.asarray(x))
    eng = _engine()
    eng.executor.profile_tiles = True
    tp = eng.remap(eng.compile("b1", gt), force="gemm")
    eng.run(tp, x, residency="host")
    assert tp.manifest["exec_profile"] == jp.manifest["exec_profile"]


# --------------------------------------------------------------------------- #
# Live graphs: skip-empty on a drained tile, incremental rebind remap.
# --------------------------------------------------------------------------- #
def _words(binary: bytes) -> np.ndarray:
    return np.frombuffer(binary, dtype="<u4",
                         offset=HEADER_BYTES).reshape(-1, 4)


def _drain_smallest_tile(store, Delta=GraphDelta):
    jk = min(store.edges, key=lambda k: store.edges[k].n)
    te = store.edges[jk]
    d = Delta(base_vertices=store.n_vertices)
    for u, w in zip(te.src.tolist(), te.dst.tolist()):
        d.remove_edge(u, w)
    return jk, d


def test_skip_empty_elision_on_live_graph_bit_identical_to_cold():
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    live = GraphVersionStore(g, GEOM, name="lv")
    eng = _engine()
    prog = eng.compile("b1", live.head.as_graph())
    eng.remap(prog, modes=("spdmm", "skip"))   # re-caches remapped copy
    jk, d = _drain_smallest_tile(live.head.store)
    v1 = live.apply(d)
    assert not v1.stats.structural_change
    compiles = eng.stats.compiles
    p1 = eng.compile("b1", v1.as_graph())
    assert eng.stats.compiles == compiles       # content-only: cache hit
    rec = p1.manifest["remap"]
    assert rec["tiles"][f"{jk[0]}:{jk[1]}"]["mode"] == "skip"
    assert rec["counts"]["skip"] >= 1 and rec["skipped_tile_ops"] > 0
    y = eng.run(p1, x)
    assert eng.exec_stats.tiles_skipped == rec["skipped_tile_ops"]
    assert torch.equal(eng.run(p1, x, residency="host"), y)
    cold = _engine()
    assert torch.equal(y, cold.run(cold.compile("b1", d.apply_to(g)), x))


def test_rebind_remaps_only_patched_tiles():
    g, gj = _g(seed=7), _g(seed=7, pkg=JG)
    live = GraphVersionStore(g, GEOM, name="lv")
    jlive = JL.GraphVersionStore(gj, JPC(n1=32, n2=8), name="lv")
    eng, je = _engine(), _jengine()
    # Both remaps priced by the JAX package's default constants: each
    # record carries its constants, and the packages' defaults differ.
    from repro.core.perfmodel import DEFAULT_CONSTANTS
    consts = DEFAULT_CONSTANTS.to_dict()
    prog = eng.compile("b1", live.head.as_graph())
    rp0 = eng.remap(prog, consts, force="gemm")
    je.remap(je.compile("b1", jlive.head.as_graph()), consts, force="gemm")

    jk_empty, d = _drain_smallest_tile(live.head.store)
    _, jd = _drain_smallest_tile(jlive.head.store, JL.GraphDelta)
    jk_other = max(live.head.store.edges,
                   key=lambda k: live.head.store.edges[k].n)
    o = live.head.store.edges[jk_other]
    d.add_edge(int(o.src[0]), int(o.dst[0]), 0.5)
    jd.add_edge(int(o.src[0]), int(o.dst[0]), 0.5)
    v1 = live.apply(d)
    jv1 = jlive.apply(jd)
    patched = set(v1.stats.patched)
    assert patched == {f"{jk_empty[0]}:{jk_empty[1]}",
                       f"{jk_other[0]}:{jk_other[1]}"}

    p1 = eng.compile("b1", v1.as_graph())
    rec = p1.manifest["remap"]
    assert rec["tiles"][f"{jk_empty[0]}:{jk_empty[1]}"]["mode"] == "skip"
    for jk, entry in rec["tiles"].items():
        if jk not in patched:
            assert entry == rp0.manifest["remap"]["tiles"][jk]
    w0, w1 = _words(rp0.binary), _words(p1.binary)
    assert w0.shape == w1.shape
    diff_rows = set(np.nonzero((w0 != w1).any(axis=1))[0].tolist())
    instrs = [Instr.decode(w) for w in w0]
    owner = {}
    for grp in _scan_groups(instrs):
        for idx in (grp.compute, *grp.mem):
            owner[idx] = f"{grp.j}:{grp.k}"
    for row in diff_rows:
        assert owner.get(row) in patched, row
    for jk in v1.store.tiles:
        if f"{jk[0]}:{jk[1]}" not in patched:
            assert v1.store.tiles[jk] is live.get(0).store.tiles[jk]
    again = v1.bind(eng.cache.get(prog.cache_key))
    assert again is v1.bind(eng.cache.get(prog.cache_key))

    jp1 = je.compile("b1", jv1.as_graph())
    assert p1.binary == jp1.binary
    jrec = jp1.manifest["remap"]
    assert {k: v for k, v in rec.items() if k != "remap_ms"} == \
        {k: v for k, v in jrec.items() if k != "remap_ms"}   # a wall time
    x = G.random_features(v1.as_graph(), seed=5)
    y = eng.run(p1, x)
    assert torch.equal(eng.run(p1, x, residency="host"), y)
    np.testing.assert_allclose(y.numpy(), np.asarray(je.run(jp1, x)),
                               rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# Verify on remapped programs.
# --------------------------------------------------------------------------- #
def test_verify_passes_on_remapped_gagi(tmp_path):
    eng = _engine(verify=True)
    rp = eng.remap(eng.compile("b1", _g(seed=3)), force="gemm")
    assert verify_program(rp).ok
    path = str(tmp_path / "remapped.gagi")
    rp.save(path)
    assert verify_gagi(path).ok


def test_verify_catches_tampered_record():
    eng = _engine()
    rp = eng.remap(eng.compile("b1", _g(seed=3)), force="gemm")
    bad = dataclasses.replace(rp, manifest=copy.deepcopy(rp.manifest))
    jk = next(k for k, e in bad.manifest["remap"]["tiles"].items()
              if e["mode"] == "gemm")
    bad.manifest["remap"]["tiles"][jk]["mode"] = "spdmm"
    rep = verify_program(bad)
    assert not rep.ok
    assert any("remap record marks it spdmm" in v.message
               for v in rep.violations)


def test_verify_catches_unrecorded_gemm():
    """A GEMM smuggled into an AGGREGATE layer with NO remap record still
    fails: the legality gate did not simply get wider."""
    eng = _engine()
    rp = remap_program(eng.compile("b1", _g(seed=3)), force="gemm")
    stripped = dict(rp.manifest)
    del stripped["remap"]
    bad = dataclasses.replace(rp, manifest=stripped, _plan=None)
    rep = verify_program(bad)
    assert not rep.ok
    assert any("no remap record" in v.message for v in rep.violations)
