"""The port's Engine (device="cpu") against the JAX package's Engine.

A twin of ``tests/test_executor.py`` (b1-b8 on uniform graphs, b1/b3/b6
on power-law graphs, the no-opt path, MAX/MIN, isolated vertices, the
no-recompile overlay property), plus serving with the program cache,
``.gagi`` bundles crossing between the packages, weights carried across
from plain arrays, the paths this slice does not port, and a subprocess
check that the port loads neither ``jax`` nor ``repro``.  Outputs are
held against the JAX Engine's at rtol 2e-4 / atol 2e-5.

The JAX side runs once per input (module-scoped caches), so the suite
stays small.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gnn_builders as JB  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.ir import AggOp as JAgg  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ack  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import reference as TR  # noqa: E402
from repro_torch.core.ir import AggOp  # noqa: E402
from repro_torch.core.passes.partition import \
    PartitionConfig as TPC  # noqa: E402
from repro_torch.engine import (BinaryExecutor, CompiledProgram,  # noqa
                                Engine, InferenceRequest,
                                ResidentBudgetError)

RTOL, ATOL = 2e-4, 2e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _jengine() -> JEngine:
    return JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)


def _engine(**kw) -> Engine:
    return Engine(geometry=TPC(n1=32, n2=8), n_pes=4, device="cpu", **kw)


def _graphs(nv=90, ne=400, f=12, c=4, seed=0, degree="uniform"):
    """The same graph built by both packages (numpy-seeded)."""
    out = []
    for G in (JG, TG):
        g = G.random_graph(nv, ne, seed=seed, degree=degree)
        g = g.gcn_normalized()
        g.feat_dim, g.n_classes = f, c
        out.append(g)
    return out


@pytest.fixture(scope="module")
def jax_out():
    """JAX Engine outputs, computed once per (case) key."""
    cache = {}

    def get(key, name, gj, x, **kw):
        if key not in cache:
            eng = _jengine()
            m = JB.build(name, gj) if isinstance(name, str) else name
            prog = eng.compile(m, gj, **kw)
            cache[key] = np.asarray(eng.run(prog, jnp.asarray(x)))
        return cache[key]
    return get


def _check(jax_out, key, name, gj, gt, engine=None, **kw):
    x = JG.random_features(gj, seed=2)
    want = jax_out(key, name, gj, x, **kw)
    eng = engine or _engine()
    prog = eng.compile(TB.build(name, gt), gt, **kw)
    got = eng.run(prog, x)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    return eng, prog


@pytest.mark.parametrize("name", list(TB.BENCHMARKS))
def test_all_benchmarks_match_jax(jax_out, name):
    _check(jax_out, ("uni", name), name, *_graphs())


@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
def test_powerlaw_graphs(jax_out, name):
    _check(jax_out, ("pl", name), name,
           *_graphs(nv=150, ne=1200, degree="powerlaw", seed=5))


def test_no_opt_path_matches(jax_out):
    _check(jax_out, ("noopt", "b5"), "b5", *_graphs(seed=7),
           order_opt=False, fusion=False)


@pytest.mark.parametrize("name", ["b1", "b6"])
def test_kernel_backend_matches(jax_out, name):
    # backend "cuda" on CPU tensors: the kernel wrappers' plain versions.
    eng, _ = _check(jax_out, ("kb", name), name,
                    *_graphs(nv=64, ne=200, f=8),
                    engine=_engine(backend="cuda"))
    assert eng.backend == "cuda"


def test_max_min_aggregation():
    gj, gt = _graphs(seed=9)
    x = JG.random_features(gj, seed=4)
    for op in (AggOp.MAX, AggOp.MIN):
        mj, mt = JB.build_gcn(gj, 8, 2), TB.build_gcn(gt, 8, 2)
        for m, cls in ((mj, JAgg), (mt, AggOp)):
            for l in m.layers.values():
                if l.layer_type.name == "AGGREGATE":
                    l.agg_op = cls(int(op))
        je = _jengine()
        want = np.asarray(je.run(je.compile(mj, gj), jnp.asarray(x)))
        for backend in ("torch", "cuda"):
            eng = _engine(backend=backend)
            got = eng.run(eng.compile(mt, gt), x)
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)


def test_overlay_property_no_recompile_across_models():
    _, g1 = _graphs(seed=11)
    _, g2 = _graphs(nv=120, ne=700, seed=12)
    eng = _engine()
    eng.run(eng.compile(TB.build("b2", g1), g1),
            TG.random_features(g1, seed=1))
    ack.reset_counter()
    eng.run(eng.compile(TB.build("b3", g2), g2),
            TG.random_features(g2, seed=1))
    counts = ack.counter_snapshot()
    gemm_keys = {k for k in counts if k[0] == "gemm"}
    spdmm_keys = {k for k in counts if k[0] == "spdmm"}
    assert len(gemm_keys) <= 1
    assert all(k[1] == (32, 8) for k in gemm_keys | spdmm_keys)


@pytest.mark.parametrize("name", ["b1", "b5"])
def test_executor_handles_isolated_vertices(jax_out, name):
    _check(jax_out, ("iso", name), name, *_graphs(nv=100, ne=30, seed=13))


# --------------------------------------------------------------------------- #
# Serving, bundles, carried-over weights.
# --------------------------------------------------------------------------- #
def _request_mix():
    pairs = [("b1", 0), ("b7", 0), ("b1", 1), ("b7", 1)] * 2
    graphs = {0: _graphs(seed=21, nv=70, ne=260, f=8, c=3)[1],
              1: _graphs(seed=22, nv=80, ne=300, f=8, c=3)[1]}
    return [InferenceRequest(model=m, graph=graphs[gid],
                             features=TG.random_features(graphs[gid],
                                                         seed=i),
                             request_id=f"req{i}")
            for i, (m, gid) in enumerate(pairs)]


def test_serve_reports_cache_hits_and_matches_cold_compiles():
    reqs = _request_mix()
    eng = _engine()
    warm = eng.serve(reqs)
    assert [r.cache_hit for r in warm] == [False] * 4 + [True] * 4
    assert all(r.t_loc == 0.0 for r in warm[4:])
    assert all(r.t_loc > 0.0 and r.t_loh > 0.0 for r in warm[:4])
    assert eng.stats.cache_hits == 4 and eng.stats.compiles == 4
    cold = _engine(cache_capacity=1).serve(reqs)
    for w, c in zip(warm, cold):
        assert torch.equal(w.output, c.output), w.request_id
    # staged tiles live on the shared pgraph: a hit uploads no tiles
    assert eng.exec_stats.h2d_bytes == 0
    assert [r["layer"] for r in eng.exec_stats.per_layer]
    assert all(r["wall_s"] >= 0 for r in eng.exec_stats.per_layer)


@pytest.mark.parametrize("name", ["b1", "b6"])
def test_gagi_bundle_from_jax_runs_on_port(tmp_path, name):
    gj, gt = _graphs(seed=3)
    x = JG.random_features(gj, seed=2)
    je = _jengine()
    jprog = je.compile(name, gj)
    want = np.asarray(je.run(jprog, jnp.asarray(x)))
    path = str(tmp_path / f"{name}.gagi")
    jprog.save(path)
    eng = _engine()
    loaded = eng.load(path)
    assert loaded.source is None and "dep_graph" in loaded.manifest
    np.testing.assert_allclose(eng.run(loaded, x).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    # and back: the port's own bundle runs on the JAX engine
    tprog = eng.compile(name, gt)
    tpath = str(tmp_path / f"{name}_port.gagi")
    tprog.save(tpath)
    assert CompiledProgram.load(tpath).binary == jprog.binary
    back = je.run(je.load(tpath), jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(back), want, rtol=RTOL,
                               atol=ATOL)


def test_weights_carried_across_from_arrays():
    gj, _ = _graphs(seed=4)
    jm = JB.build("b3", gj, seed=5)
    r = np.random.default_rng(6)
    weights = {k: (r.normal(0, 0.3, np.shape(v)).astype(np.float32)
                   if k.endswith(".b") else np.asarray(v, np.float32))
               for k, v in jm.weights.items()}
    assert any(k.endswith(".b") for k in weights)
    jm.weights = dict(weights)
    table = convert.layer_table(jm)
    tm = convert.model_from_arrays(table, weights)
    # the port model is not the seed's: its biases are the random ones
    assert not np.allclose(tm.weights[next(k for k in weights
                                           if k.endswith(".b"))], 0)
    x = JG.random_features(gj, seed=2)
    gt2 = convert.graph_from_arrays(gj.n_vertices, gj.src, gj.dst,
                                    gj.weight, gj.feat_dim, gj.n_classes)
    eng, je = _engine(), _jengine()
    # Order optimization moves each Linear (bias included) across its
    # Aggregate, which is exact only for a zero bias: with these biases
    # both compilers give the same, reordered result ...
    want = np.asarray(je.run(je.compile(jm, gj), jnp.asarray(x)))
    got = eng.run(eng.compile(tm, gt2), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # ... and without the reordering both equal the layer-by-layer
    # reference on the carried-over weights.
    want = np.asarray(je.run(je.compile(jm, gj, order_opt=False),
                             jnp.asarray(x)))
    got = eng.run(eng.compile(tm, gt2, order_opt=False), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = TR.run_reference(tm, gt2, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    # weights as tensors (on the engine's device) give the same output
    tw = convert.weights_from_numpy(weights, "cpu")
    prog = eng.compile(tm, gt2, order_opt=False)
    np.testing.assert_array_equal(eng.run(prog, x, weights=tw).numpy(),
                                  got.numpy())
    with pytest.raises(KeyError):
        convert.model_from_arrays(table, {})


def test_graph_from_arrays_validates():
    g = convert.graph_from_arrays(4, [0, 1], [1, 2])
    assert g.weight.dtype == np.float32 and g.n_edges == 2
    with pytest.raises(ValueError):
        convert.graph_from_arrays(2, [0, 5], [1, 1])
    with pytest.raises(ValueError):
        convert.graph_from_arrays(4, [0, 1], [1])


# --------------------------------------------------------------------------- #
# Device policy and what this slice does not port.
# --------------------------------------------------------------------------- #
def test_default_device_is_cuda_with_no_silent_cpu_path():
    if torch.cuda.is_available():
        assert Engine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(device="cuda")


def test_torch_backend_refused_on_cuda_device():
    with pytest.raises(ValueError, match="hand kernels"):
        BinaryExecutor(device="cuda", backend="torch")


def test_unported_paths_raise(tmp_path):
    gj, gt = _graphs(seed=15)
    x = TG.random_features(gt, seed=1)
    eng = _engine()
    prog = eng.compile("b1", gt)
    with pytest.raises(NotImplementedError, match="A7"):
        eng.run(prog, x, residency="host")
    with pytest.raises(NotImplementedError, match="A13"):
        eng.run(prog, x, mesh=2)
    with pytest.raises(NotImplementedError, match="A6"):
        eng.run(prog, x, graph_data={"tiles": {}})
    with pytest.raises(NotImplementedError, match="A6"):
        eng.run_batch(prog, np.stack([x, x]))
    with pytest.raises(NotImplementedError, match="A6"):
        eng.submit_batch([])
    # a sparsity-remapped binary (GEMM steps in AGGREGATE layers)
    je = _jengine()
    remapped = je.remap(je.compile("b1", gj), force="gemm")
    path = str(tmp_path / "remapped.gagi")
    remapped.save(path)
    with pytest.raises(NotImplementedError, match="A8"):
        eng.run(eng.load(path), x)


def test_budget_gate_and_liveness():
    _, gt = _graphs(seed=16)
    eng = _engine()
    prog = eng.compile("b5", gt)
    x = TG.random_features(gt, seed=1)
    peak = eng.executor.estimate_device_peak_bytes(prog, x.shape[1])
    events = []
    eng.executor.liveness_hook = lambda ev, lid, n: events.append(ev)
    eng.run(prog, x)
    assert "free" in events and eng.exec_stats.peak_live_outputs >= 1
    eng.executor.resident_budget_bytes = peak - 1
    with pytest.raises(ResidentBudgetError, match="first exceeded"):
        eng.run(prog, x)
    eng.executor.resident_budget_bytes = peak
    eng.run(prog, x)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.core import graph as G\n"
        "from repro_torch.engine import Engine, InferenceRequest\n"
        "from repro_torch.core.passes.partition import PartitionConfig\n"
        "g = G.random_graph(60, 240, seed=1).gcn_normalized()\n"
        "g.feat_dim, g.n_classes = 8, 3\n"
        "eng = Engine(PartitionConfig(n1=32, n2=8), device='cpu',"
        " backend='cuda')\n"
        "r = eng.serve([InferenceRequest('b6', g,"
        " G.random_features(g, seed=2))])[0]\n"
        "assert r.output.shape == (60, 3)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_bundle_without_residency_section_runs(tmp_path):
    # Bundles written before manifests carried `residency`: the executor
    # derives the liveness schedule from the binary.
    _, gt = _graphs(seed=17)
    x = TG.random_features(gt, seed=1)
    eng = _engine()
    prog = eng.compile("b8", gt)
    want = eng.run(prog, x)
    path = str(tmp_path / "old.gagi")
    prog.save(path)
    old = CompiledProgram.load(path)
    derived = old.manifest.pop("residency")
    assert torch.equal(eng.run(old, x), want)
    assert old.__dict__["_derived_residency"]["last_use"] == \
        derived["last_use"]


def test_malformed_tile_columns_are_refused():
    _, gt = _graphs(seed=18)
    eng = _engine()
    prog = eng.compile("b1", gt)
    tile = next(iter(prog.pgraph.tiles.values()))[0]
    tile.cols[0, 0] = prog.pgraph.config.n1          # out of the block
    with pytest.raises(ValueError, match="column indices"):
        eng.run(prog, TG.random_features(gt, seed=1))
