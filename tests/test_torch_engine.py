"""The port's Engine (device="cpu") against the JAX package's Engine.

A twin of ``tests/test_executor.py`` (b1-b8 on uniform graphs, b1/b3/b6
on power-law graphs, the no-opt path, MAX/MIN, isolated vertices, the
no-recompile overlay property), the dot-product-attention GAT (gat-dot)
and its fused-edge-softmax variant, plus serving with the program cache,
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

from _torch_models import build_gat_dot  # noqa: E402
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
# gat-dot: dot-mode SDDMM scores, edge softmax, edge-weighted aggregation.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("degree", ["uniform", "powerlaw"])
def test_gat_dot_matches_jax(degree):
    gj, gt = _graphs(nv=120, ne=700, degree=degree, seed=23)
    x = JG.random_features(gj, seed=2)
    je = _jengine()
    want = np.asarray(je.run(je.compile(build_gat_dot(JB, gj, hidden=16),
                                        gj), jnp.asarray(x)))
    for backend in ("torch", "cuda"):
        eng = _engine(backend=backend)
        got = eng.run(eng.compile(build_gat_dot(TB, gt, hidden=16), gt), x)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        modes = eng.exec_stats.tile_ops_by_mode
        assert modes["sddmm"] > 0 and modes["spdmm"] > 0 and modes["gemm"]


def test_fused_edge_softmax_on_vector_inner():
    # Without the LeakyReLU the fusion pass folds EDGE_SOFTMAX into the
    # VectorInner's epilogue; the JAX executor cannot run that program
    # (ROADMAP C), so it is held against JAX compiled without fusion.
    gj, gt = _graphs(nv=120, ne=700, degree="powerlaw", seed=24)
    x = JG.random_features(gj, seed=2)
    mt = build_gat_dot(TB, gt, hidden=16, lrelu=False)
    eng = _engine(backend="cuda")
    prog = eng.compile(mt, gt)
    softmax = ("act", int(TB.Activation.EDGE_SOFTMAX))
    assert any(lp.tiles and lp.tiles[0].epilogue[-1:] == [softmax]
               for lp in prog.plan().layers)
    got = eng.run(prog, x)
    ref = TR.run_reference(build_gat_dot(TB, gt, hidden=16, lrelu=False),
                           gt, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    je = _jengine()
    want = np.asarray(je.run(je.compile(
        build_gat_dot(JB, gj, hidden=16, lrelu=False), gj, fusion=False),
        jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the softmax's tile ops are counted as the standalone layer's are
    # (the unfused program also runs its ReLUs as standalone "act" tiles)
    unfused = _engine(backend="cuda")
    unfused.run(unfused.compile(build_gat_dot(TB, gt, hidden=16,
                                              lrelu=False), gt,
                                fusion=False), x)
    st = unfused.exec_stats
    assert eng.exec_stats.tile_ops == \
        st.tile_ops - st.tile_ops_by_mode["act"]


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
    # Order optimization may not move a Linear with a non-zero bias
    # across its Aggregate (Agg(HW + b) != Agg(H)W + b).  The port's
    # compiler keeps such pairs in place, so with order optimization on
    # it equals the layer-by-layer reference and JAX's unreordered
    # program (the JAX compiler still exchanges them: ROADMAP C).
    want = np.asarray(je.run(je.compile(jm, gj, order_opt=False),
                             jnp.asarray(x)))
    prog = eng.compile(tm, gt2)
    assert prog.source.order_report.exchanges == []
    got = eng.run(prog, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    ref = TR.run_reference(tm, gt2, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL,
                               atol=ATOL)
    got = eng.run(eng.compile(tm, gt2, order_opt=False), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
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
    # The mesh path is ported (tests/test_torch_placement.py): virtual
    # shards of the CPU give the device path's bits, and what does not
    # compose with it is refused as in JAX.
    from repro_torch.launch.mesh import DeviceMesh
    assert torch.equal(eng.run(prog, x, mesh=DeviceMesh(["cpu"] * 2)),
                       eng.run(prog, x))
    with pytest.raises(ValueError, match="does not compose"):
        eng.run(prog, x, mesh=DeviceMesh(["cpu"] * 2), residency="host")
    # Graph-as-data is ported (tests/test_torch_sampling.py): a
    # structure that does not match the program's layout is refused
    # before any launch, and it runs device-resident only, as in JAX.
    with pytest.raises(ValueError, match="graph_data"):
        eng.run(prog, x, graph_data={"tiles": {}})
    with pytest.raises(ValueError, match="graph_data"):
        eng.run_batch(prog, np.stack([x, x]), graph_data={"tiles": {}})
    with pytest.raises(ValueError, match="device-resident only"):
        eng.run(prog, x, graph_data={"tiles": {}}, residency="host")
    # Host streaming and remapped binaries are ported now: a JAX-remapped
    # bundle (GEMM steps in AGGREGATE layers) runs on both residencies
    # with the same bits, within tolerance of JAX's own run of it.
    y = eng.run(prog, x)
    assert torch.equal(eng.run(prog, x, residency="host"), y)
    assert torch.equal(eng.run_batch(prog, np.stack([x, x]),
                                     residency="host")[1], y)
    je = _jengine()
    remapped = je.remap(je.compile("b1", gj), force="gemm")
    path = str(tmp_path / "remapped.gagi")
    remapped.save(path)
    loaded = eng.load(path)
    yr = eng.run(loaded, x)
    assert eng.exec_stats.tiles_remapped > 0
    assert torch.equal(eng.run(loaded, x, residency="host"), yr)
    np.testing.assert_allclose(
        yr.numpy(), np.asarray(je.run(remapped, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


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


def test_port_imports_neither_jax_nor_repro(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.core import graph as G\n"
        "from repro_torch.engine import Engine, InferenceRequest\n"
        "from repro_torch.runtime import OverlayPool, ServeLoop\n"
        "from repro_torch.core.passes.partition import PartitionConfig\n"
        "g = G.random_graph(60, 240, seed=1).gcn_normalized()\n"
        "g.feat_dim, g.n_classes = 8, 3\n"
        "eng = Engine(PartitionConfig(n1=32, n2=8), device='cpu',"
        " backend='cuda')\n"
        "r = eng.serve([InferenceRequest('b6', g,"
        " G.random_features(g, seed=2))])[0]\n"
        "assert r.output.shape == (60, 3)\n"
        "pool = OverlayPool(2, PartitionConfig(n1=32, n2=8), device='cpu')\n"
        "rs = pool.serve([InferenceRequest('b1', g, G.random_features(g,"
        " seed=s)) for s in range(3)], max_batch=2)\n"
        "assert [x.batch_size for x in rs] == [2, 2, 1]\n"
        "import torch\n"
        "from repro_torch import convert\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models.steps import build_model,"
        " make_prefill_step\n"
        "cfg = get_smoke_config('qwen3-0.6b')\n"
        "lm = build_model(cfg, device='cpu')\n"
        "lg = make_prefill_step(lm, cfg)(lm, {'tokens':"
        " torch.zeros(2, 5, dtype=torch.int32)})\n"
        "assert lg.shape == (2, cfg.vocab)\n"
        "assert serve.main(['--smoke', '--device', 'cpu', '--requests', '2',"
        " '--prompt-len', '3', '--gen', '2']) == 0\n"
        "import repro_torch.core.passes.remap, repro_torch.core.perfmodel\n"
        "import repro_torch.verify.hazards\n"
        "rp = eng.remap(eng.compile('b1', g), force='gemm')\n"
        "y = eng.run(rp, G.random_features(g, seed=3), residency='host')\n"
        "assert eng.exec_stats.tiles_remapped > 0 and y.shape == (60, 3)\n"
        "import repro_torch.obs\n"
        "from repro_torch.sampling import SamplingService, TargetRequest\n"
        "svc = SamplingService(g, G.random_features(g, seed=4),"
        " n_overlays=1, geometry=PartitionConfig(n1=32, n2=8),"
        " device='cpu', max_batch=1)\n"
        "t = svc.submit(TargetRequest(targets=[3, 7], fanouts=(4, 2)))\n"
        "svc.shutdown()\n"
        "assert t.logits.shape == (2, 3) and t.n_vertices > 2\n"
        "from repro_torch.livegraph import (GraphDelta, GraphVersionStore,"
        " LiveGraphServer)\n"
        "from repro_torch.verify import verify\n"
        "live = LiveGraphServer(GraphVersionStore(g, PartitionConfig(n1=32,"
        " n2=8)))\n"
        "live.apply(GraphDelta(60).add_edge(1, 2, 0.5))\n"
        "veng = Engine(PartitionConfig(n1=32, n2=8), device='cpu',"
        " verify=True)\n"
        "r = veng.submit(InferenceRequest('b1', live, G.random_features(g,"
        " seed=5)))\n"
        "assert r.graph_name.endswith('@v1') and r.output.shape == (60, 3)\n"
        "assert verify(veng.compile('b1', live)).ok\n"
        "from repro_torch.launch.mesh import DeviceMesh\n"
        "y = veng.run(veng.compile('b1', live, mesh=2), G.random_features(g,"
        " seed=5), mesh=DeviceMesh(['cpu'] * 2))\n"
        "assert y.shape == (60, 3)\n"
        "from repro_torch.configs import get_config\n"
        "assert get_config('granite-8b').n_layers == 36\n"
        "assert get_config('gemma3-27b').n_layers == 62\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "assert get_config('kimi-k2-1t-a32b').n_experts == 384\n"
        "assert get_config('deepseek-v3-671b').mla\n"
        "from repro_torch.launch import train\n"
        "from repro_torch.checkpoint import latest_step\n"
        "import repro_torch.optim, repro_torch.data\n"
        "import repro_torch.distributed.compression\n"
        "ck = sys.argv[1]\n"
        "assert train.main(['--arch', 'gemma3-12b', '--smoke', '--device',"
        " 'cpu', '--steps', '2', '--batch', '1', '--seq', '12',"
        " '--ckpt-dir', ck, '--ckpt-every', '2', '--compress-grads']) == 0\n"
        "assert latest_step(ck) == 2\n"
        "assert serve.main(['--arch', 'gemma3-27b', '--smoke', '--device',"
        " 'cpu', '--requests', '1', '--prompt-len', '6', '--gen', '4']) == 0\n"
        "import repro_torch.models.ssm, repro_torch.models.xlstm_blocks\n"
        "for arch in ('hymba-1.5b', 'xlstm-125m'):\n"
        "    assert serve.main(['--arch', arch, '--smoke', '--device', 'cpu',"
        " '--requests', '1', '--prompt-len', '4', '--gen', '3']) == 0\n"
        "import repro_torch.distributed.sharding"
        ", repro_torch.distributed.zero, repro_torch.distributed.pipeline\n"
        "from repro_torch.launch import dryrun, op_analysis, roofline\n"
        "from repro_torch.models.config import SHAPES, ShapeCell\n"
        "cell = ShapeCell('t', 16, 16, 'train')\n"
        "rec = dryrun.analyze_cell(get_smoke_config('qwen3-0.6b'), cell,"
        " dryrun.make_production_mesh())\n"
        "assert rec['roofline']['dominant'] in ('compute_s', 'memory_s',"
        " 'collective_s')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
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


def test_row_len_is_one_past_the_last_live_slot():
    # The staged live length of every ELL slice of a partitioned power-law
    # graph, and of a hand-built tile with an interior pad and an empty row.
    from repro_torch.core.passes.partition import ELLTile
    from repro_torch.engine.executor import _staged, _tile_array
    _, gt = _graphs(nv=200, ne=1500, seed=21, degree="powerlaw")
    prog = _engine().compile("b1", gt)
    pg = prog.pgraph
    staged = _staged(pg, torch.device("cpu")).tiles("row_len")
    n_slices = 0
    for (j, k), ts in pg.tiles.items():
        for s, t in enumerate(ts):
            want = [max((i + 1 for i in range(t.width)
                         if t.edge_pos[r, i] >= 0), default=0)
                    for r in range(pg.config.n1)]
            got = staged[(j, k, s)]
            assert got.dtype == torch.int32 and got.shape == (pg.config.n1,)
            assert got.tolist() == want
            n_slices += 1
    assert n_slices == len(staged) > 1
    ep = np.array([[3, -1, 5, -1], [-1, -1, -1, -1], [0, 1, 2, 4],
                   [-1, 7, -1, -1]], np.int32)
    t = ELLTile(0, 0, np.zeros_like(ep), np.zeros(ep.shape, np.float32), ep,
                nnz=7)
    assert _tile_array(t, "row_len").tolist() == [3, 0, 4, 2]


def test_aggregate_passes_row_len_to_the_spdmm_kernel(monkeypatch):
    # SUM/MEAN runs hand each step's staged live length to the kernel's
    # step-list wrapper; the output is the full-width walk's.
    from repro_torch.kernels import ops as kops
    _, gt = _graphs(nv=120, ne=700, seed=22, degree="powerlaw")
    x = TG.random_features(gt, seed=3)
    eng = _engine(backend="cuda")
    prog = eng.compile("b1", gt)
    seen, real = [], kops.spdmm_steps

    def spy(steps, h, acc=None, out_dtype=torch.float32):
        seen.extend(row_len for _, _, row_len, _ in steps.steps)
        return real(steps, h, acc, out_dtype)
    monkeypatch.setattr(kops, "spdmm_steps", spy)
    got = eng.run(prog, x)
    assert seen and all(r is not None and r.dtype == torch.int32
                        for r in seen)

    def full_width(steps, h, acc=None, out_dtype=torch.float32):
        walk_all = kops.SpdmmSteps([(c, v, None, off) for c, v, _, off
                                    in steps.steps], steps.n_src)
        return real(walk_all, h, acc, out_dtype)
    monkeypatch.setattr(kops, "spdmm_steps", full_width)
    assert torch.equal(eng.run(prog, x), got)


def test_malformed_tile_columns_are_refused():
    _, gt = _graphs(seed=18)
    eng = _engine()
    prog = eng.compile("b1", gt)
    tile = next(iter(prog.pgraph.tiles.values()))[0]
    tile.cols[0, 0] = prog.pgraph.config.n1          # out of the block
    with pytest.raises(ValueError, match="column indices"):
        eng.run(prog, TG.random_features(gt, seed=1))
