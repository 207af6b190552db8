"""The port's cost-model conformance and trace attribution on device="cpu".

A twin of ``tests/test_conformance.py`` over ``repro_torch.obs`` and the
port's executor, plus parity with the JAX package:

  * ``predict_loh`` / ``layer_costs`` equal JAX's under equal constants
    (the port's defaults are the H100's, JAX's the TPU's);
  * ``ExecStats.per_layer`` populated on both residency paths and merged
    by ``ExecStats.add``; a synthetic 4-thread trace round-trips through
    the span DAG; overlapped stage spans induce ~0 stall;
  * on a real traced host-streaming run the calibrated model error is
    strictly below the uncalibrated one;
  * the same per-layer records, program and constants fed to both
    packages' ``build_report`` give equal ``to_dict()``; ``build_dag``
    summaries, ``fit_stage_bw`` and the attribution table agree on one
    JAX-shaped trace; the trajectory copy agrees on the same documents;
  * the host path's ``stage`` events carry bytes and a duration, and
    ``fit_stage_bw`` prefers the copies' device time (``copy_us``);
  * a mesh run's halo section: none at one device in either package, and
    at four virtual CPU shards equal to that of JAX's own 4-device run (a
    subprocess with forced host devices); the attribution table's halo
    column reads the port's ``halo_exchange`` spans as JAX's does.
"""
import copy
import dataclasses
import glob
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as JO  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import perfmodel as JPM  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.core.perfmodel import (DEFAULT_CONSTANTS,  # noqa: E402
                                        ModelConstants, block_costs,
                                        layer_costs, predict_loh)
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.engine.executor import ExecStats  # noqa: E402
from repro_torch.obs import (DEFAULT_SPECS, attribution_table,  # noqa: E402
                             build_dag, build_report, compare_docs,
                             fit_stage_bw, ls_scale, nrmse, parse_spans,
                             tracing)

GEOM = PartitionConfig(n1=32, n2=8)
ROOT = os.path.join(os.path.dirname(__file__), "..")
# The JAX package's default constants, handed to the port's model where
# the two packages are compared.
JAX_CONSTANTS = JPM.DEFAULT_CONSTANTS.to_dict()


def _g(nv=90, ne=340, f=8, c=3, seed=0, pkg=G):
    g = pkg.random_graph(nv, ne, seed=seed).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _compiled(eng, name, g):
    prog = eng.compile(name, g)
    if prog.source is None:          # program-cache hit returns a slim copy
        prog = eng.compile(name, g, use_cache=False)
    return prog


def _engine() -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu")


def _jengine() -> JEngine:
    return JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)


# --------------------------------------------------------------------------- #
# perfmodel: residency-aware predict_loh, and the H100 defaults.
# --------------------------------------------------------------------------- #
def _program(name="b1", nv=90, ne=340):
    return _compiled(_engine(), name, _g(nv=nv, ne=ne)).source.program


def test_predict_loh_host_streaming_adds_staging_time():
    prog = _program()
    t_dev = predict_loh(prog, residency="device")
    t_host = predict_loh(prog, residency="host")
    t_host_serial = predict_loh(prog, residency="host", overlap=False)
    assert 0 < t_dev < t_host <= t_host_serial


def test_predict_loh_constants_injection():
    prog = _program()
    slow_pcie = ModelConstants(stage_bw=1e9)
    assert predict_loh(prog, residency="host", constants=slow_pcie) \
        > predict_loh(prog, residency="host")
    assert predict_loh(prog, residency="device", constants=slow_pcie) \
        == pytest.approx(predict_loh(prog, residency="device"))


def test_predict_loh_unknown_residency_refused():
    with pytest.raises(ValueError):
        predict_loh(_program(), residency="accelerator")


def test_layer_costs_sum_to_predict_loh_and_expose_blocks():
    prog = _program()
    lcs = layer_costs(prog, residency="host")
    assert sum(lc.t for lc in lcs) == pytest.approx(
        predict_loh(prog, residency="host"))
    bcs = block_costs(prog)
    assert sum(b.flops for b in bcs) == pytest.approx(
        sum(lc.flops for lc in lcs))
    assert all(b.t >= max(b.t_compute, b.t_memory) - 1e-18 for b in bcs)


def test_default_constants_are_the_h100_data_sheet():
    """H100 SXM5 80GB at 700 W: fp32 CUDA-core peak (the port's kernels
    are fp32), HBM3, PCIe Gen5 x16; none is a TPU figure."""
    assert DEFAULT_CONSTANTS.to_dict() == {
        "peak_flops": 67e12, "vpu_flops": 67e12, "hbm_bw": 3.35e12,
        "stage_bw": 64e9}
    assert not set(DEFAULT_CONSTANTS.to_dict().values()) & set(
        JAX_CONSTANTS.values())


@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
def test_perfmodel_equals_jax_under_equal_constants(name):
    gt, gj = _g(nv=150, ne=600), _g(nv=150, ne=600, pkg=JG)
    tp = _compiled(_engine(), name, gt).source.program
    jp = _compiled(_jengine(), name, gj).source.program
    mine = ModelConstants(**JAX_CONSTANTS)
    for residency in ("device", "host"):
        for overlap in (True, False):
            assert predict_loh(tp, overlap, residency, mine) == \
                JPM.predict_loh(jp, overlap, residency)
            got = layer_costs(tp, overlap, residency, mine)
            want = JPM.layer_costs(jp, overlap, residency)
            assert [(lc.layer_id, lc.kernel, lc.t, lc.flops)
                    for lc in got] == \
                [(lc.layer_id, lc.kernel, lc.t, lc.flops) for lc in want]


# --------------------------------------------------------------------------- #
# ExecStats.per_layer: populated everywhere, merged by add.
# --------------------------------------------------------------------------- #
def test_per_layer_populated_on_device_and_host_paths():
    g = _g()
    x = G.random_features(g, seed=1)
    eng = _engine()
    prog = _compiled(eng, "b1", g)
    for residency in ("device", "host"):
        eng.run(prog, x, residency=residency)
        rows = eng.exec_stats.per_layer
        assert rows, residency
        assert {r["kernel"] for r in rows} \
            <= {"gemm", "spdmm", "sddmm", "vadd", "act"}
        for r in rows:
            assert r["wall_s"] > 0
            assert 0 <= r["instr_lo"] <= r["instr_hi"]
        if residency == "host":
            assert sum(r.get("h2d_bytes", 0) for r in rows) \
                == eng.exec_stats.h2d_bytes > 0


def test_exec_stats_add_merges_per_layer():
    a, b = ExecStats(), ExecStats()
    a.note_layer(layer=0, kernel="gemm", step=0, instr_lo=1, instr_hi=4,
                 wall_s=0.5, tile_ops=10)
    b.note_layer(layer=0, kernel="gemm", step=0, instr_lo=1, instr_hi=4,
                 wall_s=0.25, tile_ops=5)
    b.note_layer(layer=1, kernel="spdmm", step=1, instr_lo=5, instr_hi=9,
                 wall_s=1.0, tile_ops=7)
    a.add(b)
    assert len(a.per_layer) == 2
    gemm = next(r for r in a.per_layer if r["kernel"] == "gemm")
    assert gemm["wall_s"] == pytest.approx(0.75)   # accumulated
    assert gemm["tile_ops"] == 15
    assert gemm["instr_lo"] == 1                   # identity, not summed


# --------------------------------------------------------------------------- #
# Span DAG: 4 interleaved threads, known nesting; stage stalls.
# --------------------------------------------------------------------------- #
def _ev(name, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": "t", "ts": float(ts),
            "dur": float(dur), "pid": 1, "tid": tid, "args": args}


def test_trace_dag_four_thread_round_trip_critical_path():
    evs = [
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
         "args": {"name": "main"}},
        _ev("root", 0, 1000, 0),
        _ev("c1", 10, 190, 0),
        _ev("c2", 200, 200, 0),
        _ev("c3", 400, 250, 0),
        _ev("c4", 650, 340, 0),
        _ev("w1", 5, 900, 1),
        _ev("w2", 5, 900, 2),
        _ev("w3", 5, 900, 3),
    ]
    doc = json.loads(json.dumps({"traceEvents": evs}))
    spans = parse_spans(doc)
    assert [s.track for s in spans if s.name == "root"] == ["main"]
    dag = build_dag(doc)
    root = next(s for s in dag.spans if s.name == "root")
    kids = [dag.spans[i].name for i in root.children]
    assert kids == ["c1", "c2", "c3", "c4"]
    assert all(dag.spans[i].parent == root.index for i in root.children)
    assert [s.name for s in dag.critical_path()] == \
        ["c1", "c2", "c3", "c4", "root"]
    summ = dag.summary()
    assert summ["makespan_us"] == pytest.approx(1000.0)
    assert summ["critical_path_us"] == pytest.approx(1000.0)
    assert summ["n_spans"] == 8
    assert summ == JO.build_dag(doc).summary()


def test_stage_overlap_induces_zero_stall_serialization_exposes_it():
    def trace(stage_ts, compute1_ts):
        return {"traceEvents": [
            _ev("compute", 0, 100, 0, shard=0, layer=1),
            _ev("compute", compute1_ts, 100, 0, shard=1, layer=1),
            _ev("stage", stage_ts, 40, 1, shard=1, layer=1, bytes=4096),
        ]}

    dag = build_dag(trace(stage_ts=10, compute1_ts=100))
    stage = next(s for s in dag.spans if s.name == "stage")
    assert dag.stall_us()[stage.index] == pytest.approx(0.0, abs=1e-6)
    c1 = next(s for s in dag.spans
              if s.name == "compute" and s.args["shard"] == 1)
    assert stage.index in dag.producers[c1.index]

    dag = build_dag(trace(stage_ts=100, compute1_ts=140))
    stage = next(s for s in dag.spans if s.name == "stage")
    assert dag.stall_us()[stage.index] == pytest.approx(40.0, abs=1e-2)


# --------------------------------------------------------------------------- #
# Real traced run: conformance join + calibration.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def traced_run():
    g = _g(nv=120, ne=460)
    x = G.random_features(g, seed=1)
    eng = _engine()
    prog = _compiled(eng, "b3", g)
    eng.run(prog, x, residency="host")          # warm
    with tracing() as t:
        eng.run(prog, x, residency="host")
    return prog, eng, t.events()


def test_calibrated_error_strictly_lower(traced_run):
    prog, eng, events = traced_run
    rep = build_report(prog, eng.exec_stats, residency="host",
                       events=events)
    assert rep.per_layer and rep.measured_s > 0
    for m, e in rep.model_error.items():
        assert rep.model_error_calibrated[m] <= e + 1e-12
        assert rep.scales[m] > 0
    assert rep.model_error_overall_calibrated < rep.model_error_overall
    assert "stage_bw" in rep.calibrated_constants
    assert set(rep.calibrated_constants) <= set(rep.constants)
    assert rep.constants == DEFAULT_CONSTANTS.to_dict()
    d = json.loads(json.dumps(rep.to_dict()))
    assert d["model_error_overall_calibrated"] \
        == pytest.approx(rep.model_error_overall_calibrated)
    md = rep.to_markdown()
    assert "Cost-model conformance" in md and "| mode |" in md


def test_fit_stage_bw_from_traced_stage_spans(traced_run):
    _, eng, events = traced_run
    bw = fit_stage_bw(events)
    assert bw is not None and bw > 0
    evs = [_ev("stage", 0, 1000, 0, bytes=10 ** 6),
           _ev("stage", 2000, 2000, 0, bytes=2 * 10 ** 6)]
    assert fit_stage_bw(evs) == pytest.approx(1e9)
    assert fit_stage_bw(evs) == JO.fit_stage_bw(evs)
    # The copies' device time, where the executor recorded it, wins over
    # the span's host duration (the enqueue time on a CUDA device).
    timed = [_ev("stage", 0, 1, 0, bytes=10 ** 6, copy_us=500.0),
             _ev("stage", 2000, 1, 0, bytes=2 * 10 ** 6, copy_us=1000.0)]
    assert fit_stage_bw(timed) == pytest.approx(2e9)


def test_host_stage_events_carry_bytes_and_duration(traced_run):
    _, eng, events = traced_run
    stages = [e for e in events if e.get("ph") == "X"
              and e["name"] == "stage"]
    assert stages
    assert sum(e["args"]["bytes"] for e in stages) == \
        eng.exec_stats.h2d_bytes
    for e in stages:
        assert e["args"]["bytes"] > 0 and e["dur"] > 0
        # no device copy to time on the CPU
        assert "copy_us" not in e["args"]


def test_attribution_table_joins_instruction_ranges(traced_run):
    prog, eng, events = traced_run
    rows = attribution_table(events)
    layer_rows = [r for r in rows if r["shard"] is None]
    shard_rows = [r for r in rows if r["shard"] is not None]
    assert layer_rows and shard_rows
    for r in layer_rows:
        assert 0 <= r["instr_lo"] <= r["instr_hi"]
        assert r["wall_us"] > 0
    assert sum(r["staged_bytes"] for r in layer_rows) \
        == eng.exec_stats.h2d_bytes > 0
    summ = build_dag(events).summary()
    assert 0 < summ["critical_path_us"] <= summ["makespan_us"] + 1e-3


def test_build_report_refuses_slim_or_unrun_programs(traced_run):
    prog, eng, _ = traced_run
    with pytest.raises(ValueError, match="use_cache=False"):
        build_report(types.SimpleNamespace(source=None), eng.exec_stats)
    with pytest.raises(ValueError, match="per_layer"):
        build_report(prog, ExecStats())


# --------------------------------------------------------------------------- #
# Parity with the JAX package's obs modules.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("residency", ["device", "host"])
def test_build_report_equals_jax(residency):
    """The same per-layer records, program, exec_profile, trace and
    constants fed to both packages' build_report: equal reports."""
    gt, gj = _g(nv=150, ne=600), _g(nv=150, ne=600, pkg=JG)
    x = G.random_features(gt, seed=1)
    eng = _engine()
    eng.executor.profile_tiles = True
    tprog = _compiled(eng, "b3", gt)
    with tracing() as t:
        eng.run(tprog, x, residency=residency)
    events = t.events()
    jprog = _compiled(_jengine(), "b3", gj)
    jprog.manifest["exec_profile"] = copy.deepcopy(
        tprog.manifest["exec_profile"])
    mine = build_report(tprog, eng.exec_stats, residency=residency,
                        events=events,
                        constants=ModelConstants(**JAX_CONSTANTS))
    theirs = JO.build_report(jprog, eng.exec_stats, residency=residency,
                             events=events)
    assert mine.to_dict() == theirs.to_dict()
    assert mine.to_markdown() == theirs.to_markdown()


def test_trace_analysis_equals_jax_on_a_jax_trace():
    """One JAX-shaped trace (the JAX package's own traced host run):
    span DAG summary, staging fit and attribution table agree."""
    g = _g(nv=120, ne=460, pkg=JG)
    x = jnp.asarray(JG.random_features(g, seed=1))
    je = _jengine()
    prog = _compiled(je, "b3", g)
    je.run(prog, x, residency="host")
    with JO.tracing() as t:
        je.run(prog, x, residency="host")
    events = t.events()
    assert build_dag(events).summary() == JO.build_dag(events).summary()
    assert fit_stage_bw(events) == JO.fit_stage_bw(events) is not None
    assert attribution_table(events) == JO.attribution_table(events)
    assert [dataclasses.asdict(s) for s in parse_spans(events)] == \
        [dataclasses.asdict(s) for s in JO.parse_spans(events)]


def test_trajectory_equals_jax_on_the_same_documents():
    """Every committed benchmark document against a degraded copy: the
    same specs, the same per-metric verdicts and the same report."""
    assert {k: [vars(s) for s in v] for k, v in DEFAULT_SPECS.items()} == \
        {k: [vars(s) for s in v] for k, v in JO.DEFAULT_SPECS.items()}
    paths = sorted(glob.glob(os.path.join(ROOT, "BENCH_*.json")))
    assert paths
    for path in paths:
        name = os.path.basename(path)
        with open(path) as f:
            base = json.load(f)
        fresh = _degraded(base)
        specs = DEFAULT_SPECS.get(name, [])
        mine = compare_docs(name, base, fresh, specs)
        theirs = JO.compare_docs(name, base, fresh,
                                 JO.DEFAULT_SPECS.get(name, []))
        assert [vars(r) for r in mine.results] == \
            [vars(r) for r in theirs.results]
        assert mine.ok == theirs.ok and mine.skipped == theirs.skipped


def _degraded(doc):
    """``doc`` with every number scaled by 0.7 (lists and dicts walked)."""
    if isinstance(doc, dict):
        return {k: _degraded(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_degraded(v) for v in doc]
    if isinstance(doc, bool) or not isinstance(doc, (int, float)):
        return doc
    return doc * 0.7


# --------------------------------------------------------------------------- #
# LS helpers + trajectory gate wiring.
# --------------------------------------------------------------------------- #
def test_ls_scale_is_exact_minimizer():
    pairs = [(1.0, 2.1), (2.0, 3.9), (3.0, 6.3)]
    a = ls_scale(pairs)
    for probe in (a * 0.9, a * 1.1, 1.0):
        assert nrmse(pairs, a) <= nrmse(pairs, probe) + 1e-12
    assert ls_scale([]) == 1.0
    assert nrmse([]) == 0.0
    assert a == JO.ls_scale(pairs)
    assert nrmse(pairs, a) == JO.nrmse(pairs, a)


def test_trajectory_gate_prices_model_error():
    specs = {s.path: s for s in DEFAULT_SPECS["BENCH_fullgraph.json"]}
    for mode in ("gemm", "spdmm"):
        s = specs[f"models.0.conformance.model_error.{mode}"]
        assert s.direction == "lower"
    assert specs["models.0.conformance.model_error_overall"].direction \
        == "lower"
    assert specs["models.0.conformance.calibration_gain"].direction \
        == "higher"


def test_remap_takes_a_report_of_the_port():
    """A report built here prices ``Engine.remap`` with its fitted
    constants (recorded as calibrated)."""
    g = _g()
    x = G.random_features(g, seed=1)
    eng = _engine()
    prog = _compiled(eng, "b1", g)
    eng.run(prog, x)
    rep = build_report(prog, eng.exec_stats)
    rp = eng.remap(prog, report=rep)
    rec = rp.manifest["remap"]
    assert rec["calibrated"]
    assert set(rec["constants"]) <= set(rep.calibrated_constants) | set(
        DEFAULT_CONSTANTS.to_dict())
    np.testing.assert_allclose(eng.run(rp, x).numpy(),
                               eng.run(prog, x).numpy(), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------- #
# The mesh path's halo section.
# --------------------------------------------------------------------------- #
_JAX_HALO = r"""
import json, sys
import jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[1])
from repro.core import graph as G
from repro.core.passes.partition import PartitionConfig
from repro.engine import Engine
from repro.obs import build_report
assert jax.device_count() == 4, jax.device_count()
g = G.random_graph(150, 600, seed=0).gcn_normalized()
g.feat_dim, g.n_classes = 8, 3
eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4, verify=False)
prog = eng.compile("b1", g, use_cache=False)
eng.run(prog, jnp.asarray(G.random_features(g, seed=1)), mesh=4)
print(json.dumps(build_report(prog, eng.exec_stats).halo))
"""


def test_mesh_halo_section_equals_jax():
    from repro_torch.launch.mesh import DeviceMesh
    gt, gj = _g(nv=150, ne=600), _g(nv=150, ne=600, pkg=JG)
    x = G.random_features(gt, seed=1)
    eng, je = _engine(), _jengine()
    tprog, jprog = _compiled(eng, "b1", gt), _compiled(je, "b1", gj)
    # One device: nothing crosses, no halo section in either package.
    eng.run(tprog, x, mesh=DeviceMesh(["cpu"]))
    je.run(jprog, jnp.asarray(x), mesh=1)
    assert build_report(tprog, eng.exec_stats).halo is None
    assert JO.build_report(jprog, je.exec_stats).halo is None
    # Four virtual shards: the halo section of JAX's 4-device run.
    with tracing() as t:
        eng.run(tprog, x, mesh=DeviceMesh(["cpu"] * 4))
    mine = build_report(tprog, eng.exec_stats, events=t.events())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _JAX_HALO,
                        os.path.join(ROOT, "src")], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    assert mine.halo == want and want["gathered_bytes"] > 0
    assert mine.halo == JO.build_report(jprog, eng.exec_stats).halo
    # The attribution table's halo column, from the port's trace.
    trace = t.to_dict()
    rows = attribution_table(trace)
    assert rows == JO.attribution_table(trace)
    halo_rows = [r for r in rows if r["halo_bytes"] > 0]
    assert {r["track"] for r in halo_rows} == {
        f"exec:dev{d}" for d in range(4)}
