"""The port's static verifier (``repro_torch.verify``) on device="cpu".

A twin of ``tests/test_verify.py``: every report the port's verifier
gives equals, as a dict, the JAX package's report on the same program
(the two compilers emit the same bytes and manifests for the same
inputs):

  * b1-b8 (device and host placements) and live-graph rebinds pass;
  * hand-corrupted binaries and manifests are each rejected by the named
    check, with the same violations as JAX's;
  * the ``dep_graph`` section round-trips ``.gagi``;
  * decoder robustness: clean ValueErrors on malformed bytes (the
    property-fuzzed cases skip without hypothesis, as JAX's do);
  * the race detector over a trace of the port's host-streaming path
    gives JAX's report on the same trace, and flags reordered spans;
  * ``python -m repro_torch.verify`` gives JAX's verdicts and JSON;
  * ``Engine(verify=True)`` / ``REPRO_VERIFY`` verify fresh compiles and
    live rebinds (a corrupt rebind raises ``VerifyError``), and
    ``GAGI_EXPORT_DIR`` exports every fresh compile.

One case departs from JAX on purpose
(``test_drained_rebound_remap_passes_where_jax_reports_drift``): a
remapped program rebound after a delta that drains every tile an
aggregate layer reads.  The port's ``derive_last_use`` frees the layer's
unread input at its consumer's step, as the manifest's schedule does, and
passes; JAX's keeps it live to the end and reports a ``resident_budget``
drift.  Every other report here equals JAX's.

The static placement checks (``halo_completeness``) run on bundles the
JAX compiler built for a mesh and the port loads, and on programs the
port's own ``Engine.compile(mesh=)`` builds; the race detector also reads
a trace of the port's mesh path (its ``halo_exchange`` barriers and
per-device layer spans).
"""
import copy
import json
import re
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro import livegraph as JL  # noqa: E402
from repro import verify as JV  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.isa import assemble as j_assemble  # noqa: E402
from repro.core.isa import disassemble as j_disassemble  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import CompiledProgram as JProgram  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.verify.__main__ import main as j_main  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.isa import (HEADER_BYTES, MAGIC,  # noqa: E402
                                  VERSION, Instr, Opcode, assemble,
                                  disassemble)
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import CompiledProgram, Engine  # noqa: E402
from repro_torch.engine.decoder import decode_program  # noqa: E402
from repro_torch.livegraph import (GraphDelta, GraphVersionStore,  # noqa
                                   LiveGraphServer)
from repro_torch.obs import tracing  # noqa: E402
from repro_torch.verify import (ALL_CHECKS, VerifyError,  # noqa: E402
                                check_trace, verify, verify_binary,
                                verify_gagi, verify_program)
from repro_torch.verify.__main__ import main  # noqa: E402

GEOM = PartitionConfig(n1=32, n2=8)
JGEOM = JPC(n1=32, n2=8)
BENCHES = ["b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8"]


def _g(nv=90, ne=400, f=12, c=4, seed=0, pkg=G):
    g = pkg.random_graph(nv, ne, seed=seed).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _engine(**kw) -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu", **kw)


def _jengine(**kw) -> JEngine:
    return JEngine(geometry=JGEOM, n_pes=4, verify=False, **kw)


@pytest.fixture(scope="module")
def graph():
    return _g()


@pytest.fixture(scope="module")
def jgraph():
    return _g(pkg=JG)


@pytest.fixture(scope="module")
def programs(graph):
    eng = _engine()
    return {name: eng.compile(name, graph) for name in BENCHES}


@pytest.fixture(scope="module")
def jprograms(jgraph):
    eng = _jengine()
    return {name: eng.compile(name, jgraph) for name in BENCHES}


def _same(rep, jrep):
    assert rep.to_dict() == jrep.to_dict()


def _mutated(prog, mutate, dis=disassemble, asm=assemble):
    instrs = dis(prog.binary)
    mutate(instrs)
    return asm(instrs)


# --------------------------------------------------------------------------- #
# Positives.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", BENCHES)
def test_verifier_passes_all_benches_and_matches_jax(name, programs,
                                                     jprograms):
    rep = verify(programs[name])
    assert rep.ok, rep.to_markdown()
    assert set(rep.checks_run) == set(ALL_CHECKS) - {"halo_completeness"}
    assert rep.stats["hazard_edges"]["RAW"] > 0
    assert rep.stats["hazard_edges"]["WAW"] == 0
    _same(rep, JV.verify(jprograms[name]))


@pytest.mark.parametrize("name", ["b1", "b6"])
def test_verifier_passes_host_placement_and_matches_jax(name, graph,
                                                        jgraph):
    prog = _engine().compile(name, graph, residency="host",
                             use_cache=False)
    rep = verify(prog)
    assert rep.ok, rep.to_markdown()
    _same(rep, JV.verify(_jengine().compile(name, jgraph, residency="host",
                                            use_cache=False)))


@pytest.mark.parametrize("name", ["b1", "b6"])
def test_static_placement_checks_on_mesh_bundles(name, jgraph, tmp_path):
    """A bundle the JAX compiler built for 4 devices: the port loads it
    and runs every check, the halo check included."""
    path = str(tmp_path / f"{name}-mesh.gagi")
    _jengine().compile(name, jgraph, mesh=4).save(path)
    rep = verify_gagi(path)
    assert rep.ok, rep.to_markdown()
    assert set(rep.checks_run) == set(ALL_CHECKS)
    _same(rep, JV.verify_gagi(path))


@pytest.mark.parametrize("name", ["b1", "b6"])
def test_verifier_passes_port_mesh_placements_and_matches_jax(name, graph,
                                                              jgraph):
    """The twin of test_verify.py's mesh case, on the port's own
    ``compile(mesh=4)``."""
    prog = _engine().compile(name, graph, mesh=4, use_cache=False)
    rep = verify(prog)
    assert rep.ok, rep.to_markdown()
    assert set(rep.checks_run) == set(ALL_CHECKS)   # halo check ran
    _same(rep, JV.verify(_jengine().compile(name, jgraph, mesh=4,
                                            use_cache=False)))


def test_verify_on_port_mesh_compile_and_run(graph):
    """``Engine(verify=True)`` verifies a mesh compile; the program then
    runs on virtual CPU shards with the device path's bits."""
    from repro_torch.launch.mesh import DeviceMesh
    eng = _engine(verify=True)
    prog = eng.compile("b6", graph, mesh=2)
    x = G.random_features(graph, seed=4)
    assert torch.equal(eng.run(prog, x, mesh=DeviceMesh(["cpu"] * 2)),
                       eng.run(prog, x))


def test_verifier_passes_livegraph_rebind(graph, jgraph):
    live = LiveGraphServer(GraphVersionStore(graph, geometry=GEOM))
    jlive = JL.LiveGraphServer(JL.GraphVersionStore(jgraph, geometry=JGEOM))
    eng, jeng = _engine(), _jengine()
    _same(verify(eng.compile("b1", live)), JV.verify(jeng.compile("b1",
                                                                  jlive)))
    i = 9
    pair = (int(graph.src[i]), int(graph.dst[i]))
    for Delta, srv in ((GraphDelta, live), (JL.GraphDelta, jlive)):
        srv.apply(Delta(graph.n_vertices).remove_edge(*pair)
                  .add_edge(*pair, 123.0))
    p1 = eng.compile("b1", live)
    assert p1.manifest.get("graph_version") == 1
    rep = verify(p1)
    assert rep.ok
    _same(rep, JV.verify(jeng.compile("b1", jlive)))
    for Delta, srv in ((GraphDelta, live), (JL.GraphDelta, jlive)):
        srv.apply(Delta(srv.n_vertices).add_edge(1, 2, 0.5))
    rep = verify(eng.compile("b1", live))
    assert rep.ok
    _same(rep, JV.verify(jeng.compile("b1", jlive)))


def test_bytes_only_verification_runs_structure_check(programs):
    rep = verify_binary(programs["b1"].binary)
    assert rep.ok and rep.checks_run == ["structure"]
    assert set(rep.checks_skipped) == set(ALL_CHECKS) - {"structure"}
    _same(rep, JV.verify_binary(programs["b1"].binary))


def test_bytes_plus_manifest_runs_semantic_checks(programs):
    prog = programs["b3"]
    rep = verify_binary(prog.binary, manifest=prog.manifest)
    assert rep.ok, rep.to_markdown()
    for c in ("def_before_use", "partition_coverage", "kernel_legality",
              "liveness_schedule"):
        assert c in rep.checks_run
    assert "resident_budget" in rep.checks_skipped
    _same(rep, JV.verify_binary(prog.binary, manifest=prog.manifest))


def test_dep_graph_round_trips_through_gagi(programs, tmp_path):
    prog = programs["b1"]
    dg = prog.manifest["dep_graph"]
    assert dg["n_tile_nodes"] == sum(len(lp.tiles)
                                     for lp in prog.plan().layers)
    assert dg["edge_counts"]["WAW"] == 0 and dg["edge_counts"]["WAR"] == 0
    path = str(tmp_path / "b1.gagi")
    prog.save(path)
    loaded = CompiledProgram.load(path)
    assert loaded.manifest["dep_graph"] == dg
    assert verify(loaded).ok
    _same(verify_gagi(path), JV.verify_gagi(path))


def test_dep_graph_layer_edges_follow_manifest_parents(programs):
    dg = programs["b2"].manifest["dep_graph"]
    steps = {layer["id"]: layer["step"] for layer in dg["layers"]}
    for a, b, kind in dg["layer_edges"]:
        assert kind == "RAW" and steps[a] < steps[b]


# --------------------------------------------------------------------------- #
# Negatives: each corruption caught by its check, with JAX's violations.
# --------------------------------------------------------------------------- #
def _retarget_mem_wr(instrs):
    for ins in instrs:
        if ins.op == Opcode.MEM_WR and ins.flags:
            ins.args = (*ins.args[:3], (ins.args[3] + 1) % 3)
            return


def _bad_gather_source(instrs):
    for ins in instrs:
        if ins.op == Opcode.SPDMM:
            ins.args = (ins.args[0], 99, ins.args[2], ins.args[3])
            return


def _wrong_macs(instrs):
    for ins in instrs:
        if ins.op == Opcode.GEMM:
            ins.arg4 += 1
            return


def _stale_nnz(instrs):
    for ins in instrs:
        if ins.op == Opcode.SPDMM and ins.arg4 > 0:
            ins.arg4 -= 1
            return


def _after_halt(instrs):
    instrs.append(Instr(op=Opcode.NOP))


def _wrong_block_count(instrs):
    for ins in instrs:
        if ins.op == Opcode.CSI:
            ins.arg4 += 1
            return


CORRUPTIONS = {
    "duplicated_output_tile": (_retarget_mem_wr, "partition_coverage"),
    "out_of_range_gather_source": (_bad_gather_source, "def_before_use"),
    "wrong_mac_count": (_wrong_macs, "kernel_legality"),
    "stale_nnz": (_stale_nnz, "kernel_legality"),
    "instructions_after_halt": (_after_halt, "structure"),
    "wrong_tiling_block_count": (_wrong_block_count, "structure"),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_rejects_corrupted_binary(case, programs, jprograms):
    mutate, check = CORRUPTIONS[case]
    prog, jprog = programs["b1"], jprograms["b1"]
    rep = verify_binary(_mutated(prog, mutate), manifest=prog.manifest,
                        pgraph=prog.pgraph)
    assert not rep.ok and check in rep.checks_failed
    jrep = JV.verify_binary(_mutated(jprog, mutate, j_disassemble,
                                     j_assemble),
                            manifest=jprog.manifest, pgraph=jprog.pgraph)
    _same(rep, jrep)


def test_rejects_freed_value_read(programs, jprograms):
    reps = []
    for prog, vb in ((programs["b1"], verify_binary),
                     (jprograms["b1"], JV.verify_binary)):
        man = copy.deepcopy(prog.manifest)
        producer = man["dep_graph"]["layer_edges"][0][0]
        man["residency"]["last_use"][str(producer)] = 0
        reps.append(vb(prog.binary, manifest=man, pgraph=prog.pgraph))
    assert not reps[0].ok
    assert {"use_after_free", "liveness_schedule"} <= \
        set(reps[0].checks_failed)
    _same(*reps)


def test_rejects_incomplete_halo_set(jgraph, tmp_path):
    path = str(tmp_path / "mesh2.gagi")
    _jengine().compile("b1", jgraph, mesh=2).save(path)
    prog = CompiledProgram.load(path)
    man = copy.deepcopy(prog.manifest)
    done = False
    for rec in man["placement"]["layers"].values():
        for d, ks in rec["halo"].items():
            if ks:
                rec["halo"][d] = ks[1:]
                done = True
                break
        if done:
            break
    assert done
    rep = verify_binary(prog.binary, manifest=man, pgraph=prog.pgraph)
    assert not rep.ok and "halo_completeness" in rep.checks_failed
    jprog = JProgram.load(path)
    _same(rep, JV.verify_binary(jprog.binary, manifest=man,
                                pgraph=jprog.pgraph))


def test_rejects_incomplete_halo_set_on_port_mesh_program(graph, jgraph):
    reps = []
    for eng, vb in ((_engine(), verify_binary), (_jengine(),
                                                 JV.verify_binary)):
        g = graph if vb is verify_binary else jgraph
        prog = eng.compile("b1", g, mesh=2)
        man = copy.deepcopy(prog.manifest)
        stripped = False
        for rec in man["placement"]["layers"].values():
            for d, ks in rec["halo"].items():
                if ks:
                    rec["halo"][d] = ks[1:]
                    stripped = True
                    break
            if stripped:
                break
        assert stripped, "a mesh=2 placement has a non-empty halo"
        reps.append(vb(prog.binary, manifest=man, pgraph=prog.pgraph))
    assert not reps[0].ok and "halo_completeness" in reps[0].checks_failed
    _same(*reps)


def test_rejects_residency_drift_from_budget_estimate(programs, jprograms):
    reps = []
    for prog, Prog, vp in ((programs["b1"], CompiledProgram,
                            verify_program),
                           (jprograms["b1"], JProgram, JV.verify_program)):
        bad = Prog(binary=prog.binary, manifest=copy.deepcopy(prog.manifest),
                   weights=prog.weights, pgraph=prog.pgraph)
        last = bad.manifest["residency"]["last_use"]
        lid = min(int(k) for k in last if int(k) >= 0)
        last[str(lid)] = len(bad.manifest["dep_graph"]["layers"]) + 5
        reps.append(vp(bad))
    assert not reps[0].ok and "resident_budget" in reps[0].checks_failed
    _same(*reps)


def test_drained_rebound_remap_passes_where_jax_reports_drift():
    """Cora in one tile (n1=4096), b1 remapped with force="gemm", then a
    delta that removes every edge, rebound: the tile is priced skip, so
    no instruction reads the aggregate layer's input.  JAX's verifier
    keeps that value live to the end and reports the budget drift (the
    fault); the port's frees it at its consumer's step, as the schedule
    does, and its report is JAX's with that drift removed."""
    reps = {}
    for name, pkg, L, Eng, PC, vp in (
            ("port", G, None, Engine, PartitionConfig, verify_program),
            ("jax", JG, JL, JEngine, JPC, JV.verify_program)):
        co = pkg.synthesize("CO").gcn_normalized()
        geom = PC(n1=4096, n2=128)
        store = (GraphVersionStore if L is None else L.GraphVersionStore)(
            co, geometry=geom)
        eng = (Engine(geometry=geom, device="cpu", verify=True)
               if L is None else Eng(geometry=geom, verify=False))
        eng.remap(eng.compile("b1", store.head.as_graph()), force="gemm")
        (jk,) = store.head.store.edges
        te = store.head.store.edges[jk]
        d = (GraphDelta if L is None else L.GraphDelta)(co.n_vertices)
        for u, w in sorted(set(zip(te.src.tolist(), te.dst.tolist()))):
            d.remove_edge(u, w)
        p1 = eng.compile("b1", store.apply(d).as_graph())   # verified
        assert p1.manifest["remap"]["counts"] == {"spdmm": 0, "gemm": 0,
                                                   "skip": 1}
        reps[name] = vp(p1)
        if L is None:
            x = G.random_features(co, seed=0)
            assert torch.equal(eng.run(p1, x),
                               eng.run(p1, x, residency="host"))
    jrep = reps["jax"].to_dict()
    assert not reps["jax"].ok and jrep["checks_failed"] == ["resident_budget"]
    (v,) = jrep["violations"]
    assert "32051292" in v["message"] and "29954140" in v["message"]
    jrep.update(ok=True, checks_failed=[], violations=[],
                checks_passed=list(jrep["checks_run"]))
    jrep["stats"]["device_peak_bytes"] = 29954140
    assert reps["port"].to_dict() == jrep


def test_engine_compile_verify_raises_on_corrupt_rebind(graph):
    live = LiveGraphServer(GraphVersionStore(graph, geometry=GEOM))
    eng = _engine(verify=True)
    prog = eng.compile("b1", live)
    bad = CompiledProgram(binary=_mutated(prog, _bad_gather_source),
                          manifest=prog.manifest, weights=prog.weights,
                          pgraph=prog.pgraph, cache_key=prog.cache_key)
    eng.cache.put(prog.cache_key, bad)
    with pytest.raises(VerifyError) as ei:
        eng.compile("b1", live)
    assert "def_before_use" in str(ei.value)


def test_verify_switches_follow_the_jax_env_names(graph, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("REPRO_VERIFY", "1")
    monkeypatch.setenv("GAGI_EXPORT_DIR", str(tmp_path / "gagi"))
    eng = _engine()
    assert eng.verify and not _engine(verify=False).verify
    eng.compile("b1", graph)
    eng.compile("b1", graph)                    # a hit: not exported again
    live = LiveGraphServer(GraphVersionStore(graph, geometry=GEOM))
    eng.compile("b6", live)
    files = sorted(p.name for p in (tmp_path / "gagi").iterdir())
    assert len(files) == 2 and all(f.endswith(".gagi") for f in files)
    assert main([str(tmp_path / "gagi"), "-q"]) == 0
    monkeypatch.setenv("REPRO_VERIFY", "0")
    assert not _engine().verify


def test_engine_remap_verifies_with_verify_on(graph):
    eng = _engine(verify=True)
    rp = eng.remap(eng.compile("b1", graph), force="gemm")
    assert rp.manifest["remap"]["counts"]["gemm"] > 0


# --------------------------------------------------------------------------- #
# Decoder robustness.
# --------------------------------------------------------------------------- #
def test_disassemble_rejects_malformed_payloads(programs):
    blob = programs["b1"].binary
    with pytest.raises(ValueError, match="truncated"):
        disassemble(blob[:-1])
    with pytest.raises(ValueError, match="header"):
        disassemble(blob[:8])
    with pytest.raises(ValueError, match="trailing"):
        disassemble(blob + b"\x00")
    n = struct.unpack_from("<IIII", blob, 0)[2]
    lying = struct.pack("<IIII", MAGIC, VERSION, n + 1, 0) \
        + blob[HEADER_BYTES:]
    with pytest.raises(ValueError, match=f"announces {n + 1}"):
        disassemble(lying)
    bad = bytearray(blob)
    bad[HEADER_BYTES] = 0xEE
    with pytest.raises(ValueError) as ei:
        disassemble(bytes(bad))
    assert "opcode" in str(ei.value) and "instruction 0" in str(ei.value)


def test_decode_rejects_unknown_layer_type_and_region(programs):
    with pytest.raises(ValueError, match="layer type 13"):
        decode_program([Instr(op=Opcode.CSI, args=(0, 13, 8, 8), arg4=0),
                        Instr(op=Opcode.HALT)])
    instrs = list(disassemble(programs["b1"].binary))
    for i, ins in enumerate(instrs):
        if ins.op == Opcode.MEM_WR:
            instrs[i] = Instr(op=Opcode.MEM_WR, pe=ins.pe, flags=ins.flags,
                              args=(ins.args[0], 15, *ins.args[2:]),
                              arg4=ins.arg4)
            break
    with pytest.raises(ValueError, match="unknown region 15"):
        decode_program(instrs)


def test_verify_binary_never_raises_on_garbage():
    for blob in (b"", b"junk", b"\x00" * 64,
                 struct.pack("<IIII", MAGIC, 99, 0, 0)):
        rep = verify_binary(blob)
        assert not rep.ok and rep.checks_failed == ["structure"]
        _same(rep, JV.verify_binary(blob))


@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_fuzzed_mutations_never_crash_the_decoder(data, programs):
    name = data.draw(st.sampled_from(BENCHES))
    blob = bytearray(programs[name].binary)
    i = data.draw(st.integers(0, len(blob) - 1))
    blob[i] ^= 1 << data.draw(st.integers(0, 7))
    prog = programs[name]
    try:
        verify_binary(bytes(blob), manifest=prog.manifest,
                      pgraph=prog.pgraph)
    except ValueError:
        pytest.fail("verify_binary must absorb decode errors")


@settings(max_examples=30, deadline=None)
@given(junk=st.binary(max_size=256))
def test_fuzzed_junk_is_rejected_with_valueerror(junk):
    if junk[:4] == struct.pack("<I", MAGIC):
        junk = b"\x00" + junk[1:]
    with pytest.raises(ValueError):
        disassemble(junk)


# --------------------------------------------------------------------------- #
# Race detector over a trace of the port's host-streaming path.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def host_trace(graph):
    eng = _engine()
    prog = eng.compile("b1", graph)
    x = G.random_features(graph, seed=2)
    with tracing() as t:
        eng.run(prog, x, residency="host")
    return t.to_dict(), prog


def test_race_detector_validates_streaming_overlap(host_trace):
    trace, prog = host_trace
    rep = check_trace(trace, prog)
    assert rep.ok, rep.to_markdown()
    assert {"race_layer_order", "race_stage_before_compute"} <= \
        set(rep.checks_run)
    assert rep.stats["overlap_pairs"] > 0
    _same(rep, JV.check_trace(trace, prog.manifest))


def test_race_detector_flags_stage_after_compute(host_trace):
    trace, prog = host_trace
    trace = json.loads(json.dumps(trace))
    evs = trace["traceEvents"]
    moved = False
    for ev in evs:
        if ev.get("ph") == "X" and ev.get("name") == "stage":
            key = (ev["args"].get("shard"), ev["args"].get("layer"))
            for c in evs:
                if c.get("ph") == "X" and c.get("name") == "compute" and \
                        (c["args"].get("shard"),
                         c["args"].get("layer")) == key:
                    ev["ts"] = c["ts"] + 1.0
                    moved = True
                    break
        if moved:
            break
    assert moved
    rep = check_trace(trace, prog)
    assert not rep.ok and "race_stage_before_compute" in rep.checks_failed
    _same(rep, JV.check_trace(trace, prog.manifest))


def test_race_detector_flags_reordered_layer_spans(host_trace):
    trace, prog = host_trace
    trace = json.loads(json.dumps(trace))
    lay = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and re.match(r"^layer\d+$", e.get("name", ""))]
    assert len(lay) >= 2
    lay[-1]["ts"] = lay[0]["ts"] - 5.0
    rep = check_trace(trace, prog)
    assert not rep.ok and rep.checks_failed == ["race_layer_order"]
    _same(rep, JV.check_trace(trace, prog.manifest))


@pytest.fixture(scope="module")
def mesh_trace(graph):
    from repro_torch.launch.mesh import DeviceMesh
    eng = _engine()
    prog = eng.compile("b6", graph, mesh=4)
    x = G.random_features(graph, seed=2)
    with tracing() as t:
        eng.run(prog, x, mesh=DeviceMesh(["cpu"] * 4))
    return t.to_dict(), prog


def test_race_detector_over_port_mesh_trace(mesh_trace):
    trace, prog = mesh_trace
    rep = check_trace(trace, prog)
    assert rep.ok, rep.to_markdown()
    assert {"race_layer_order", "race_halo_barrier"} <= set(rep.checks_run)
    _same(rep, JV.check_trace(trace, prog.manifest))
    tracks = {e.get("tid") for e in trace["traceEvents"]
              if e.get("ph") == "X" and re.match(r"^layer\d+$",
                                                 e.get("name", ""))}
    assert len(tracks) == 4                 # one track per mesh device


def test_race_detector_flags_compute_inside_halo_exchange(mesh_trace):
    trace, prog = mesh_trace
    trace = json.loads(json.dumps(trace))
    evs = trace["traceEvents"]
    halo = next(e for e in evs if e.get("ph") == "X"
                and e.get("name") == "halo_exchange")
    lay = next(e for e in evs if e.get("ph") == "X"
               and e.get("name") == f"layer{halo['args']['layer']}")
    halo["dur"] = max(halo.get("dur", 0), 10.0)
    lay["ts"], lay["dur"] = halo["ts"] + 1.0, 5.0
    rep = check_trace(trace, prog)
    assert not rep.ok and "race_halo_barrier" in rep.checks_failed
    _same(rep, JV.check_trace(trace, prog.manifest))


def test_race_detector_without_manifest_skips_layer_check(host_trace):
    trace, _ = host_trace
    rep = check_trace(trace)
    assert rep.ok and "race_layer_order" in rep.checks_skipped
    assert "race_stage_before_compute" in rep.checks_run
    _same(rep, JV.check_trace(trace))


# --------------------------------------------------------------------------- #
# Command line.
# --------------------------------------------------------------------------- #
def test_cli_verifies_gagi_bundles(programs, tmp_path, capsys):
    for name in ("b1", "b7"):
        programs[name].save(str(tmp_path / f"{name}.gagi"))
    out = {}
    for tag, fn in (("port", main), ("jax", j_main)):
        js, md = tmp_path / f"{tag}.json", tmp_path / f"{tag}.md"
        assert fn([str(tmp_path), "--json", str(js), "--md", str(md)]) == 0
        out[tag] = json.loads(js.read_text())
        assert "PASS" in md.read_text()
    assert out["port"]["ok"] and len(out["port"]["reports"]) == 2
    assert out["port"] == out["jax"]
    assert "[PASS]" in capsys.readouterr().out


def test_cli_fails_on_corrupt_bundle(programs, tmp_path):
    prog = programs["b1"]
    bad = CompiledProgram(binary=_mutated(prog, _wrong_macs),
                          manifest=prog.manifest, weights=prog.weights,
                          pgraph=prog.pgraph)
    path = str(tmp_path / "bad.gagi")
    bad.save(path)
    js = tmp_path / "report.json"
    assert main([path, "--json", str(js), "-q"]) == 1
    payload = json.loads(js.read_text())
    assert not payload["ok"]
    assert "kernel_legality" in payload["reports"][0]["checks_failed"]
    jjs = tmp_path / "jax.json"
    assert j_main([path, "--json", str(jjs), "-q"]) == 1
    assert payload == json.loads(jjs.read_text())


def test_cli_with_trace_checks_the_recorded_order(programs, host_trace,
                                                  tmp_path):
    trace, prog = host_trace
    path = str(tmp_path / "b1.gagi")
    prog.save(path)
    tpath = tmp_path / "trace.json"
    tpath.write_text(json.dumps(trace))
    js = tmp_path / "r.json"
    assert main([path, "--trace", str(tpath), "--json", str(js), "-q"]) == 0
    reps = json.loads(js.read_text())["reports"]
    assert len(reps) == 2 and reps[1]["program"].endswith("[trace]")
