"""The port's placement-scheduled multi-device path (``mesh=``) on the CPU.

A twin of ``tests/test_placement.py`` over the port's Engine, run on
virtual shards of the CPU (``DeviceMesh(["cpu"] * D)``, the torch
counterpart of ``--xla_force_host_platform_device_count``):

  * the mesh output at D = 1..4 is bit for bit the port's device path
    (``torch.equal``) for b1-b8 and gat-dot, on uniform and power-law
    graphs, and within rtol 2e-4 / atol 2e-5 of the JAX package's mesh
    run on its one CPU device;
  * the derivation path (a program compiled without ``mesh=``, a bundle
    whose manifest lost its placement) runs the same bits, and the
    derived schedule is the emitted one, equal to JAX's;
  * ``run_batch`` lanes on a mesh equal solo runs;
  * per-device stats sum to the device path's, ``halo_bytes`` equals the
    manifest's, ``device_imbalance >= 1``, and work spreads over
    ``min(D, n_blocks)`` devices;
  * graph-as-data, host residency and a mesh of another device type are
    refused, as is ``make_device_mesh`` past the device count;
  * at D = 4 the per-device records, ``halo_gather_bytes`` and per-layer
    records equal those of JAX's 4-device mesh run (in a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``; the test
    process gives JAX one CPU device), and the outputs agree within
    tolerance.
"""
import json
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
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import (CompiledProgram, Engine,  # noqa: E402
                                derive_placement, ensure_placement)
from repro_torch.launch.mesh import DeviceMesh, make_device_mesh  # noqa

GEOM = PartitionConfig(n1=32, n2=8)
JGEOM = JPC(n1=32, n2=8)
RTOL, ATOL = 2e-4, 2e-5
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
MODELS = ["b1", "b2", "b3", "b4", "b5", "b6", "b7", "b8", "gat-dot"]


def _g(nv=160, ne=800, f=12, c=4, seed=0, pkg=G, degree="uniform"):
    g = pkg.random_graph(nv, ne, seed=seed, degree=degree).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _engine() -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu")


def _jengine() -> JEngine:
    return JEngine(geometry=JGEOM, n_pes=4, verify=False)


def _mesh(d: int) -> DeviceMesh:
    return DeviceMesh(["cpu"] * d)


def _model(pkg, name, g):
    if name == "gat-dot":
        return build_gat_dot(TB if pkg is G else JB, g)
    return name


# --------------------------------------------------------------------------- #
# Bit identity to the device path, tolerance to JAX.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("gseed,degree", [(3, "uniform"),
                                          (21, "powerlaw")])
def test_mesh_is_bit_identical(name, gseed, degree):
    g = _g(seed=gseed, degree=degree)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile(_model(G, name, g), g, mesh=4)
    y_dev = eng.run(prog, x)
    for d in (1, 2, 3, 4):
        assert torch.equal(eng.run(prog, x, mesh=_mesh(d)), y_dev), d
    if gseed != 3:
        return
    jg = _g(seed=gseed, degree=degree, pkg=JG)
    je = _jengine()
    jy = je.run(je.compile(_model(JG, name, jg), jg), jnp.asarray(x),
                mesh=1)
    np.testing.assert_allclose(y_dev.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=ATOL)


def test_mesh_knob_as_a_count_takes_the_engine_device_type():
    g = _g(seed=5)
    x = G.random_features(g, seed=1)
    eng = _engine()
    prog = eng.compile("b1", g)
    assert torch.equal(eng.run(prog, x, mesh=1), eng.run(prog, x))
    assert eng.exec_stats.n_devices == 1
    with pytest.raises(ValueError, match="available"):
        eng.run(prog, x, mesh=2)          # the CPU is one device


# --------------------------------------------------------------------------- #
# Placement schedule: equal to JAX's, and the derivation fallback.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,d", [("b1", 3), ("b6", 4), ("gat-dot", 2)])
def test_placement_equals_jax_and_derivation(name, d):
    g, jg = _g(seed=13), _g(seed=13, pkg=JG)
    prog = _engine().compile(_model(G, name, g), g, mesh=d)
    emitted = prog.manifest["placement"]
    assert emitted == _jengine().compile(_model(JG, name, jg), jg,
                                         mesh=d).manifest["placement"]
    assert derive_placement(prog.plan(), prog.manifest["residency"],
                            prog.manifest["geometry"], d) == emitted


def test_mesh_derivation_path_is_bit_identical(tmp_path):
    g = _g(seed=29)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile("b3", g)              # no placement section
    assert "placement" not in prog.manifest
    y_dev = eng.run(prog, x)
    assert torch.equal(eng.run(prog, x, mesh=_mesh(3)), y_dev)
    assert prog.manifest["placement"]["n_devices"] == 3   # attached
    # An old bundle: saved with a placement, which is then dropped.
    emitted = eng.compile("b3", g, mesh=4).manifest["placement"]
    path = str(tmp_path / "old.gagi")
    prog.save(path)
    loaded = eng.load(path)
    loaded.manifest.pop("placement")
    assert ensure_placement(loaded, 4) == emitted
    assert loaded.manifest["placement"] == emitted
    loaded.manifest.pop("placement")
    assert torch.equal(eng.run(loaded, x, mesh=_mesh(4)), y_dev)
    # ... and the derived schedule round-trips .gagi.
    loaded.save(path)
    assert CompiledProgram.load(path).manifest["placement"] == emitted


def test_compile_with_mesh_on_a_cache_hit_attaches_placement():
    g = _g(seed=23)
    eng = _engine()
    assert "placement" not in eng.compile("b1", g).manifest
    assert eng.compile("b1", g, mesh=2).manifest["placement"][
        "n_devices"] == 2
    assert eng.stats.compiles == 1
    assert eng.compile("b1", g, mesh=_mesh(3)).manifest["placement"][
        "n_devices"] == 3


# --------------------------------------------------------------------------- #
# Batches and per-device stats.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["b1", "gat-dot"])
def test_mesh_run_batch_lanes_equal_solo(name):
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    xs = np.stack([x, x * 0.5, -x])
    eng = _engine()
    prog = eng.compile(_model(G, name, g), g)
    ym = eng.run_batch(prog, xs, mesh=_mesh(3))
    st = eng.exec_stats
    assert st.runs == 1 and st.n_devices == 3      # one logical pass
    yd = eng.run_batch(prog, xs)
    assert torch.equal(ym, yd)
    for n in range(3):
        assert torch.equal(ym[n], eng.run(prog, xs[n], mesh=_mesh(3)))


@pytest.mark.parametrize("name", ["b6", "gat-dot"])
@pytest.mark.parametrize("d", [2, 4])
def test_mesh_exec_stats_per_device(name, d):
    g = _g(seed=31)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile(_model(G, name, g), g, mesh=d)
    eng.run(prog, x)
    dev_ops = eng.exec_stats.tile_ops
    eng.run(prog, x, mesh=_mesh(d))
    st = eng.exec_stats
    assert st.n_devices == d and len(st.per_device) == d
    assert sum(r["tile_ops"] for r in st.per_device) == dev_ops == \
        st.tile_ops
    assert sum(r["blocks"] for r in st.per_device) == prog.pgraph.n_blocks
    assert st.device_imbalance >= 1.0
    pl = prog.manifest["placement"]
    assert st.halo_bytes == pl["halo_bytes_total"] > 0
    assert st.halo_gather_bytes == sum(
        r["halo_gather_bytes"] for r in st.per_layer) > 0
    assert st.peak_device_bytes > 0
    # the lifetime total merges per-device records across runs
    eng.run(prog, x, mesh=_mesh(d))
    tot = {r["device"]: r for r in eng.exec_stats_total.per_device}
    for r in st.per_device:
        assert tot[r["device"]]["tile_ops"] == 2 * r["tile_ops"]


@pytest.mark.parametrize("d", [2, 3, 4, 8])
def test_mesh_spreads_work_across_devices(d):
    g = _g(seed=37)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile("b1", g, mesh=d)
    eng.run(prog, x, mesh=_mesh(d))
    busy = [r for r in eng.exec_stats.per_device if r["tile_ops"] > 0]
    assert len(busy) == min(d, prog.pgraph.n_blocks)


def test_mesh_stages_only_owned_blocks():
    from repro_torch.engine.executor import _staged
    g = _g(seed=41)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile("b1", g, mesh=2)
    eng.run(prog, x, mesh=_mesh(2))
    pl = prog.manifest["placement"]
    for d in range(2):
        owned = tuple(j for j, a in enumerate(pl["assignment"]) if a == d)
        st = _staged(prog.pgraph, torch.device("cpu"), owned)
        assert {j for j, _, _ in st.tiles("cols")} == set(owned)


# --------------------------------------------------------------------------- #
# Refusals.
# --------------------------------------------------------------------------- #
def test_mesh_refusals():
    g = _g(seed=41)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile("b1", g)
    with pytest.raises(ValueError, match="device-resident"):
        eng.run(prog, x, graph_data={"tiles": {}}, mesh=_mesh(2))
    with pytest.raises(ValueError, match="device-resident"):
        eng.run_batch(prog, np.stack([x]), graph_data={"tiles": {}},
                      mesh=_mesh(2))
    with pytest.raises(ValueError, match="does not compose"):
        eng.run(prog, x, residency="host", mesh=_mesh(2))
    # A CPU executor never runs a CUDA mesh (nor the reverse).
    with pytest.raises(ValueError, match="device type"):
        eng.run(prog, x, mesh=DeviceMesh(["cuda:0", "cuda:0"]))
    with pytest.raises(ValueError, match="one device type"):
        DeviceMesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError):
        DeviceMesh([])


def test_make_device_mesh_validates():
    m = make_device_mesh(device_type="cpu")
    assert m.axis_names == ("dev",) and m.size == 1
    assert m.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="available"):
        make_device_mesh(2, device_type="cpu")
    with pytest.raises(ValueError):
        make_device_mesh(0, device_type="cpu")
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        make_device_mesh(n_cuda + 1)


# --------------------------------------------------------------------------- #
# Against JAX's 4-device mesh (a subprocess with forced host devices).
# --------------------------------------------------------------------------- #
_JAX_MESH = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[1])
from repro.core import graph as G
from repro.core.passes.partition import PartitionConfig
from repro.engine import Engine
assert jax.device_count() == 4, jax.device_count()
out = {}
for name, seed, degree in json.loads(sys.argv[2]):
    g = G.random_graph(160, 800, seed=seed, degree=degree).gcn_normalized()
    g.feat_dim, g.n_classes = 12, 4
    x = jnp.asarray(G.random_features(g, seed=2))
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4,
                 verify=False)
    prog = eng.compile(name, g, mesh=4)
    y = eng.run(prog, x, mesh=4)
    st = eng.exec_stats
    out[name + ":" + degree] = {
        "y": np.asarray(y).tolist(), "per_device": st.per_device,
        "halo_gather_bytes": st.halo_gather_bytes,
        "halo_bytes": st.halo_bytes, "tile_ops": st.tile_ops,
        "per_layer": [{k: v for k, v in r.items() if k != "wall_s"}
                      for r in st.per_layer]}
print(json.dumps(out))
"""


def run_jax_mesh(cases):
    """JAX's 4-device mesh runs of ``cases`` ([(model, graph seed,
    degree)], graphs as :func:`_g` makes them), in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_MESH, os.path.join(ROOT, "src"),
         json.dumps(cases)], env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_d4_stats_equal_jax_four_device_mesh():
    cases = [("b1", 3, "uniform"), ("b3", 21, "powerlaw"),
             ("b6", 3, "uniform")]
    want = run_jax_mesh(cases)
    for name, seed, degree in cases:
        w = want[f"{name}:{degree}"]
        g = _g(seed=seed, degree=degree)
        x = G.random_features(g, seed=2)
        eng = _engine()
        prog = eng.compile(name, g, mesh=4)
        y = eng.run(prog, x, mesh=_mesh(4))
        st = eng.exec_stats
        assert st.per_device == w["per_device"], name
        assert st.halo_gather_bytes == w["halo_gather_bytes"] > 0
        assert st.halo_bytes == w["halo_bytes"]
        assert st.tile_ops == w["tile_ops"]
        assert [{k: v for k, v in r.items() if k != "wall_s"}
                for r in st.per_layer] == w["per_layer"], name
        np.testing.assert_allclose(y.numpy(), np.asarray(w["y"]),
                                   rtol=RTOL, atol=ATOL)
