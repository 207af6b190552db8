"""The port's host-streaming residency (``residency="host"``) on the CPU.

A twin of ``tests/test_fullgraph.py`` (apart from its graph-as-data test,
which waits for the sampling layer): the partition-centric path, features
and layer outputs host-resident and one destination shard's working set
staged at a time, is bit-identical (``torch.equal``) to the port's
device-resident path for GCN / SAGE / GAT, batches interleave their lanes
per staged shard, interval liveness frees outputs on both residencies,
and ``resident_budget_bytes`` refuses the device path where streaming
still runs.  The host path is also held against the JAX package's host
path for the same seeded inputs at rtol 2e-4 / atol 2e-5.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_models import build_gat_dot  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import Engine, ResidentBudgetError  # noqa: E402

GEOM = PartitionConfig(n1=32, n2=8)
RTOL, ATOL = 2e-4, 2e-5


def _g(nv=90, ne=400, f=12, c=4, seed=0, pkg=G, degree="uniform"):
    g = pkg.random_graph(nv, ne, seed=seed, degree=degree).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _engine(**kw) -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu", **kw)


# --------------------------------------------------------------------------- #
# Bit-exactness: streaming == resident, for GCN (b1), SAGE (b3), GAT (b6).
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
@pytest.mark.parametrize("gseed", [3, 21])
def test_host_resident_is_bit_identical(name, gseed):
    g = _g(seed=gseed)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile(name, g)
    y_dev = eng.run(prog, x)
    y_host = eng.run(prog, x, residency="host")
    assert torch.equal(y_dev, y_host)
    st = eng.exec_stats
    # the streaming pass actually streamed (several shards staged)
    assert st.shards_streamed > 1
    assert st.h2d_bytes > 0
    assert st.h2d_bytes == sum(r["h2d_bytes"] for r in st.per_layer)
    assert 0 < st.peak_stage_bytes < st.h2d_bytes


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_gat_dot_host_is_bit_identical(backend):
    # Dot-mode SDDMM, a fused edge softmax and dynamic edge weights on a
    # power-law graph; backend "cuda" runs the kernels' plain versions.
    g = _g(nv=150, ne=1200, seed=5, degree="powerlaw")
    for lrelu in (True, False):
        m = build_gat_dot(TB, g, hidden=16, lrelu=lrelu)
        xs = np.stack([G.random_features(g, seed=s) for s in (1, 2)])
        eng = _engine(backend=backend)
        prog = eng.compile(m, g)
        assert torch.equal(eng.run_batch(prog, xs),
                           eng.run_batch(prog, xs, residency="host"))


def test_run_batch_host_matches_device():
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    xs = np.stack([x, x * 0.5, x * -1.0])
    eng = _engine()
    prog = eng.compile("b1", g)
    yd = eng.run_batch(prog, xs)
    yh = eng.run_batch(prog, xs, residency="host")
    assert torch.equal(yd, yh)


@pytest.mark.parametrize("name", ["b1", "b6"])
def test_host_batch_interleaves_lanes_and_amortizes_h2d(name):
    """Host-path batching: lanes stream TOGETHER, interleaved per staged
    shard, so each shard's tile working set is shipped once per batch
    instead of once per lane — strictly less H2D traffic than looping
    the lanes, with the same bits and one double-buffered window."""
    g = _g(seed=7)
    x = G.random_features(g, seed=4)
    lanes = [x, x * 0.5, x * -1.0, x + 2.0]
    eng = _engine()
    prog = eng.compile(name, g)
    h2d_seq = 0
    shards_seq = 0
    for xl in lanes:
        eng.run(prog, xl, residency="host")
        h2d_seq += eng.exec_stats.h2d_bytes
        shards_seq += eng.exec_stats.shards_streamed
    xs = np.stack(lanes)
    yh = eng.run_batch(prog, xs, residency="host")
    st = eng.exec_stats
    assert st.runs == 1                      # one logical batched pass
    assert st.h2d_bytes < h2d_seq            # tile transfers amortized
    assert st.shards_streamed == shards_seq // len(lanes)
    yd = eng.run_batch(prog, xs)
    assert torch.equal(yd, yh)


def test_compile_residency_default_is_carried_not_cached():
    g = _g(seed=9)
    x = G.random_features(g, seed=1)
    eng = _engine()
    ph = eng.compile("b1", g, residency="host")
    assert ph.default_residency == "host"
    y_host = eng.run(ph, x)                      # uses the host default
    assert eng.exec_stats.shards_streamed > 0
    # the shared cache entry keeps serving device-resident by default
    pd = eng.compile("b1", g)
    assert pd.default_residency is None
    assert torch.equal(eng.run(pd, x), y_host)
    assert eng.exec_stats.shards_streamed == 0
    # a cache hit asked for host residency carries it, the entry does not
    assert eng.compile("b1", g, residency="host").default_residency == \
        "host"
    assert eng.cache.get(pd.cache_key).default_residency is None
    assert torch.equal(eng.run_batch(ph, x[None])[0], y_host)
    assert eng.exec_stats.shards_streamed > 0
    with pytest.raises(ValueError, match="residency"):
        eng.compile("b1", g, residency="mesh")


# --------------------------------------------------------------------------- #
# Liveness: the manifest table is respected and outputs really free.
# --------------------------------------------------------------------------- #
def _expected_peak_live(prog) -> int:
    res = prog.manifest["residency"]
    last_use = {int(k): v for k, v in res["last_use"].items()}
    plan = prog.plan()
    n = len(plan.layers)
    births = {lp.layer_id: t for t, lp in enumerate(plan.layers)}
    return max(
        sum(1 for lid, bt in births.items()
            if bt <= t <= max(last_use.get(lid, n), bt))
        for t in range(n))


@pytest.mark.parametrize("residency", ["device", "host"])
def test_liveness_frees_outputs(residency):
    g = _g(seed=5)
    x = G.random_features(g, seed=3)
    eng = _engine()
    prog = eng.compile("b8", g)        # deepest benchmark stack
    events = []
    eng.executor.liveness_hook = \
        lambda ev, lid, live: events.append((ev, lid, live))
    eng.run(prog, x, residency=residency)
    expected = _expected_peak_live(prog)
    n_layers = len(prog.plan().layers)
    assert expected < n_layers         # the bound itself is non-trivial
    assert eng.exec_stats.peak_live_outputs <= expected
    frees = [e for e in events if e[0] == "free"]
    allocs = [e for e in events if e[0] == "alloc"]
    assert len(allocs) == n_layers
    assert frees                       # something was actually released
    freed = {lid for _, lid, _ in frees}
    assert prog.manifest["sink"] not in freed


def test_gagi_from_jax_streams_host_resident(tmp_path):
    # A bundle the JAX package wrote runs host-streamed in the port with
    # the bits of the port's device path and within tolerance of JAX.
    gj, gt = _g(seed=13, pkg=JG), _g(seed=13)
    x = G.random_features(gt, seed=6)
    je = JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)
    jp = je.compile("b6", gj)
    y_jax = np.asarray(je.run(jp, jnp.asarray(x), residency="host"))
    path = os.path.join(str(tmp_path), "gat.gagi")
    jp.save(path)
    eng = _engine()
    loaded = eng.load(path)
    y_host = eng.run(loaded, x, residency="host")
    assert torch.equal(y_host, eng.run(loaded, x))
    np.testing.assert_allclose(y_host.numpy(), y_jax, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# Budget: a point where only the partitioned path completes.
# --------------------------------------------------------------------------- #
def test_budget_gates_device_but_not_streaming():
    g = _g(nv=400, ne=2400, seed=19)
    x = G.random_features(g, seed=5)
    eng = _engine()
    prog = eng.compile("b1", g)
    y_ref = eng.run(prog, x)
    eng.run(prog, x, residency="host")
    host_peak = eng.exec_stats.peak_stage_bytes
    assert host_peak == eng.executor.estimate_host_window_bytes(
        prog, x.shape[1])
    est = eng.executor.estimate_device_peak_bytes(prog, x.shape[1])
    assert host_peak < est             # streaming working set is smaller
    eng.executor.resident_budget_bytes = (host_peak + est) // 2
    with pytest.raises(ResidentBudgetError):
        eng.run(prog, x)
    y_host = eng.run(prog, x, residency="host")
    assert torch.equal(y_ref, y_host)


def test_budget_gates_batched_device_runs_at_batch_scale():
    """A budget that fits ONE lane must still refuse a batch of 8 on the
    device path, and name the batch."""
    g = _g(seed=31)
    x = G.random_features(g, seed=2)
    eng = _engine()
    prog = eng.compile("b1", g)
    est1 = eng.executor.estimate_device_peak_bytes(prog, x.shape[1])
    eng.executor.resident_budget_bytes = est1 + 1
    eng.run(prog, x)                             # one lane fits
    xs = np.stack([x] * 8)
    with pytest.raises(ResidentBudgetError,
                       match="batch of 8.*or shrink the batch"):
        eng.run_batch(prog, xs)
    eng.executor.resident_budget_bytes = None
    eng.run_batch(prog, xs)
    eng.executor.resident_budget_bytes = est1 + 1
    with pytest.raises(ResidentBudgetError):     # and again
        eng.run_batch(prog, xs)


def test_budget_refusal_reports_peak_budget_and_first_layer():
    """A device-path refusal must be actionable: the message carries the
    liveness-aware peak estimate, the budget (both in bytes), the
    overshoot, names the FIRST layer step that exceeds it, and points at
    residency='host'."""
    g = _g(nv=400, ne=2400, seed=19)
    x = G.random_features(g, seed=5)
    eng = _engine()
    prog = eng.compile("b1", g)
    est = eng.executor.estimate_device_peak_bytes(prog, x.shape[1])
    budget = est // 2
    eng.executor.resident_budget_bytes = budget
    with pytest.raises(ResidentBudgetError) as ei:
        eng.run(prog, x)
    msg = str(ei.value)
    assert str(est) in msg and str(budget) in msg
    assert str(est - budget) in msg          # the overshoot
    assert "first exceeded at layer" in msg
    assert "re-run with residency='host'" in msg
    static, x_bytes, live = eng.executor._live_profile(prog, x.shape[1])
    first = next(t for t, lv in enumerate(live)
                 if static + x_bytes + lv > budget)
    lp = prog.plan().layers[first]
    assert f"layer {lp.layer_id}" in msg


def test_budget_rejects_oversized_shard_in_host_mode():
    g = _g(seed=23)
    x = G.random_features(g, seed=2)
    eng = _engine(resident_budget_bytes=1024)    # absurdly small
    prog = eng.compile("b1", g)
    with pytest.raises(ResidentBudgetError, match="shard working set"):
        eng.run(prog, x, residency="host")
    with pytest.raises(ResidentBudgetError, match="3 interleaved lanes"):
        eng.run_batch(prog, np.stack([x] * 3), residency="host")


# --------------------------------------------------------------------------- #
# Against the JAX package's host path; telemetry.
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
def test_host_path_matches_jax_host_path(name):
    gj, gt = _g(seed=21, pkg=JG), _g(seed=21)
    x = G.random_features(gt, seed=2)
    je = JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)
    y_jax = np.asarray(je.run(je.compile(name, gj), jnp.asarray(x),
                              residency="host"))
    jst = je.exec_stats
    eng = _engine(backend="cuda")
    y = eng.run(eng.compile(name, gt), x, residency="host")
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=RTOL, atol=ATOL)
    # the same shards are streamed, in the same number
    assert eng.exec_stats.shards_streamed == jst.shards_streamed


def test_host_window_estimate_and_profile():
    # The plan-only window estimate is what the run reads, for a batch
    # too; the per-tile exec_profile of a host run equals a device run's.
    g = _g(nv=150, ne=1200, seed=5, degree="powerlaw")
    xs = np.stack([G.random_features(g, seed=s) for s in range(3)])
    for model in ("b6", build_gat_dot(TB, g, hidden=16)):
        eng = _engine()
        eng.executor.profile_tiles = True
        prog = eng.compile(model, g, residency="host")
        eng.run_batch(prog, xs)
        assert eng.exec_stats.peak_stage_bytes == \
            eng.executor.estimate_host_window_bytes(prog, xs.shape[2],
                                                    batch=3)
        host_prof = prog.manifest.pop("exec_profile")
        eng.run_batch(prog, xs, residency="device")
        assert prog.manifest["exec_profile"] == host_prof
