"""The port's serving runtime (repro_torch.runtime) on device="cpu".

A twin of ``tests/test_runtime.py``, one test per test there, over the
port's Engine: batched execution equals sequential execution (bit for bit,
since a lane runs exactly the tile ops of a single run) and JAX's
``OverlayPool.serve`` (rtol 2e-4 / atol 2e-5) with the same overlay
placements; the batcher's size and deadline flushes on a fake clock;
cache-affinity and LPT routing; admission control and backpressure; JSON
metrics; per-run ``ExecStats``.  The batched stream carries b1 (GCN),
b6 (GAT, pair-sum scores) and gat-dot (dot-product attention, dot-mode
SDDMM).  The JAX side runs once (module-scoped fixture).
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_models import build_gat_dot  # noqa: E402
from repro.core import gnn_builders as JB  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import InferenceRequest as JRequest  # noqa: E402
from repro.runtime import OverlayPool as JPool  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.core.passes.schedule import lpt_assign  # noqa: E402
from repro_torch.engine import (Engine, InferenceRequest,  # noqa: E402
                                stack_features)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import (Batch, Batcher, OverlayPool,  # noqa: E402
                                 QueueFullError, ServeLoop, warm_pool)

GEOM = PartitionConfig(n1=32, n2=8)
RTOL, ATOL = 2e-4, 2e-5


def _g(nv=70, ne=260, f=8, c=3, seed=0, G=G):
    g = G.random_graph(nv, ne, seed=seed).gcn_normalized()
    g.feat_dim, g.n_classes = f, c
    return g


def _pool(n=2, **kw) -> OverlayPool:
    return OverlayPool(n_overlays=n, geometry=GEOM, n_pes=4, device="cpu",
                       **kw)


def _engine() -> Engine:
    return Engine(geometry=GEOM, n_pes=4, device="cpu")


def _req(model, g, seed, rid=None):
    return InferenceRequest(model=model, graph=g,
                            features=G.random_features(g, seed=seed),
                            request_id=rid)


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# --------------------------------------------------------------------------- #
# Batched == sequential == JAX (the runtime's correctness contract).
# --------------------------------------------------------------------------- #
def _stream(pkg):
    """b1 / b6 / gat-dot over two graphs, three rounds, built by one
    package (``pkg`` is "jax" or "torch"); the same numpy features."""
    Gm, B, Req = (JG, JB, JRequest) if pkg == "jax" else \
        (G, TB, InferenceRequest)
    g1 = _g(seed=21, G=Gm)
    g2 = _g(nv=80, ne=300, seed=22, G=Gm)
    gat = {1: build_gat_dot(B, g1, hidden=16),
           2: build_gat_dot(B, g2, hidden=16)}
    pairs = [("b1", 1), ("b6", 2), ("gat", 2), ("b1", 2), ("b6", 1),
             ("gat", 1)]
    reqs = []
    for _ in range(3):
        for m, gid in pairs:
            g = g1 if gid == 1 else g2
            x = Gm.random_features(g, seed=len(reqs))
            reqs.append(Req(model=gat[gid] if m == "gat" else m, graph=g,
                            features=jnp.asarray(x) if pkg == "jax" else x,
                            request_id=f"req{len(reqs)}"))
    return reqs


@pytest.fixture(scope="module")
def jax_batched():
    pool = JPool(n_overlays=2, geometry=JPC(n1=32, n2=8), n_pes=4)
    resps = pool.serve(_stream("jax"), max_batch=3, max_wait_us=1e9,
                       overlap_overlays=False)
    return [(r.request_id, np.asarray(r.output), r.overlay, r.batch_size)
            for r in resps]


def test_batched_equals_sequential_two_models_two_graphs(jax_batched):
    """b1 (GCN) + b6 (GAT) + gat-dot over two graphs: OverlayPool.serve
    with batching produces the same outputs as one-at-a-time Engine.serve
    (bit for bit) and as the JAX runtime, on the same overlays."""
    reqs = _stream("torch")
    pool = _pool(2, backend="cuda")       # CPU tensors: plain versions
    batched = pool.serve(reqs, max_batch=3, max_wait_us=1e9,
                         overlap_overlays=False)
    sequential = Engine(geometry=GEOM, n_pes=4, device="cpu",
                        backend="cuda").serve(reqs)

    assert [r.request_id for r in batched] == \
        [r.request_id for r in sequential] == \
        [rid for rid, *_ in jax_batched]
    for b, s, (_, want, overlay, size) in zip(batched, sequential,
                                              jax_batched):
        assert torch.equal(b.output, s.output), b.request_id
        np.testing.assert_allclose(b.output.numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        assert b.batch_size == size == 3 and s.batch_size == 1
        assert b.overlay == overlay and b.overlay in (0, 1)


def test_engine_submit_batch_one_pass_and_rejects_mixed_keys():
    g = _g(seed=5)
    eng = _engine()
    reqs = [_req("b1", g, seed=i) for i in range(4)]
    resps = eng.submit_batch(reqs)
    assert [r.batch_size for r in resps] == [4] * 4
    # one binary pass: per-run stats count a single traversal
    single = _engine()
    solo = single.submit(reqs[0])
    assert eng.exec_stats.tile_ops == single.exec_stats.tile_ops
    assert eng.exec_stats.runs == 1
    assert torch.equal(resps[0].output, solo.output)
    # mixed cache keys in one batch are a caller bug
    other = _g(nv=60, ne=200, seed=6)
    with pytest.raises(ValueError, match="one cache key"):
        eng.submit_batch([_req("b1", g, 0), _req("b1", other, 0)])


def test_stack_features_pads_and_stacks():
    xs = stack_features([np.ones((3, 2)), np.ones((2, 4))])
    assert tuple(xs.shape) == (2, 3, 4) and xs.dtype == torch.float32
    assert float(xs[1, 2, 0]) == 0.0       # padded rows are zero
    assert float(xs[0, 0, 3]) == 0.0       # padded cols are zero


# --------------------------------------------------------------------------- #
# Batcher flush policies (fake-clock driven).
# --------------------------------------------------------------------------- #
def test_batcher_flushes_on_max_batch():
    clock = FakeClock()
    b = Batcher(max_batch=3, max_wait_us=1e9, clock=clock)
    g = _g()
    assert b.add("k", _req("b1", g, 0), 0) is None
    assert b.add("k", _req("b1", g, 1), 1) is None
    full = b.add("k", _req("b1", g, 2), 2)     # size flush, no time passed
    assert full is not None and len(full) == 3
    assert full.indices == [0, 1, 2]
    assert b.depth == 0


def test_batcher_flushes_on_max_wait_us():
    clock = FakeClock()
    b = Batcher(max_batch=100, max_wait_us=2000.0, clock=clock)
    g = _g()
    b.add("k", _req("b1", g, 0), 0)
    clock.advance(0.0015)                      # 1.5 ms < 2 ms deadline
    assert b.due() == []
    b.add("k2", _req("b7", g, 1), 1)           # younger group
    clock.advance(0.0010)                      # "k" now 2.5 ms old
    due = b.due()
    assert [x.key for x in due] == ["k"]       # k2 (1 ms old) stays
    assert b.depth == 1
    clock.advance(0.0015)
    assert [x.key for x in b.due()] == ["k2"]


def test_batcher_flush_all_first_arrival_order():
    b = Batcher(max_batch=10, max_wait_us=1e9, clock=FakeClock())
    g = _g()
    for i, key in enumerate(["kb", "ka", "kb", "kc"]):
        b.add(key, _req("b1", g, i), i)
    assert [x.key for x in b.flush_all()] == ["kb", "ka", "kc"]
    assert b.depth == 0


# --------------------------------------------------------------------------- #
# Cache-affinity routing.
# --------------------------------------------------------------------------- #
def test_repeated_key_routes_to_same_overlay_hit_rate_one():
    g1, g2 = _g(seed=31), _g(nv=80, ne=300, seed=32)
    pool = _pool(2)
    warmup = [_req("b1", g1, 0), _req("b6", g2, 1)]
    warm_pool(pool, warmup)
    assert pool.cache_hit_rate == 0.0          # warmup compiled cold

    # 4 post-warmup batches per key; every one must go to the key's
    # home overlay and hit its program cache
    reqs = []
    for rnd in range(4):
        reqs += [_req("b1", g1, 100 + rnd), _req("b1", g1, 200 + rnd),
                 _req("b6", g2, 300 + rnd), _req("b6", g2, 400 + rnd)]
    resps = pool.serve(reqs, max_batch=2, max_wait_us=1e9,
                       overlap_overlays=False)
    assert all(r.cache_hit for r in resps)     # hit rate 1.0 after warmup
    by_key = {}
    for r in resps:
        by_key.setdefault(r.cache_key, set()).add(r.overlay)
        assert r.t_loc == 0.0
    assert all(len(ovs) == 1 for ovs in by_key.values())
    # the two keys landed on different overlays (LPT spread them)
    assert len(set.union(*by_key.values())) == 2
    snap = pool.metrics.snapshot(max_batch=2)
    assert snap["global"]["cache_hit_rate"] == 1.0


def test_new_keys_lpt_balance_across_overlays():
    pool = _pool(3)
    batches = [Batch(key=f"k{i}", requests=[], indices=[],
                     created_at=0.0, cost=c)
               for i, c in enumerate([5.0, 3.0, 2.0, 2.0])]
    placed = pool.place(batches)
    # LPT: 5 -> ov0, 3 -> ov1, 2 -> ov2, 2 -> ov2 ... loads (5, 3, 4)
    assert placed == [0, 1, 2, 2]
    assert pool.loads == [5.0, 3.0, 4.0]
    # affinity is sticky: same key re-routes home regardless of load
    assert pool.route("k0", cost=1.0) == 0


def test_lpt_assign_balances_and_respects_initial_loads():
    assignment, loads = lpt_assign([4.0, 3.0, 2.0, 1.0], 2)
    assert max(loads) == 5.0                   # {4,1} vs {3,2}
    assignment, loads = lpt_assign([1.0], 2, initial_loads=[10.0, 0.0])
    assert assignment == [1]
    with pytest.raises(ValueError):
        lpt_assign([1.0], 3, initial_loads=[0.0])


def test_pool_rejects_mismatched_geometries_and_defaults_to_cuda():
    e1 = Engine(geometry=PartitionConfig(n1=32, n2=8), device="cpu")
    e2 = Engine(geometry=PartitionConfig(n1=64, n2=8), device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        OverlayPool(engines=[e1, e2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            OverlayPool(n_overlays=2, geometry=GEOM)


# --------------------------------------------------------------------------- #
# Serving loop: admission control, deadlines, deterministic drain.
# --------------------------------------------------------------------------- #
def test_admission_control_raises_queue_full():
    clock = FakeClock()
    pool = _pool(1)
    loop = ServeLoop(pool, max_batch=100, max_wait_us=1e9, max_queue=3,
                     clock=clock, overlap_overlays=False)
    g = _g()
    for i in range(3):
        loop.submit(_req("b1", g, i))
    with pytest.raises(QueueFullError):
        loop.submit(_req("b1", g, 99))
    assert pool.metrics.rejected == 1
    resps = loop.drain()                       # backpressure release
    assert len(resps) == 3 and loop.queue_depth == 0
    loop.submit(_req("b1", g, 99))             # queue has room again
    assert len(loop.drain()) == 1


def test_offline_serve_backpressure_rejects_nothing():
    """serve() exerts backpressure on a full queue (flush + continue);
    no request is dropped and none is counted as rejected."""
    g = _g()
    pool = _pool(1)
    reqs = [_req("b1", g, i, rid=f"r{i}") for i in range(9)]
    resps = pool.serve(reqs, max_batch=4, max_wait_us=1e9, max_queue=3,
                       overlap_overlays=False)
    assert [r.request_id for r in resps] == [f"r{i}" for i in range(9)]
    assert pool.metrics.rejected == 0
    assert pool.metrics.snapshot()["global"]["requests"] == 9


def test_serve_loop_deadline_flush_with_fake_clock():
    clock = FakeClock()
    pool = _pool(1)
    loop = ServeLoop(pool, max_batch=100, max_wait_us=5000.0,
                     max_queue=64, clock=clock, overlap_overlays=False)
    g = _g()
    loop.submit(_req("b1", g, 0))
    loop.poll()
    assert loop.queue_depth == 1               # deadline not reached
    clock.advance(0.006)                       # 6 ms > 5 ms
    loop.poll()
    assert loop.queue_depth == 0               # deadline flush dispatched
    r, = loop.drain()
    assert r.batch_size == 1


def test_serve_returns_request_order_and_json_metrics():
    g1, g2 = _g(seed=41), _g(nv=80, ne=300, seed=42)
    pool = _pool(2)
    reqs = [_req(m, g, seed=i, rid=f"r{i}") for i, (m, g) in enumerate(
        [("b1", g1), ("b6", g2), ("b1", g1), ("b6", g2),
         ("b1", g1), ("b6", g2)])]
    # threaded path (one worker per overlay), with a short switch
    # interval so the two overlays' threads interleave often
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        resps = pool.serve(reqs, max_batch=2, max_wait_us=1e9)
    finally:
        sys.setswitchinterval(interval)
    assert [r.request_id for r in resps] == [f"r{i}" for i in range(6)]

    snap = pool.metrics.snapshot(max_batch=2)
    blob = json.loads(json.dumps(snap))        # JSON round-trip
    assert blob["global"]["requests"] == 6
    # per key: one full batch of 2 + one singleton flushed at drain
    assert blob["global"]["batches"] == 4
    assert blob["global"]["mean_batch_size"] == 1.5
    assert blob["global"]["batch_occupancy"] == 0.75
    assert set(blob["per_key"]) == {r.cache_key for r in resps}
    json.dumps(pool.stats_snapshot())          # also JSON-clean


# --------------------------------------------------------------------------- #
# Satellite: ExecStats reset per run (no cross-run accumulation).
# --------------------------------------------------------------------------- #
def test_exec_stats_reset_per_run_and_accumulate_in_total():
    g = _g(seed=51)
    eng = _engine()
    prog = eng.compile("b1", g)
    x = G.random_features(g, seed=0)

    eng.run(prog, x)
    first = eng.exec_stats
    assert first.runs == 1 and first.tile_ops > 0
    eng.run(prog, x)
    second = eng.exec_stats
    # per-run stats do NOT include the previous run
    assert (second.tile_ops, second.layers, second.runs) == \
        (first.tile_ops, first.layers, 1)
    assert eng.exec_stats_total.runs == 2
    assert eng.exec_stats_total.tile_ops == 2 * first.tile_ops


def test_launch_counter_is_thread_safe():
    # Overlays launch kernels from their own threads; no bump may be lost.
    import threading
    ops.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ops._launched("sddmm") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ops.LAUNCHES["sddmm"] == 16 * 2000
    ops.reset_launches()
