"""Compiled-pass reuse in the port (CUDA-graph replays, lane padding, the
decode step with its position on the device) and ``cfg.remat``, on the
CPU, against the port's eager route and the JAX package.

  * ``submit_batch`` pads N requests to JAX's power-of-two bucket (the
    bucket of n = 1..16 is read off both packages' ``run_batch`` calls);
    padded lanes equal the unpadded pass and solo runs bit for bit, for
    b2 on Cora and for sampled graph-as-data lanes, and every response
    says ``batch_size=n``;
  * the replay machinery of ``BinaryExecutor`` (memo, static inputs,
    refilled graph-as-data lanes, owned outputs, restored stats, dropped
    captures) with a stand-in for the CUDA graph whose replay runs the
    captured pass again into the captured output: replays equal the eager
    route bit for bit, an output handed back is never overwritten, the
    stats equal the eager pass's, a released staging drops its captures,
    and ``weights=`` / host / budget-refused runs never replay;
  * decode with a 0-d tensor position equals decode with an int bit for
    bit, and both stay within the JAX tolerance of JAX's serve step
    (qwen3-0.6b smoke, gemma3-12b smoke past its window of 8);
  * the train step's loss and gradients under ``remat`` "full" / "dots"
    equal "none" bit for bit (the flash forward then runs twice), and
    match JAX's under the same ``remat`` at 1e-4 in fp32.

The CUDA graphs themselves run in ``tests/test_torch_gpu.py`` on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_models import build_gat_dot  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.data import synthetic_batches as jbatches  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import InferenceRequest as JRequest  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import steps as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import (Engine, InferenceRequest,  # noqa: E402
                                stack_graph_data)
from repro_torch.engine.executor import (BinaryExecutor,  # noqa: E402
                                         ResidentBudgetError,
                                         release_staging)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402
from repro_torch.sampling import (bucket_for, layout_graph,  # noqa: E402
                                  sample_ego, template_graph)

RTOL, ATOL = 2e-4, 2e-5
CO_GEOM = PartitionConfig(n1=1024, n2=128)
GEOM = PartitionConfig(n1=32, n2=8)


class _StandInGraph:
    """A CUDA graph's stand-in on the CPU: ``capture`` runs the pass once
    and keeps its output; ``replay`` runs the captured pass again (it
    reads the static buffers, as the graph's launches do) and writes the
    result into the captured output, as a replay overwrites it."""

    captures = 0

    @staticmethod
    def supports(device):
        return True

    @staticmethod
    def new_pool(device):
        return object()

    def __init__(self, device, pool=None):
        self.fn = self.out = None
        self.pool = pool

    def capture(self, fn):
        type(self).captures += 1
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        self.out.copy_(self.fn())


@pytest.fixture
def stand_in(monkeypatch):
    _StandInGraph.captures = 0
    monkeypatch.setattr(BinaryExecutor, "_graph_type", _StandInGraph)
    return _StandInGraph


# --------------------------------------------------------------------------- #
# Graphs and requests
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cora():
    return G.synthesize("CO").gcn_normalized()


def _co_requests(g, n, seed0=0):
    return [InferenceRequest("b2", g, G.random_features(g, seed=seed0 + i),
                             request_id=f"co{i}") for i in range(n)]


def _parent(nv=400, ne=24000, f=16, c=4, seed=3, pkg=G):
    g = pkg.random_graph(nv, ne, seed=seed, degree="powerlaw", dedupe=True)
    g.feat_dim, g.n_classes = f, c
    return g


def _sampled(g, i, model="b1", targets=None):
    """One user's bucketed graph-as-data request on the dense parent (its
    ego networks all fall in one geometry bucket)."""
    X = G.random_features(g, seed=1)
    ego = sample_ego(g, targets or [5 + i, 90 + i], (6, 4), seed=11 + i)
    sub = ego.graph.gcn_normalized()
    bucket = bucket_for(sub, GEOM)
    x = np.zeros((bucket.n_vertices, g.feat_dim), np.float32)
    x[: ego.vertices.size] = X[ego.vertices]
    return InferenceRequest(model, template_graph(bucket, GEOM), x,
                            request_id=f"s{i}",
                            graph_data=layout_graph(sub, bucket, GEOM))


@pytest.fixture(scope="module")
def sampled():
    g = _parent()
    reqs = [_sampled(g, i) for i in range(8)]
    keys = {Engine(geometry=GEOM, device="cpu").cache_key(r.model, r.graph)
            for r in reqs}
    assert len(keys) == 1                      # one bucket program
    return reqs


def _live_counts(reqs):
    return [sum(int(np.asarray(t["mask"]).sum())
                for t in r.graph_data["tiles"].values()) for r in reqs]


# --------------------------------------------------------------------------- #
# Lane padding
# --------------------------------------------------------------------------- #
def test_lane_bucket_matches_jax(monkeypatch):
    """The lanes each package's submit_batch hands run_batch, n = 1..16
    (run_batch itself is replaced by a recorder)."""
    jg, g = JG.random_graph(60, 240, seed=1), G.random_graph(60, 240, seed=1)
    seen = {"jax": [], "port": []}

    def j_run_batch(self, prog, xs, graph_data=None, **kw):
        seen["jax"].append(int(xs.shape[0]))
        return jnp.zeros((xs.shape[0], 60, 4), jnp.float32)

    def t_run_batch(self, prog, xs, graph_data=None, **kw):
        seen["port"].append(int(xs.shape[0]))
        return torch.zeros((xs.shape[0], 60, 4))

    monkeypatch.setattr(JEngine, "run_batch", j_run_batch)
    monkeypatch.setattr(BinaryExecutor, "run_batch", t_run_batch)
    je = JEngine(geometry=JPC(n1=32, n2=8), verify=False)
    te = Engine(geometry=GEOM, device="cpu")
    for n in range(1, 17):
        x = np.zeros((60, g.feat_dim), np.float32)
        resp = je.submit_batch([JRequest("b1", jg, x)] * n)
        got = te.submit_batch([InferenceRequest("b1", g, x)] * n)
        assert len(got) == len(resp) == n
        assert all(r.batch_size == n for r in got)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == [1, 2, 4, 4, 8, 8, 8, 8] + [16] * 8


@pytest.mark.parametrize("n", range(1, 9))
@pytest.mark.parametrize("kind", ["b2@CO", "sampled"])
def test_padded_lanes_equal_unpadded_and_solo(kind, n, cora, sampled,
                                              monkeypatch):
    if kind == "b2@CO":
        eng = Engine(geometry=CO_GEOM, device="cpu")
        reqs = _co_requests(cora, n)
    else:
        eng = Engine(geometry=GEOM, device="cpu", backend="cuda")
        reqs = sampled[:n]
    lanes = []
    run_batch = BinaryExecutor.run_batch

    def spy(self, prog, xs, **kw):
        lanes.append(int(xs.shape[0]))
        return run_batch(self, prog, xs, **kw)

    monkeypatch.setattr(BinaryExecutor, "run_batch", spy)
    got = eng.submit_batch(reqs)
    assert lanes == [1 << (n - 1).bit_length()]
    assert [r.batch_size for r in got] == [n] * n
    assert [r.request_id for r in got] == [r.request_id for r in reqs]
    prog = eng.compile(reqs[0].model, reqs[0].graph)
    gd = (stack_graph_data([r.graph_data for r in reqs], n)
          if kind == "sampled" else None)
    ys = eng.run_batch(prog, np.stack([r.features for r in reqs]),
                       graph_data=gd)
    for i, (r, resp) in enumerate(zip(reqs, got)):
        assert torch.equal(resp.output, ys[i])               # unpadded
        solo = eng.run(prog, r.features, graph_data=r.graph_data)
        assert torch.equal(resp.output, solo)                 # solo


# --------------------------------------------------------------------------- #
# Replays (a stand-in graph on the CPU)
# --------------------------------------------------------------------------- #
def _stats(st):
    d = dataclasses.asdict(st)
    for rec in d["per_layer"] or []:
        rec.pop("wall_s")
    return d


def _memo(prog):
    return prog.__dict__.get("_replays", {})


@pytest.mark.parametrize("model", ["b2", "b6", "gat-dot"])
def test_replays_equal_the_eager_route(model, cora, stand_in):
    m = (build_gat_dot(TB, cora, hidden=16) if model == "gat-dot"
         else model)
    eng = Engine(geometry=CO_GEOM, device="cpu", backend="cuda")
    eager = Engine(geometry=CO_GEOM, device="cpu", backend="cuda",
                   replay=False)
    prog, eprog = eng.compile(m, cora), eager.compile(m, cora)
    xs = [G.random_features(cora, seed=s)[None] for s in range(4)]
    outs = []
    for i, x in enumerate(xs):
        y = eng.run_batch(prog, x)
        want = eager.run_batch(eprog, x)
        assert torch.equal(y, want)
        assert _stats(eng.exec_stats) == _stats(eager.exec_stats)
        outs.append((y.clone(), y))
        # Eager while the first pass stages the graph, then a warm eager
        # pass whose stats replays keep, then the capture.
        assert stand_in.captures == (0 if i < 2 else 1)
    for kept, handed in outs:                  # never overwritten
        assert torch.equal(kept, handed)
    (rp,) = _memo(prog).values()
    assert rp.graph is not None and rp.xs.shape == xs[0].shape
    assert not _memo(eprog)
    assert eng.exec_stats_total.runs == 4


def test_replayed_lanes_of_differing_live_counts(sampled, stand_in):
    eng = Engine(geometry=GEOM, device="cpu", backend="cuda")
    eager = Engine(geometry=GEOM, device="cpu", backend="cuda",
                   replay=False)
    assert len(set(_live_counts(sampled))) > 4
    batches = [sampled[0:3], sampled[3:6], sampled[5:8], sampled[1:4],
               sampled[0:2], sampled[6:8]]
    for batch in batches:                      # buckets of 4, then 2
        got = eng.submit_batch(batch)
        want = eager.submit_batch(batch)
        for a, b in zip(got, want):
            assert torch.equal(a.output, b.output)
        assert _stats(eng.exec_stats) == _stats(eager.exec_stats)
        assert eng.exec_stats.h2d_bytes > 0
    assert stand_in.captures == 2              # one per bucket shape
    prog = eng.cache.get(got[0].cache_key)
    assert sorted(k[0][0] for k in _memo(prog)) == [2, 4]


def test_release_staging_drops_captures(cora, stand_in):
    eng = Engine(geometry=CO_GEOM, device="cpu", backend="cuda")
    prog = eng.compile("b2", cora)
    x = G.random_features(cora, seed=0)
    want = eng.run(prog, x)
    eng.run(prog, x)
    eng.run(prog, x)
    (rp,) = _memo(prog).values()
    assert rp.graph is not None
    release_staging(prog.pgraph)
    assert rp.dropped and rp.graph is None and rp.reads is None
    assert torch.equal(eng.run(prog, x), want)         # staged again, eager
    assert not _memo(prog)                     # the dropped entry is gone
    assert torch.equal(eng.run(prog, x), want)         # warm, eager
    (rp2,) = _memo(prog).values()
    assert rp2 is not rp and rp2.graph is None
    assert torch.equal(eng.run(prog, x), want)         # captured again
    assert rp2.graph is not None and stand_in.captures == 2


def test_overrides_host_runs_and_budget_refusals_never_replay(cora,
                                                              stand_in):
    eng = Engine(geometry=CO_GEOM, device="cpu", backend="cuda")
    prog = eng.compile("b2", cora)
    x = G.random_features(cora, seed=0)
    y = eng.run(prog, x)
    for _ in range(2):
        assert torch.equal(eng.run(prog, x, weights=dict(prog.weights)), y)
        assert torch.equal(eng.run(prog, x, residency="host"), y)
    assert stand_in.captures == 0
    eng.run(prog, x)
    eng.run(prog, x)
    assert stand_in.captures == 1
    eng.executor.resident_budget_bytes = 1024
    with pytest.raises(ResidentBudgetError):
        eng.run(prog, x)                       # gated before the replay


def test_captures_share_a_pool_and_count_against_the_budget(cora,
                                                            stand_in):
    eng = Engine(geometry=CO_GEOM, device="cpu", backend="cuda")
    ex = eng.executor
    prog = eng.compile("b2", cora)
    x = G.random_features(cora, seed=0)
    static, x_bytes, live = ex._live_profile(prog, x.shape[1])
    one = x_bytes + max(live)                  # one lane's pass
    # Room for the tiles and weights, a captured lane and a fresh pass of
    # two lanes, less one byte.
    ex.resident_budget_bytes = static + 3 * one - 1
    for _ in range(3):                         # stage, warm, capture
        y1 = ex.run_batch(prog, x[None])
    (rp,) = _memo(prog).values()
    assert rp.graph is not None and rp.held_bytes == one
    assert ex._held_bytes(prog) == one
    x2 = np.stack([x, x])
    with pytest.raises(ResidentBudgetError, match=f"{one} bytes held"):
        ex.run_batch(prog, x2)                 # would fit with no capture
    assert torch.equal(ex.run_batch(prog, x[None]), y1)     # replays fit
    ex.resident_budget_bytes = static + 4 * one
    for _ in range(2):                         # warm, capture
        y2 = ex.run_batch(prog, x2)
    assert torch.equal(y2[0], y1[0]) and torch.equal(y2[1], y1[0])
    assert ex._held_bytes(prog) == 3 * one
    pools = {r.graph.pool for r in _memo(prog).values()}
    assert pools == {ex._pool} and ex._pool is not None     # one pool
    release_staging(prog.pgraph)
    assert ex._held_bytes(prog) == 0           # dropped with the staging
    old = ex._pool
    for _ in range(3):                         # stage, warm, capture
        ex.run_batch(prog, x[None])
    assert ex._pool is not old                 # its graphs are all gone


class _CaptureOnlyGraph(_StandInGraph):
    """A stand-in that keeps the captured output but not the pass (which
    refers to its executor, as a CUDA graph does not); a replay leaves
    the output as captured."""

    def capture(self, fn):
        self.out = fn()
        return self.out

    def replay(self):
        pass


def test_collected_executor_drops_its_captures(cora, monkeypatch):
    import gc
    monkeypatch.setattr(BinaryExecutor, "_graph_type", _CaptureOnlyGraph)
    eng = Engine(geometry=CO_GEOM, device="cpu", backend="cuda")
    prog = eng.compile("b2", cora)
    x = G.random_features(cora, seed=0)
    for _ in range(3):
        eng.run(prog, x)
    (rp,) = _memo(prog).values()
    assert rp.graph is not None and rp.out is not None
    del eng
    gc.collect()
    assert rp.dropped and rp.graph is None and rp.out is None
    assert rp.xs is None and rp.held_bytes == 0
    other = Engine(geometry=CO_GEOM, device="cpu", backend="cuda")
    other.run(prog, x)                         # warm: the staging is there
    (rp2,) = _memo(prog).values()              # the dead entry is pruned
    assert rp2.owner() is other.executor


# --------------------------------------------------------------------------- #
# Decode with the position on the device
# --------------------------------------------------------------------------- #
def _cfg32(arch):
    return (dataclasses.replace(jget_smoke(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _carried(jcfg, tcfg, seed=0):
    jm = JS.build_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tm = TS.build_model(tcfg, device="cpu")
    tm.load_state_dict(convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, jp)))
    return jm, jp, tm


@pytest.mark.parametrize("arch,t", [("qwen3-0.6b", 12),
                                    ("gemma3-12b", 20)])   # window 8
def test_tensor_position_decode_equals_int_and_jax(arch, t):
    jcfg, tcfg = _cfg32(arch)
    jm, jp, tm = _carried(jcfg, tcfg, seed=4)
    b = 2
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (b, t)).astype(
        np.int32)
    step = TS.make_serve_step(tm, tcfg)
    jdecode = jax.jit(jm.decode_step)
    c_int, c_dev, jc = tm.init_cache(b, t), tm.init_cache(b, t), \
        jm.init_cache(b, t)
    for i in range(t):
        tok = torch.from_numpy(toks[:, i:i + 1])
        lg_int, c_int = tm.decode_step(c_int, tok, i)
        lg_dev, c_dev = tm.decode_step(c_dev, tok,
                                       torch.tensor(i, dtype=torch.int64))
        assert torch.equal(lg_int, lg_dev)
        for a, d in zip(c_int, c_dev):
            assert torch.equal(a["k"], d["k"]) and torch.equal(a["v"],
                                                               d["v"])
        jlg, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                          jnp.int32(i))
        np.testing.assert_allclose(lg_dev.numpy(), np.asarray(jlg),
                                   rtol=RTOL, atol=ATOL)
    # The serve step takes the tensor too: JAX's greedy token.
    nxt, _ = step(tm, c_dev, torch.from_numpy(toks[:, -1:]),
                  torch.tensor(t - 1, dtype=torch.int32))
    jnxt, _ = JS.make_serve_step(jm, jcfg)(
        jp, jc, jnp.asarray(toks[:, -1:]), jnp.int32(t - 1))
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_captured_step_is_eager_on_the_cpu():
    tcfg = get_smoke_config("qwen3-0.6b")
    tm = TS.build_model(tcfg, device="cpu", seed=1)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (3, 5)).astype(np.int32))
    a, _, _ = tserve.generate(tm, tcfg, prompts, 6, capture=True)
    b, _, _ = tserve.generate(tm, tcfg, prompts, 6, capture=False)
    assert a.shape == (3, 6) and torch.equal(a, b)
    step = tserve.Step(tm, tcfg, tm, tm.init_cache(3, 11), 3)
    assert not step.capture


# --------------------------------------------------------------------------- #
# cfg.remat
# --------------------------------------------------------------------------- #
def _grads(tm, tcfg, batch):
    tm, _ = TS.init_train_state(tm)
    _, loss, _, grads = TS.value_and_grad(
        tm, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, grads


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b"])
def test_remat_is_bit_identical_to_none(arch, monkeypatch):
    jcfg, tcfg = _cfg32(arch)
    batch = next(jbatches(jcfg, 2, 20, seed=3))
    flash = ops.flash_attention
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return flash(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    got = {}
    for policy in ("none", "full", "dots"):
        calls.clear()
        cfg = dataclasses.replace(tcfg, remat=policy)
        _, _, tm = _carried(jcfg, cfg, seed=5)
        got[policy] = _grads(tm, cfg, batch) + (len(calls),)
    loss, grads, n_flash = got["none"]
    assert n_flash == tcfg.n_layers
    for policy in ("full", "dots"):
        l2, g2, n2 = got[policy]
        assert torch.equal(l2, loss)
        assert g2.keys() == grads.keys()
        for name in grads:
            assert torch.equal(g2[name], grads[name]), (policy, name)
        assert n2 == 2 * tcfg.n_layers         # the recomputed forward
    # Serving and prefill take no checkpoint.
    cfg = dataclasses.replace(tcfg, remat="full")
    _, _, tm = _carried(jcfg, cfg, seed=5)
    calls.clear()
    with torch.no_grad():
        tm(torch.from_numpy(batch["tokens"]))
    assert len(calls) == tcfg.n_layers


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_matches_jax(policy):
    jcfg, tcfg = _cfg32("qwen3-0.6b")
    jcfg = dataclasses.replace(jcfg, remat=policy)
    tcfg = dataclasses.replace(tcfg, remat=policy)
    jm, jp, tm = _carried(jcfg, tcfg, seed=6)
    batch = next(jbatches(jcfg, 2, 16, seed=4))

    def lf(p):
        logits, aux = jm.forward(p, jnp.asarray(batch["tokens"]))
        return JL.softmax_xent(logits, jnp.asarray(batch["labels"]))

    jl, jg = jax.value_and_grad(lf)(jp)
    loss, grads = _grads(tm, tcfg, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-4, atol=1e-4)
    want = convert.lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jg))
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
