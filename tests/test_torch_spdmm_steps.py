"""The SpDMM step list (``kernels.ops.spdmm_steps``) and the executor's
runs of SUM/MEAN aggregate steps, on the CPU.

* The plain step-list version against JAX's Pallas ``spdmm`` in interpret
  mode, chained step by step (rtol 1e-5 / atol 1e-4, the JAX kernel
  sweep's fp32 tolerance; a bf16 store at its bf16 2e-2 / 1e-2): rows of
  SPAN - 1, SPAN, SPAN + 1 and w live slots, empty rows, pads between
  live slots, steps with and without ``row_len``, a bf16 h, an
  accumulator or none, and the one-step ``spdmm`` chained through acc.
* The port's executor, whose device path hands each run of SpDMM steps
  to the step list, against the JAX executor (rtol 2e-4 / atol 2e-5) on
  power-law graphs: b1 and b2 (SUM), b3 (GraphSAGE, MEAN), and b2 with a
  forced GEMM step inside a run; host-streamed bit for bit.
* One step-list call per run and lane: the calls counted against the
  maximal runs of the decoded plan, and every step counted as a tile op.

About 16 s alone on one CPU process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.kernels.spdmm import spdmm as pallas_spdmm  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.ir import AggOp, LayerType  # noqa: E402
from repro_torch.core.isa import Opcode  # noqa: E402
from repro_torch.core.passes.partition import \
    PartitionConfig as TPC  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SPAN = ops.SPDMM_SPAN
RTOL, ATOL = 1e-5, 1e-4          # the JAX kernel sweep's fp32 tolerance
E2E_RTOL, E2E_ATOL = 2e-4, 2e-5


def _tile(rng, n1, w, n_src, lens):
    """An [n1, w] ELL tile whose row r holds lens[r] slots up to its last
    live one: live slots at random below it (the last always live), pads
    (cols 0, vals 0) between them and after; with its row_len."""
    slot = np.arange(w)
    live = (slot[None] < lens[:, None]) & (rng.random((n1, w)) > 0.3)
    live[np.arange(n1), np.maximum(lens - 1, 0)] |= lens > 0
    cols = np.where(live, rng.integers(0, n_src, (n1, w)), 0)
    vals = np.where(live, rng.standard_normal((n1, w)), 0.0)
    row_len = np.where(live.any(1), w - np.argmax(live[:, ::-1], 1), 0)
    assert (row_len == lens).all()
    return (cols.astype(np.int32), vals.astype(np.float32),
            row_len.astype(np.int32))


def _lens(rng, n1, w):
    """Row lengths: empty, a span less one, a span, a span and one, the
    width, then random in [0, w]."""
    edge = [0, SPAN - 1, SPAN, SPAN + 1, w]
    lens = rng.integers(0, w + 1, n1)
    lens[:len(edge)] = [min(x, w) for x in edge]
    return lens


# (n1, step widths, their source blocks, n_src, f, with acc, row_len kept)
STEP_CASES = [
    (16, (2 * SPAN + 5, 8, SPAN + 1), (0, 2, 1), 24, 12, True, True),
    (16, (SPAN + 1,), (1,), 24, 8, False, True),
    (24, (SPAN - 1, 3 * SPAN), (2, 0), 40, 16, True, False),
    (8, (5, 5, 5, 5), (3, 0, 3, 1), 16, 4, False, False),
]


def _steps(case, seed):
    n1, widths, blocks, n_src, f, with_acc, keep_len = case
    rng = np.random.default_rng(seed)
    steps = []
    for w, k in zip(widths, blocks):
        cols, vals, row_len = _tile(rng, n1, w, n_src, _lens(rng, n1, w))
        steps.append((cols, vals, row_len if keep_len else None,
                      k * n_src))
    h = rng.standard_normal(((max(blocks) + 1) * n_src, f)).astype(
        np.float32)
    acc = (rng.standard_normal((n1, f)).astype(np.float32) if with_acc
           else None)
    return steps, h, acc


def _torch_steps(steps, n_src):
    return ops.SpdmmSteps(
        [(torch.from_numpy(c), torch.from_numpy(v),
          None if r is None else torch.from_numpy(r), off)
         for c, v, r, off in steps], n_src)


def _pallas_chain(steps, h, acc, n_src, f):
    """JAX's Pallas spdmm (interpret mode) a step at a time, added to acc
    in list order."""
    n1 = steps[0][0].shape[0]
    want = np.zeros((n1, f), np.float32) if acc is None else acc.copy()
    for cols, vals, _, off in steps:
        want = want + np.asarray(pallas_spdmm(
            jnp.asarray(cols), jnp.asarray(vals),
            jnp.asarray(h[off:off + n_src]), bm=n1, bf=f, interpret=True),
            np.float32)
    return want


@pytest.mark.parametrize("case", STEP_CASES)
def test_plain_step_list_matches_pallas_chained(case):
    steps, h, acc = _steps(case, seed=sum(case[1]))
    n_src, f = case[3], case[4]
    st = _torch_steps(steps, n_src)
    ta = None if acc is None else torch.from_numpy(acc)
    got = ops.spdmm_steps(st, torch.from_numpy(h), ta)
    want = _pallas_chain(steps, h, acc, n_src, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # The one-step wrapper chained through acc: the same bits.
    chain = ta
    for cols, vals, row_len, off in st.steps:
        chain = ops.spdmm(cols, vals, torch.from_numpy(h[off:off + n_src]),
                          chain, row_len)
    assert torch.equal(got, chain)
    # The full-width walk (row_len dropped) gives the same bits.
    walk_all = ops.SpdmmSteps([(c, v, None, off) for c, v, _, off
                               in st.steps], n_src)
    assert torch.equal(ops.spdmm_steps(walk_all, torch.from_numpy(h), ta),
                       got)


@pytest.mark.parametrize("case", STEP_CASES[:2])
def test_plain_step_list_bf16_h_and_store(case):
    steps, h, acc = _steps(case, seed=7 + sum(case[1]))
    n_src, f = case[3], case[4]
    st = _torch_steps(steps, n_src)
    hb = torch.from_numpy(h).bfloat16()
    ta = None if acc is None else torch.from_numpy(acc)
    got = ops.spdmm_steps(st, hb, ta)
    assert got.dtype == torch.float32
    want = _pallas_chain(steps, hb.float().numpy(), acc, n_src, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, ops.spdmm_steps(st, hb.float(), ta))
    store = ops.spdmm_steps(st, hb, ta, out_dtype=torch.bfloat16)
    assert store.dtype == torch.bfloat16 and torch.equal(
        store, got.bfloat16())
    np.testing.assert_allclose(store.float().numpy(), want, rtol=2e-2,
                               atol=1e-2)


def test_step_list_refuses_malformed_steps():
    cols = torch.zeros(4, 8, dtype=torch.int32)
    vals = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="no steps"):
        ops.SpdmmSteps([], 4)
    with pytest.raises(ValueError, match="row_len"):
        ops.SpdmmSteps([(cols, vals, torch.zeros(3, dtype=torch.int32), 0)],
                       4)
    with pytest.raises(ValueError, match="negative"):
        ops.SpdmmSteps([(cols, vals, None, -4)], 4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.SpdmmSteps([(torch.zeros(8, 4, dtype=torch.int32).t(), vals,
                         None, 0)], 4)
    st = ops.SpdmmSteps([(cols, vals, None, 8)], 4)
    assert st.rows == 12 and st.table is None       # no table on the CPU
    assert ref.spdmm_steps_ref(st.steps, torch.ones(12, 3), None,
                               4).shape == (4, 3)


# --------------------------------------------------------------------------- #
# The executor's runs.
# --------------------------------------------------------------------------- #
def _graphs(seed):
    out = []
    for G in (JG, TG):
        g = G.random_graph(200, 1500, seed=seed, degree="powerlaw")
        g = g.gcn_normalized()
        g.feat_dim, g.n_classes = 12, 4
        out.append(g)
    return out


def _engine(**kw) -> Engine:
    return Engine(geometry=TPC(n1=32, n2=8), n_pes=4, device="cpu", **kw)


def _jengine() -> JEngine:
    return JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)


def _runs(prog):
    """(maximal runs, SpDMM steps) of the plan's SUM/MEAN aggregate
    tiles: a run is consecutive static-weight SPDMM steps on one source
    fiber."""
    runs = steps = 0
    for lp in prog.plan().layers:
        if lp.layer_type != LayerType.AGGREGATE or AggOp(lp.mode) not in (
                AggOp.SUM, AggOp.MEAN):
            continue
        for tp in lp.tiles:
            prev = None
            for ins in tp.compute:
                spdmm = ins.op == Opcode.SPDMM and not ins.args[3] & 1
                steps += ins.op == Opcode.SPDMM
                if spdmm and (prev is None or prev != ins.args[2]):
                    runs += 1
                prev = ins.args[2] if spdmm else None
    return runs, steps


def _middle_tile(prog):
    """A "j:k" tile whose steps sit inside a run of at least three
    SpDMM steps with other source blocks on both sides."""
    for lp in prog.plan().layers:
        if lp.layer_type != LayerType.AGGREGATE:
            continue
        for tp in lp.tiles:
            ks = [ins.args[1] for ins in tp.compute]
            for i in range(1, len(ks) - 1):
                if ks[0] != ks[i] != ks[-1]:
                    return f"{tp.out_j}:{ks[i]}"
    raise AssertionError("no aggregate tile with three source blocks")


def _counting(monkeypatch):
    calls, real = [], ops.spdmm_steps

    def spy(steps, h, acc=None, out_dtype=torch.float32):
        calls.append(len(steps))
        return real(steps, h, acc, out_dtype)
    monkeypatch.setattr(ops, "spdmm_steps", spy)
    return calls


@pytest.mark.parametrize("name", ["b1", "b2", "b3", "b2 remapped"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_executor_runs_match_jax(name, backend, monkeypatch):
    model = name.split()[0]
    gj, gt = _graphs(seed=31)
    x = TG.random_features(gt, seed=4)
    je, eng = _jengine(), _engine(backend=backend)
    jprog, prog = je.compile(model, gj), eng.compile(model, gt)
    if name.endswith("remapped"):
        force = {_middle_tile(prog): "gemm"}
        jprog = je.remap(jprog, force=force, modes=("spdmm",))
        prog = eng.remap(prog, force=force, modes=("spdmm",))
        assert prog.binary == jprog.binary
    y_jax = np.asarray(je.run(jprog, jnp.asarray(x)))
    calls = _counting(monkeypatch)
    y = eng.run(prog, x)
    np.testing.assert_allclose(y.numpy(), y_jax, rtol=E2E_RTOL,
                               atol=E2E_ATOL)
    st = eng.exec_stats
    runs, steps = _runs(prog)
    assert st.tile_ops_by_mode["spdmm"] == steps
    if backend == "cuda":           # the torch backend steps in the ACK
        assert (len(calls), sum(calls)) == (runs, steps) and runs < steps
    if name.endswith("remapped"):
        assert st.tiles_remapped == je.exec_stats.tiles_remapped > 0
    # The host path steps one tile at a time: the same bits.
    calls.clear()
    assert torch.equal(eng.run(prog, x, residency="host"), y)
    assert not calls


def test_one_step_list_call_per_run_and_lane(monkeypatch):
    _, gt = _graphs(seed=32)
    eng = _engine(backend="cuda")
    prog = eng.compile("b2", gt)
    x = TG.random_features(gt, seed=5)
    calls = _counting(monkeypatch)
    ys = eng.run_batch(prog, np.stack([x, -0.5 * x, 2.0 * x]))
    runs, steps = _runs(prog)
    assert len(calls) == 3 * runs and sum(calls) == 3 * steps
    assert runs < steps
    for n, scale in enumerate((1.0, -0.5, 2.0)):
        assert torch.equal(ys[n], eng.run(prog, scale * x))
