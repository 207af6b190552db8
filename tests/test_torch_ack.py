"""The port's ACK modes and reference against the JAX package's.

Every ACK mode of ``repro_torch.core.ack`` (backend ``torch``, and backend
``cuda`` on CPU tensors, where the kernel wrappers run their plain
versions) against ``repro.core.ack`` with backend ``xla``, on the same
numpy-seeded tiles; plus ``apply_activation``, edge softmax, aggregation
and ``run_reference`` against ``repro.core.reference``.  fp32 throughout,
rtol 1e-5 / atol 1e-5 for single ops, 2e-4 / 2e-5 end to end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ack as jack  # noqa: E402
from repro.core import gnn_builders as JB  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core import reference as JR  # noqa: E402
from repro.core.ir import Activation as JAct  # noqa: E402
from repro.core.ir import AggOp as JAgg  # noqa: E402
from repro_torch.core import ack as tack  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import reference as TR  # noqa: E402
from repro_torch.core.ir import Activation, AggOp  # noqa: E402

N1, N2, W = 32, 8, 16
BACKENDS = ["torch", "cuda"]


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _tile(seed=0):
    r = np.random.default_rng(seed)
    mask = r.random((N1, W)) > 0.35
    mask[3] = False                           # a row with no edges
    cols = np.where(mask, r.integers(0, N1, (N1, W)), 0).astype(np.int32)
    vals = np.where(mask, r.normal(0, 1, (N1, W)), 0.0).astype(np.float32)
    h = r.normal(0, 1, (N1, N2)).astype(np.float32)
    acc = r.normal(0, 1, (N1, N2)).astype(np.float32)
    return cols, vals, mask, h, acc


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("backend", BACKENDS)
def test_gemm_mode(backend):
    r = np.random.default_rng(1)
    h, w, acc = (r.normal(0, 1, s).astype(np.float32)
                 for s in ((N1, N2), (N2, N2), (N1, N2)))
    got = tack.ACK(backend).gemm(*_t(h, w, acc))
    want = jack.ACK("xla").gemm(*_j(h, w, acc))
    _close(got, want)
    _close(tack.ACK(backend).gemm(*_t(h, w)),
           np.asarray(jack.ACK("xla").gemm(*_j(h, w, np.zeros_like(acc)))))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_spdmm_mode(backend, op):
    cols, vals, mask, h, acc = _tile(2)
    if op == "max":
        acc = np.full_like(acc, -3.4e38)
    elif op == "min":
        acc = np.full_like(acc, 3.4e38)
    flag = np.zeros((N1,), bool)
    flag[5] = True
    got, gflag = tack.ACK(backend).spdmm(*_t(h, cols, vals, mask, acc,
                                             flag), op)
    want, wflag = jack.ACK("xla").spdmm(*_j(h, cols, vals, mask, acc, flag),
                                        op)
    _close(got, want)
    np.testing.assert_array_equal(gflag.numpy(), np.asarray(wflag))
    assert not gflag[3] and gflag[5]


@pytest.mark.parametrize("backend", BACKENDS)
def test_spdmm_zero_accumulator_and_no_flag(backend):
    cols, vals, mask, h, _ = _tile(3)
    got, flag = tack.ACK(backend).spdmm(*_t(h, cols, vals, mask), None,
                                        None, "sum")
    assert flag is None
    want, _ = jack.ACK("xla").spdmm(*_j(h, cols, vals, mask,
                                        np.zeros((N1, N2), np.float32),
                                        np.zeros((N1,), bool)), "sum")
    _close(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pair_sum", [False, True])
def test_sddmm_mode(backend, pair_sum):
    cols, _, mask, h, _ = _tile(4)
    r = np.random.default_rng(5)
    h_dst = r.normal(0, 1, (N1, N2)).astype(np.float32)
    acc = r.normal(0, 1, (N1, W)).astype(np.float32)
    got = tack.ACK(backend).sddmm(*_t(h_dst, h, cols, mask, acc),
                                  pair_sum=pair_sum)
    want = jack.ACK("xla").sddmm(*_j(h_dst, h, cols, mask, acc),
                                 pair_sum=pair_sum)
    _close(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_vadd_and_affine_modes(backend):
    r = np.random.default_rng(6)
    a, b = (r.normal(0, 1, (N1, N2)).astype(np.float32) for _ in range(2))
    sc, sh = (r.normal(0, 1, (N2,)).astype(np.float32) for _ in range(2))
    ack_t, ack_j = tack.ACK(backend), jack.ACK("xla")
    _close(ack_t.vadd(*_t(a, b), 1.0, 1.1), ack_j.vadd(*_j(a, b), 1.0, 1.1))
    _close(ack_t.affine(*_t(a, sc, sh)), ack_j.affine(*_j(a, sc, sh)))


@pytest.mark.parametrize("act", [a for a in Activation
                                 if a != Activation.EDGE_SOFTMAX])
def test_act_mode_every_activation(act):
    x = np.linspace(-4, 4, N1 * N2, dtype=np.float32).reshape(N1, N2)
    got = tack.ACK("torch").act(torch.from_numpy(x), act)
    want = jack.ACK("xla").act(jnp.asarray(x), JAct(int(act)))
    _close(got, want, rtol=2e-6, atol=2e-6)
    with pytest.raises(ValueError):
        TR.apply_activation(torch.from_numpy(x), Activation.EDGE_SOFTMAX)


def test_counter_keys_by_tile_shape():
    cols, vals, mask, h, acc = _tile(7)
    tack.reset_counter()
    ack = tack.ACK("torch")
    for _ in range(3):
        ack.gemm(*_t(h, np.ones((N2, N2), np.float32), acc))
        ack.spdmm(*_t(h, cols, vals, mask, acc), None, "sum")
    snap = tack.counter_snapshot()
    assert snap == {("gemm", (N1, N2), (N2, N2), "torch"): 3,
                    ("spdmm", (N1, N2), (N1, W), "sum", "torch"): 3}
    tack.reset_counter()
    assert tack.counter_snapshot() == {}


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        tack.ACK("xla")


# --------------------------------------------------------------------------- #
# The reference (the port's oracle) against the JAX reference.
# --------------------------------------------------------------------------- #
def _graph_pair(nv=60, ne=300, seed=0, isolated=False):
    out = []
    for G in (JG, TG):
        g = G.random_graph(nv, ne, seed=seed).gcn_normalized()
        if isolated:
            keep = g.dst < nv // 2          # upper half gets no edges
            g.src, g.dst, g.weight = (a[keep] for a in (g.src, g.dst,
                                                        g.weight))
        g.feat_dim, g.n_classes = 10, 3
        out.append(g)
    return out


@pytest.mark.parametrize("op", list(AggOp))
def test_aggregate_matches_jax_incl_empty_segments(op):
    gj, gt = _graph_pair(isolated=True)
    x = np.random.default_rng(8).normal(0, 1, (60, 5)).astype(np.float32)
    got = TR.aggregate(torch.from_numpy(x), gt, op, None)
    want = JR.aggregate(jnp.asarray(x), gj, JAgg(int(op)), None)
    _close(got, want)
    assert float(got[45].abs().max()) == 0.0     # empty segment -> 0


def test_edge_softmax_matches_jax():
    gj, gt = _graph_pair(isolated=True)
    ew = np.random.default_rng(9).normal(0, 3, gt.n_edges).astype(
        np.float32)
    got = TR.edge_softmax(torch.from_numpy(ew),
                          torch.from_numpy(gt.dst.astype(np.int64)), 60)
    want = JR.edge_softmax(jnp.asarray(ew), jnp.asarray(gj.dst), 60)
    _close(got, want)


@pytest.mark.parametrize("name", list(TB.BENCHMARKS))
def test_run_reference_matches_jax(name):
    gj, gt = _graph_pair(seed=1)
    x = JG.random_features(gj, seed=2)
    got = TR.run_reference(TB.build(name, gt), gt, x)
    want = JR.run_reference(JB.build(name, gj), gj, jnp.asarray(x))
    _close(got, want, rtol=2e-4, atol=2e-5)
    got64 = TR.run_reference(TB.build(name, gt), gt, x,
                             dtype=torch.float64)
    assert got64.dtype == torch.float64
    _close(got64, want, rtol=2e-4, atol=2e-5)
