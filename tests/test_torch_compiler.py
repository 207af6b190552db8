"""The port's compiler copy against the JAX package's compiler.

The ``.gagi`` format is the contract between the two packages, so the
port's binary must be byte-identical to the JAX compiler's for the same
(model, graph, options), and its manifest equal in full, ``dep_graph``
included.  Models are built by both packages' builders from the same seed
(numpy generators), so their weights agree too.  The same holds of the
remap pass: for the same program, constants and ``force`` / ``modes``,
the port's ``remap_program`` writes JAX's bytes and ``remap`` record.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_models import build_gat_dot  # noqa: E402
from repro.core import compiler as JC  # noqa: E402
from repro.core import gnn_builders as JB  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.core.passes.remap import \
    remap_program as j_remap_program  # noqa: E402
from repro.engine.program import from_program as j_from_program  # noqa: E402
from repro_torch.core import compiler as TC  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core.passes.partition import \
    PartitionConfig as TPC  # noqa: E402
from repro_torch.core.passes.remap import \
    remap_program as t_remap_program  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine.program import \
    from_program as t_from_program  # noqa: E402


def _graphs(nv=90, ne=400, f=12, c=4, seed=0, degree="uniform"):
    out = []
    for G in (JG, TG):
        g = G.random_graph(nv, ne, seed=seed, degree=degree).gcn_normalized()
        g.feat_dim, g.n_classes = f, c
        out.append(g)
    return out


def _compile_both(name, gj, gt, order_opt=True, fusion=True,
                  geom=(32, 8)):
    jo = JC.CompileOptions(order_opt=order_opt, fusion=fusion, n_pes=4,
                           partition=JPC(n1=geom[0], n2=geom[1]))
    to = TC.CompileOptions(order_opt=order_opt, fusion=fusion, n_pes=4,
                           partition=TPC(n1=geom[0], n2=geom[1]))
    jr = JC.run_pipeline(JB.build(name, gj), gj, jo)
    tr = TC.run_pipeline(TB.build(name, gt), gt, to)
    return jr, tr


def _assert_same_program(jr, tr):
    assert tr.binary == jr.binary
    jp = j_from_program(jr.program, binary=jr.binary)
    tp = t_from_program(tr.program, binary=tr.binary)
    _assert_same_compiled(jp, tp)


def _assert_same_compiled(jp, tp):
    jm = json.loads(json.dumps(jp.manifest))
    tm = json.loads(json.dumps(tp.manifest))
    assert "dep_graph" in jm
    assert tm == jm
    assert sorted(tp.weights) == sorted(jp.weights)
    for k in jp.weights:
        np.testing.assert_array_equal(tp.weights[k], jp.weights[k])
    assert sorted(tp.pgraph.tiles) == sorted(jp.pgraph.tiles)
    for key, slices in jp.pgraph.tiles.items():
        for a, b in zip(slices, tp.pgraph.tiles[key], strict=True):
            np.testing.assert_array_equal(a.cols, b.cols)
            np.testing.assert_array_equal(a.vals, b.vals)
            np.testing.assert_array_equal(a.edge_pos, b.edge_pos)
    np.testing.assert_array_equal(tp.pgraph.inv_in_degree,
                                  jp.pgraph.inv_in_degree)


@pytest.mark.parametrize("name", list(JB.BENCHMARKS))
def test_binary_and_manifest_identical(name):
    gj, gt = _graphs()
    _assert_same_program(*_compile_both(name, gj, gt))


@pytest.mark.parametrize("name", ["b1", "b5", "b6", "b8"])
def test_no_opt_path_identical(name):
    gj, gt = _graphs(seed=7)
    _assert_same_program(*_compile_both(name, gj, gt, order_opt=False,
                                        fusion=False))


@pytest.mark.parametrize("name", ["b1", "b3", "b6"])
def test_powerlaw_graph_identical(name):
    gj, gt = _graphs(nv=150, ne=1200, degree="powerlaw", seed=5)
    _assert_same_program(*_compile_both(name, gj, gt))


@pytest.mark.parametrize("degree,lrelu", [("uniform", True),
                                          ("powerlaw", True),
                                          ("powerlaw", False)])
def test_gat_dot_identical(degree, lrelu):
    # The dot-product-attention GAT, built by each package's builders
    # through the same helper (lrelu=False: the fused-softmax variant).
    gj, gt = _graphs(nv=120, ne=700, degree=degree, seed=23)
    opts = [C.CompileOptions(n_pes=4, partition=P(n1=32, n2=8))
            for C, P in ((JC, JPC), (TC, TPC))]
    jr = JC.run_pipeline(build_gat_dot(JB, gj, hidden=16, lrelu=lrelu), gj,
                         opts[0])
    tr = TC.run_pipeline(build_gat_dot(TB, gt, hidden=16, lrelu=lrelu), gt,
                         opts[1])
    _assert_same_program(jr, tr)


def test_default_geometry_and_width_slicing_identical():
    # choose_partition's automatic geometry, and a width cap narrow enough
    # that power-law hub rows are sliced into several ELL tiles.
    gj, gt = _graphs(nv=200, ne=3000, degree="powerlaw", seed=3, f=40)
    jr = JC.run_pipeline(JB.build("b2", gj), gj, JC.CompileOptions())
    tr = TC.run_pipeline(TB.build("b2", gt), gt, TC.CompileOptions())
    _assert_same_program(jr, tr)
    jo = JC.CompileOptions(partition=JPC(n1=32, n2=8, width_cap=16))
    to = TC.CompileOptions(partition=TPC(n1=32, n2=8, width_cap=16))
    jr = JC.run_pipeline(JB.build("b3", gj), gj, jo)
    tr = TC.run_pipeline(TB.build("b3", gt), gt, to)
    assert max(len(s) for s in tr.program.pgraph.tiles.values()) > 1
    _assert_same_program(jr, tr)


@pytest.mark.parametrize("seed", [0, 1])
def test_cache_keys_agree(seed):
    gj, gt = _graphs(seed=seed)
    je = JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)
    te = TEngine(geometry=TPC(n1=32, n2=8), n_pes=4, device="cpu")
    for name in ("b1", "b6"):
        assert te.cache_key(name, gt) == je.cache_key(name, gj)
        assert (te.cache_key(TB.build(name, gt, seed), gt)
                == je.cache_key(JB.build(name, gj, seed), gj))


def test_synthesized_graphs_identical():
    for name in ("CO", "PU"):
        a, b = JG.synthesize(name, scale=0.05), TG.synthesize(name,
                                                              scale=0.05)
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.dst, b.dst)
        np.testing.assert_array_equal(
            JG.random_features(a, seed=3), TG.random_features(b, seed=3))


@pytest.mark.parametrize("name", list(JB.BENCHMARKS))
@pytest.mark.parametrize("how", [{"force": "gemm"}, {"force": "spdmm"},
                                 {}])
def test_remapped_binary_and_record_identical(name, how):
    """Forced GEMM, forced SpDMM and auto (TPU default constants): the
    same bytes, the same manifest (``dep_graph`` refreshed from the new
    binary) and the same ``remap`` record, apart from its timing."""
    gj, gt = _graphs(nv=150, ne=1200, degree="powerlaw", seed=5)
    jr, tr = _compile_both(name, gj, gt)
    jp = j_remap_program(j_from_program(jr.program, binary=jr.binary),
                         **how)
    tp = t_remap_program(t_from_program(tr.program, binary=tr.binary),
                         **how)
    assert tp.binary == jp.binary
    if how.get("force") == "gemm":
        assert tp.binary != tr.binary
    for p in (jp, tp):
        assert p.manifest["remap"].pop("remap_ms") >= 0.0
    _assert_same_compiled(jp, tp)
