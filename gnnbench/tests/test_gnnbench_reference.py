"""The plain references against the port's Engine on the CPU, at a
300-vertex graph: the program's graph, model and weights are built as a
run builds them, and only the raw edges, weights and features reach the
reference."""
import numpy as np
import pytest
import torch

from gnnbench.harness import check, graphgen, inputs
from gnnbench.tests import tiny


@pytest.mark.parametrize("config", ["gcn-b2-flickr", "gatdot-flickr"])
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_reference_agrees_with_engine_on_cpu(config, seed):
    from repro_torch.core import gnn_builders as B
    from repro_torch.core import graph as G
    from repro_torch.core.reference import run_reference
    from repro_torch.engine import Engine

    cell = tiny.cell(config)
    cfg, fam = cell.config, cell.family
    src, dst = graphgen.edges(cfg["graph"])
    graph = fam.program_graph(G, src, dst, cfg)
    model = fam.program_model(B, graph, cfg)
    inp = inputs.make(cfg, cell.traffic, fam, seed, "cpu")
    inputs.bind_weights(model, inp.linears)
    engine = Engine(device="cpu", verify=False)
    prog = engine.compile(model, graph)
    refs = check.reference_outputs(cell.reference, cfg, (src, dst), inp,
                                   range(cell.traffic["pool"]))
    for k, want in refs.items():
        got = engine.run(prog, inp.features[k])
        assert check.out_err(got, want) < 1e-6
        # The port's own plain reference in float64 on the same weights
        # (its GCN edge weights are float32, so not bit for bit).
        own = run_reference(model, graph, inp.features[k].double(),
                            dtype=torch.float64)
        assert check.out_err(own, want) < 1e-6


def test_program_graph_carries_the_references_edge_weights():
    """The port's gcn_normalized weights equal the ones the GCN reference
    recomputes from the raw edges."""
    from repro_torch.core import graph as G

    cell = tiny.cell("gcn-b2-flickr")
    cfg = cell.config
    src, dst = graphgen.edges(cfg["graph"])
    n = cfg["graph"]["n_vertices"]
    graph = cell.family.program_graph(G, src, dst, cfg)
    s, d = graphgen.with_self_loops(src, dst, n)
    deg = np.maximum(np.bincount(d, minlength=n), 1).astype(np.float64)
    want = 1.0 / np.sqrt(deg[s] * deg[d])
    assert np.array_equal(graph.src, s) and np.array_equal(graph.dst, d)
    np.testing.assert_allclose(graph.weight, want, rtol=1e-6)


@pytest.mark.parametrize("config", ["gcn-b2-flickr", "gatdot-flickr"])
def test_biases_are_drawn_from_the_seed(config):
    cell = tiny.cell(config)
    inp = inputs.make(cell.config, cell.traffic, cell.family, 5, "cpu")
    for _, b in inp.linears:
        assert float(b.abs().min()) > 0


def test_gcn_bias_before_the_aggregation_fails_the_limit():
    """A program that adds GCN's bias before the aggregation, A (H W + b)
    for (A H) W + b, misses the reference by more than the limit."""
    from gnnbench.reference import common

    cell = tiny.cell("gcn-b2-flickr")
    cfg = cell.config
    n = cfg["graph"]["n_vertices"]
    src, dst = graphgen.edges(cfg["graph"])
    inp = inputs.make(cfg, cell.traffic, cell.family, 6, "cpu")
    lin = [(w.double(), b.double()) for w, b in inp.linears]
    x = inp.features[0].double()
    want = cell.reference.forward(x, src, dst, n, lin, cfg)
    s, d = common.edges_with_self_loops(src, dst, n, "cpu")
    deg = torch.bincount(d, minlength=n).double().rsqrt()
    h = x
    for i, (w, b) in enumerate(lin):
        h = common.scatter_rows(h @ w + b, s, d, deg[s] * deg[d], n)
        if i < len(lin) - 1:
            h = torch.relu(h)
    assert check.out_err(h, want) > cfg["check"]["out_err"]
