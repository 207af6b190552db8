"""The frozen generator makes the configurations' Flickr."""
import numpy as np
import pytest

from gnnbench.harness import graphgen, spec


@pytest.mark.parametrize("config", ["gcn-b2-flickr", "gatdot-flickr"])
def test_flickr_sizes(config):
    g = spec.config(config)["graph"]
    assert (g["n_vertices"], g["n_edges"], g["feat_dim"], g["n_classes"]) \
        == (89250, 899756, 500, 7)
    src, dst = graphgen.edges(g)
    assert src.shape == dst.shape == (899756,)
    assert src.dtype == dst.dtype == np.int32
    assert 0 <= src.min() and max(src.max(), dst.max()) < 89250
    # Flickr's count of distinct edges: no multi-edges, no drawn loops.
    assert graphgen.distinct_pairs(src, dst, 89250) == 899756
    assert not (src == dst).any()
    s, d = graphgen.with_self_loops(src, dst, 89250)
    assert s.shape == (989006,)
    assert graphgen.distinct_pairs(s, d, 89250) == 989006
    # Power law: the busiest destination takes a far larger share than a
    # uniform graph's ~10 edges a vertex.
    assert np.bincount(dst, minlength=89250).max() > 10000


def test_frozen_copy_matches_the_ports_generator_today():
    """The first round of draws is the port's sampler's: its distinct
    pairs without loops, in the order drawn, lead the graph's edges."""
    from repro_torch.core import graph as G
    g = spec.config("gcn-b2-flickr")["graph"]
    want = G.synthesize("FL")
    n = g["n_vertices"]
    k = want.src.astype(np.int64) * n + want.dst
    k = k[want.src != want.dst]
    _, first = np.unique(k, return_index=True)
    k = k[np.sort(first)]
    src, dst = graphgen.edges(g)
    got = src.astype(np.int64) * n + dst
    assert np.array_equal(got[:k.shape[0]], k)


def test_distinct_pairs_counts_duplicates_once():
    src = np.array([0, 0, 1, 2], np.int32)
    dst = np.array([1, 1, 1, 0], np.int32)
    assert graphgen.distinct_pairs(src, dst, 3) == 3


def test_tiny_graph_has_distinct_edges_without_loops():
    g = {"n_vertices": 30, "n_edges": 400, "degree": "powerlaw",
         "alpha": 1.1, "seed": 4}
    src, dst = graphgen.edges(g)
    assert graphgen.distinct_pairs(src, dst, 30) == 400
    assert not (src == dst).any()
