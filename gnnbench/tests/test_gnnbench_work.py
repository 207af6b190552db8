"""The work counts against FLOPs and bytes worked out by hand."""
import pytest

from gnnbench.models import gatdot, gcn

# A 3-layer toy: V = 10 vertices, 40 distinct non-zeros, widths 6 -> 4
# -> 4 -> 3.
V, NNZ = 10, 40
TOY = {"n_layers": 3, "hidden": 4,
       "graph": {"feat_dim": 6, "n_classes": 3}}


def test_gcn_counts_by_hand():
    w = gcn.work(TOY, V, NNZ, 1)
    # LINEAR: 2 V fi fo, bytes 4 (V fi + fi fo + fo + V fo).
    gemm_f = 2 * 10 * (6 * 4 + 4 * 4 + 4 * 3)              # 1,040
    gemm_b = 4 * ((60 + 24 + 4 + 40) + (40 + 16 + 4 + 40)
                  + (40 + 12 + 3 + 30))                    # 1,252
    # Aggregation at the narrower width: 4, 4, 3.
    spdmm_f = 2 * 40 * (4 + 4 + 3)                         # 880
    spdmm_b = 4 * ((2 * 10 * 4 + 80 + 11) * 2 + (2 * 10 * 3 + 80 + 11))
    assert w["gemm"] == (gemm_f, gemm_b)
    assert w["spdmm"] == (spdmm_f, spdmm_b)
    assert set(w) == {"gemm", "spdmm"}


def test_gatdot_counts_by_hand():
    w = gatdot.work(TOY, V, NNZ, 1)
    struct = 40 + 10 + 1
    assert w["gemm"] == gcn.work(TOY, V, NNZ, 1)["gemm"]
    assert w["sddmm"] == (2 * 40 * 11,
                          4 * (10 * 11 + 3 * struct + 3 * 40))
    assert w["spdmm"] == (2 * 40 * 11,
                          4 * (2 * 10 * 11 + 3 * 40 + 3 * struct))


@pytest.mark.parametrize("fam", [gcn, gatdot])
def test_lanes_share_weights_and_structure(fam):
    """A pass of n lanes needs n times each lane's operations, and reads
    the weights and the adjacency's structure once."""
    one, four = fam.work(TOY, V, NNZ, 1), fam.work(TOY, V, NNZ, 4)
    for k in one:
        assert four[k][0] == 4 * one[k][0]
        assert four[k][1] < 4 * one[k][1]


def test_flickr_b2_request_is_about_12_gflop():
    cfg = {"n_layers": 2, "hidden": 128,
           "graph": {"feat_dim": 500, "n_classes": 7}}
    total = sum(f for f, _ in gcn.work(cfg, 89250, 989006, 1).values())
    assert total == pytest.approx(2 * 89250 * (500 * 128 + 128 * 7)
                                  + 2 * 989006 * (128 + 7))
