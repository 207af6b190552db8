"""Models the port's tests build through both packages' builders.

``build_gat_dot`` is a single-head dot-product-attention GAT: the DP
attention form of SuperGAT (Kim & Oh, ICLR 2021; PyG
``SuperGATConv(attention_type="DP")``, negative slope 0.2) without its
self-supervised loss.  It uses only builder calls both packages have, so
``B`` is either ``repro.core.gnn_builders`` or
``repro_torch.core.gnn_builders`` and the two builds are the same model
(same layers, same numpy-seeded weights).  Per layer:

    h = Linear(prev)                       -> GEMM tiles
    e = VectorInner(h, mode="dot")         -> SDDMM tiles (dot mode)
    e = LeakyReLU(e), EdgeSoftmax(e)       -> edge activations
    out = Aggregate(h, SUM, weights e)     -> SpDMM tiles (dynamic weights)
    ReLU on every layer but the last.

``lrelu=False`` leaves the LeakyReLU out, so the fusion pass folds the
edge softmax into the VectorInner's epilogue (the fused-softmax case).
"""


def build_gat_dot(B, g, hidden: int = 64, n_layers: int = 2, seed: int = 0,
                  lrelu: bool = True):
    b = B._B(g, f"gatdot{n_layers}x{hidden}", seed)
    f, prev = g.feat_dim, None
    for i in range(n_layers):
        fo = hidden if i < n_layers - 1 else g.n_classes
        h = b.linear(prev, f, fo)
        e = b.vector_inner(h, fo, mode="dot")
        if lrelu:
            e = b.activation(e, 1, B.Activation.LRELU, on_edges=True)
        e = b.activation(e, 1, B.Activation.EDGE_SOFTMAX, on_edges=True)
        prev = b.aggregate(h, fo, B.AggOp.SUM, edge_weight_layer=e)
        if i < n_layers - 1:
            prev = b.activation(prev, fo, B.Activation.RELU)
        f = fo
    return b.m
