"""repro_torch.sampling — per-user mini-batch ego-network inference.

The port's copy of ``repro.sampling`` (the same exports), over the
port's runtime and graph-as-data execution:

  * :mod:`~repro_torch.sampling.csr` — cached CSR in-adjacency view on
    :class:`~repro_torch.core.graph.Graph` (``Graph.in_csr()``);
  * :mod:`~repro_torch.sampling.sampler` — seeded, deterministic k-hop
    fanout sampling, targets-first relabeling, per-hop frontiers;
  * :mod:`~repro_torch.sampling.buckets` — power-of-two geometry buckets
    with canonical ELL layouts; one compiled program per bucket,
    per-request topology as runtime ``graph_data``;
  * :mod:`~repro_torch.sampling.service` — :class:`SamplingService`:
    sample -> bucket -> batch -> overlay -> un-pad, over an
    :class:`~repro_torch.runtime.OverlayPool`.

Quickstart::

    from repro_torch.sampling import SamplingService, TargetRequest

    svc = SamplingService(graph, features, n_overlays=2, geometry=geom)
    resp = svc.submit(TargetRequest(targets=[7, 42], model="b1",
                                    fanouts=(10, 5)))
    resp.logits                                # [2, n_classes]
"""
from .buckets import Bucket, bucket_for, layout_graph, template_graph
from .csr import CSR, build_csr, in_csr
from .sampler import EgoNet, sample_ego
from .service import SamplingService, TargetRequest, TargetResponse

__all__ = [
    "Bucket", "CSR", "EgoNet", "SamplingService", "TargetRequest",
    "TargetResponse", "bucket_for", "build_csr", "in_csr", "layout_graph",
    "sample_ego", "template_graph",
]
