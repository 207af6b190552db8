"""The port on a CUDA device: hand kernels against their plain versions,
and the Engine against the float64 reference.

Every test here is marked ``gpu`` and skips without a card.  This file
imports neither ``jax`` nor ``repro``, so it also runs where JAX is not
installed; there the repository's ``conftest.py`` (which imports JAX) is
left out:

    python -m pytest -q --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import reference as TR  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu

GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
               (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258),
               (4096, 128, 128)]
SPDMM_SHAPES = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
                (32, 64, 32, 8), (8, 8, 8, 8), (4096, 512, 4096, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_cuda_gemm_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, 2 * k, generator=g, device=cuda)[:, k:]
    w = torch.randn(k, n, generator=g, device=cuda)
    acc = torch.randn(m, n, generator=g, device=cuda)
    ops.reset_launches()
    got = ops.gemm(x, w, acc)
    assert ops.LAUNCHES["gemm"] == 1
    _close(got, acc + ref.gemm_ref(x, w))
    _close(ops.gemm(x, w), ref.gemm_ref(x, w))


@pytest.mark.parametrize("n1,w,ns,f", SPDMM_SHAPES)
def test_cuda_spdmm_matches_plain(cuda, n1, w, ns, f):
    r = np.random.default_rng(3)
    cols = torch.from_numpy(r.integers(0, ns, (n1, w)).astype(np.int32))
    vals = torch.from_numpy((r.normal(0, 1, (n1, w))
                             * (r.random((n1, w)) > 0.4)).astype(np.float32))
    h = torch.from_numpy(r.normal(0, 1, (ns, 2 * f)).astype(np.float32))
    c, v, hd = cols.to(cuda), vals.to(cuda), h.to(cuda)[:, f:]
    acc = torch.ones(n1, f, device=cuda)
    ops.reset_launches()
    got = ops.spdmm(c, v, hd, acc)
    assert ops.LAUNCHES["spdmm"] == 1
    _close(got, acc + ref.spdmm_ref(c, v, hd))


def test_cuda_wrappers_reject_bad_operands(cuda):
    x = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        ops.gemm(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.gemm(x, torch.zeros(8, 8))              # mixed devices
    with pytest.raises(ValueError, match="contiguous"):
        ops.spdmm(torch.zeros(8, 16, dtype=torch.int32, device=cuda)[:, ::2],
                  torch.zeros(8, 8, device=cuda), x)


@pytest.mark.parametrize("name", list(TB.BENCHMARKS))
def test_cuda_engine_matches_reference(cuda, name):
    g = TG.random_graph(90, 400, seed=0).gcn_normalized()
    g.feat_dim, g.n_classes = 12, 4
    x = TG.random_features(g, seed=2)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    assert eng.device.type == "cuda" and eng.backend == "cuda"
    ops.reset_launches()
    y = eng.run(eng.compile(name, g), x)
    modes = eng.exec_stats.tile_ops_by_mode
    assert ops.LAUNCHES["gemm"] == modes.get("gemm", 0) > 0
    assert ops.LAUNCHES["spdmm"] == modes.get("spdmm", 0) > 0
    want = TR.run_reference(TB.build(name, g), g,
                            torch.as_tensor(x, device=cuda),
                            dtype=torch.float64)
    _close(y, want, rtol=2e-4, atol=2e-5)
