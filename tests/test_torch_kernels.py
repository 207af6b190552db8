"""Port kernels (repro_torch.kernels) against the JAX package's kernels.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run their plain
torch versions; these are held against ``repro.kernels.ref`` and against
the Pallas kernels in interpret mode on the GEMM / SpDMM sweeps of
``tests/test_kernels.py`` (fp32, rtol 1e-5 / atol 1e-4).  The CUDA kernels
themselves are held against the plain versions in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4

GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
               (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258)]
SPDMM_SHAPES = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
                (32, 64, 32, 8), (8, 8, 8, 8)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _spdmm_inputs(n1, w, ns, f, seed):
    r = np.random.default_rng(seed)
    cols = r.integers(0, ns, (n1, w)).astype(np.int32)
    vals = (r.normal(0, 1, (n1, w)) * (r.random((n1, w)) > 0.4)
            ).astype(np.float32)
    h = r.normal(0, 1, (ns, f)).astype(np.float32)
    return cols, vals, h


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_matches_jax(m, k, n):
    r = np.random.default_rng(m * 7 + k)
    x = r.normal(0, 1, (m, k)).astype(np.float32)
    w = r.normal(0, 1, (k, n)).astype(np.float32)
    acc = r.normal(0, 1, (m, n)).astype(np.float32)
    got = ops.gemm(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(acc)).numpy()
    want = acc + np.asarray(jref.gemm_ref(jnp.asarray(x), jnp.asarray(w)))
    _close(got, want)
    pallas = acc + np.asarray(jops.gemm(jnp.asarray(x), jnp.asarray(w),
                                        interpret=True))
    _close(got, pallas)
    _close(ref.gemm_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
           np.asarray(jref.gemm_ref(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("n1,w,ns,f", SPDMM_SHAPES)
def test_spdmm_matches_jax(n1, w, ns, f):
    cols, vals, h = _spdmm_inputs(n1, w, ns, f, seed=n1 + w)
    got = ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals),
                    torch.from_numpy(h)).numpy()
    jc, jv, jh = jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(h)
    _close(got, np.asarray(jref.spdmm_ref(jc, jv, jh)))
    _close(got, np.asarray(jops.spdmm(jc, jv, jh, interpret=True)))
    acc = np.full((n1, f), 0.5, np.float32)
    got_acc = ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals),
                        torch.from_numpy(h), torch.from_numpy(acc)).numpy()
    _close(got_acc, acc + got)


def test_zero_padding_is_inert():
    got = ops.spdmm(torch.zeros(16, 8, dtype=torch.int32),
                    torch.zeros(16, 8), torch.randn(16, 16))
    assert float(got.abs().max()) == 0.0


def test_cpu_wrappers_do_not_count_launches():
    ops.reset_launches()
    ops.gemm(torch.ones(4, 4), torch.ones(4, 4))
    ops.spdmm(torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, 8),
              torch.ones(4, 4))
    assert ops.LAUNCHES == {"gemm": 0, "spdmm": 0}


def test_wrapper_checks_reject_bad_operands():
    # Layout checks the CUDA path applies before a launch.
    ops._check_matrix("ok", torch.zeros(4, 8)[:, 2:6], torch.float32)
    with pytest.raises(TypeError):
        ops._check_matrix("x", torch.zeros(4, 4, dtype=torch.float64),
                          torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_matrix("x", torch.zeros(8, 4).t(), torch.float32)
    with pytest.raises(ValueError, match="shape"):
        ops._check_matrix("x", torch.zeros(4, 4), torch.float32, (4, 5))
    with pytest.raises(ValueError, match="matrix"):
        ops._check_matrix("x", torch.zeros(4), torch.float32)


def test_build_is_keyed_by_source(monkeypatch):
    # The library name hashes the source and flags, so it is stable for
    # a given checkout; without a toolkit the build names what is missing.
    p1, p2 = build._lib_path("gemm"), build._lib_path("gemm")
    assert p1 == p2 and p1 != build._lib_path("spdmm")
    assert p1.startswith(build.BUILD_DIR)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_sources_carry_their_notes():
    for name in build.SOURCES:
        with open(f"{build.CSRC}/{name}.cu") as fh:
            head = fh.read(3000)
        assert f"src/repro/kernels/{name}.py" in head
        assert "bound" in head and "Design" in head
