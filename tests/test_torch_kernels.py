"""Port kernels (repro_torch.kernels) against the JAX package's kernels.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run their plain
torch versions; these are held against ``repro.kernels.ref`` and against
the Pallas kernels in interpret mode on the GEMM / SpDMM / SDDMM sweeps of
``tests/test_kernels.py`` (fp32, rtol 1e-5 / atol 1e-4; SDDMM at the JAX
sweep's rtol 1e-4 / atol 1e-4; the bf16 GEMM / SpDMM sweeps at its bf16
rtol 2e-2 / atol 1e-2), and the masked, accumulating SDDMM step against
the JAX ACK's ``"xla"`` SDDMM step.  The GEMM kernel's host-side route
rule for bf16 operands (TMA or staged, by alignment and row stride) is
checked on CPU tensors.  The CUDA kernels themselves
are held against the plain versions in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.ack import ACK as JACK  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4

GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
               (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258)]
SPDMM_SHAPES = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
                (32, 64, 32, 8), (8, 8, 8, 8)]
SDDMM_SHAPES = [(128, 16, 128, 128), (64, 8, 96, 256), (56, 24, 70, 33),
                (8, 8, 8, 8)]


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


BF16_RTOL, BF16_ATOL = 2e-2, 1e-2       # tests/test_kernels.py's bf16 case


def _bf16(a):
    """A numpy array rounded to bf16, as both packages' tensors."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_bf16_matches_jax(m, k, n):
    # bf16 x and w (fp32 sums) as the Pallas kernel takes them, out fp32 by
    # default and bf16 on request (its out_dtype).
    r = np.random.default_rng(m * 5 + n)
    jx, tx = _bf16(r.normal(0, 1, (m, k)))
    jw, tw = _bf16(r.normal(0, 1, (k, n)))
    got = ops.gemm(tx, tw)
    assert got.dtype == torch.float32
    want = np.asarray(jops.gemm(jx, jw, interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    _close(got.numpy(), np.asarray(jref.gemm_ref(jx, jw)))
    out16 = ops.gemm(tx, tw, out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, got.bfloat16())
    np.testing.assert_allclose(
        out16.float().numpy(),
        np.asarray(jref.gemm_ref(jx, jw, jnp.bfloat16), np.float32),
        rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("n1,w,ns,f", SPDMM_SHAPES)
def test_spdmm_bf16_matches_jax(n1, w, ns, f):
    cols, vals, h = _spdmm_inputs(n1, w, ns, f, seed=n1 * 3 + f)
    jh, th = _bf16(h)
    jc, jv = jnp.asarray(cols), jnp.asarray(vals)
    got = ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals), th)
    assert got.dtype == torch.float32
    want = np.asarray(jops.spdmm(jc, jv, jh, interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL)
    _close(got.numpy(), np.asarray(jref.spdmm_ref(jc, jv, jh)))


def _bf16_view(rows, width, col0=0, cols=None):
    """A bf16 [rows, cols] view starting at column col0 of a [rows, width]
    buffer (CPU buffers start on 64-byte boundaries)."""
    buf = torch.zeros(rows, width, dtype=torch.bfloat16)
    return buf[:, col0:col0 + (cols or width - col0)]


# (x, w, route, x's copy width): the bf16 body loads x and w by TMA where
# both start on 16-byte boundaries with row strides of multiples of 16
# bytes, else stages them (copies as wide as the base and stride allow).
GEMM_ROUTE_CASES = [
    ("aligned", lambda: (_bf16_view(64, 128), _bf16_view(128, 64)),
     "tma", 16),
    ("x 16 bytes in", lambda: (_bf16_view(64, 136, 8, 128),
                               _bf16_view(128, 64)), "tma", 16),
    ("x 8 bytes in", lambda: (_bf16_view(64, 136, 4, 128),
                              _bf16_view(128, 64)), "staged", 8),
    ("x 2 bytes in", lambda: (_bf16_view(64, 129, 1),
                              _bf16_view(128, 64)), "staged", 2),
    ("x rows of 120 bytes", lambda: (_bf16_view(64, 60),
                                     _bf16_view(60, 64)), "staged", 8),
    ("w rows of 2 bytes", lambda: (_bf16_view(1, 128), _bf16_view(128, 1)),
     "staged", 16),
    ("w rows of 66 bytes", lambda: (_bf16_view(100, 120, 60),
                                    _bf16_view(60, 33)), "staged", 8),
    ("a single x row, its stride its width", lambda: (
        _bf16_view(1, 64), _bf16_view(64, 8)), "tma", 16),
]


@pytest.mark.parametrize("x_w,route,width",
                         [pytest.param(f, r, wd, id=n)
                          for n, f, r, wd in GEMM_ROUTE_CASES])
def test_gemm_bf16_route_rule(x_w, route, width):
    x, w = x_w()
    assert ops.gemm_bf16_route(x, w) == route
    assert ops._copy_width(x.data_ptr(), ops._ld(x), 2) == width
    # The route depends on where the operands lie, not on their values.
    assert ops.gemm_bf16_route(x.contiguous(), w.contiguous()) == (
        "tma" if x.shape[1] % 8 == 0 and w.shape[1] % 8 == 0 else "staged")


def test_gemm_refuses_an_output_dtype_the_kernels_lack():
    with pytest.raises(TypeError, match="out_dtype"):
        ops.gemm(torch.ones(2, 2), torch.ones(2, 2),
                 out_dtype=torch.float16)


def _ell_with_row_len(n1, w, ns, f, seed):
    """An ELL tile whose rows end at random live lengths (0 .. w) with pads
    between live slots (vals 0), and its row_len (1 + last live slot)."""
    r = np.random.default_rng(seed)
    lens = r.integers(0, w + 1, n1)
    lens[:4] = [0, 1, max(w - 1, 0), w]
    live = (np.arange(w)[None, :] < lens[:, None]) & (r.random((n1, w)) > 0.3)
    live[np.arange(n1), np.maximum(lens - 1, 0)] |= lens > 0
    cols = np.where(live, r.integers(0, ns, (n1, w)), 0).astype(np.int32)
    vals = np.where(live, r.normal(0, 1, (n1, w)), 0).astype(np.float32)
    h = r.normal(0, 1, (ns, f)).astype(np.float32)
    row_len = np.where(live.any(1), w - np.argmax(live[:, ::-1], 1), 0)
    return cols, vals, h, live, row_len.astype(np.int32)


@pytest.mark.parametrize("n1,w,ns,f", SPDMM_SHAPES)
def test_spdmm_row_len_matches_jax(n1, w, ns, f):
    # The ACK's SUM step with the staged live length: the plain version
    # walks the same slots as the kernel and equals the JAX spdmm (whose
    # pads add zeros) at the sweep tolerance.
    from repro_torch.core.ack import ACK
    cols, vals, h, live, row_len = _ell_with_row_len(n1, w, ns, f,
                                                     seed=n1 * 3 + w)
    assert list(row_len[:4]) == [0, 1, max(w - 1, 0), w][:len(row_len[:4])]
    want = np.asarray(jref.spdmm_ref(jnp.asarray(cols), jnp.asarray(vals),
                                     jnp.asarray(h)))
    acc = np.full((n1, f), 0.25, np.float32)
    for backend in ("torch", "cuda"):
        got, _ = ACK(backend=backend).spdmm(
            torch.from_numpy(h), torch.from_numpy(cols),
            torch.from_numpy(vals), torch.from_numpy(live),
            torch.from_numpy(acc), None, "sum", torch.from_numpy(row_len))
        _close(got.numpy(), acc + want)
    got = ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals),
                    torch.from_numpy(h), row_len=torch.from_numpy(row_len))
    _close(got.numpy(), want)


def test_spdmm_plain_version_stops_at_row_len():
    # Slots from row_len[r] on are not summed, even when they hold a value:
    # the plain version computes what the kernel computes.
    cols = torch.tensor([[0, 1, 2], [2, 2, 0]], dtype=torch.int32)
    vals = torch.tensor([[1.0, 2.0, 4.0], [1.0, 1.0, 8.0]])
    h = torch.tensor([[1.0], [10.0], [100.0]])
    row_len = torch.tensor([2, 0], dtype=torch.int32)
    got = ops.spdmm(cols, vals, h, row_len=row_len)
    assert got.flatten().tolist() == [21.0, 0.0]
    assert ops.spdmm(cols, vals, h).flatten().tolist() == [421.0, 208.0]


def _sddmm_inputs(n1, w, ns, f, seed):
    r = np.random.default_rng(seed)
    cols = r.integers(0, ns, (n1, w)).astype(np.int32)
    hd = r.normal(0, 1, (n1, f)).astype(np.float32)
    hs = r.normal(0, 1, (ns, f)).astype(np.float32)
    mask = r.random((n1, w)) > 0.4
    acc = r.normal(0, 1, (n1, w)).astype(np.float32)
    return cols, hd, hs, mask, acc


@pytest.mark.parametrize("n1,w,ns,f", SDDMM_SHAPES)
def test_sddmm_matches_jax(n1, w, ns, f):
    cols, hd, hs, _, _ = _sddmm_inputs(n1, w, ns, f, seed=n1 + f)
    got = ops.sddmm(torch.from_numpy(hd), torch.from_numpy(hs),
                    torch.from_numpy(cols)).numpy()
    jc, jd, js = jnp.asarray(cols), jnp.asarray(hd), jnp.asarray(hs)
    for want in (jref.sddmm_ref(jd, js, jc),
                 jops.sddmm(jd, js, jc, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(
        ref.sddmm_ref(torch.from_numpy(hd), torch.from_numpy(hs),
                      torch.from_numpy(cols)).numpy(), got)


@pytest.mark.parametrize("n1,w,ns,f", SDDMM_SHAPES)
def test_sddmm_masked_step_matches_jax_ack(n1, w, ns, f):
    # The ACK's whole dot-mode step: acc + where(mask, score, 0).
    cols, hd, hs, mask, acc = _sddmm_inputs(n1, w, ns, f, seed=n1 + w)
    got = ops.sddmm(torch.from_numpy(hd), torch.from_numpy(hs),
                    torch.from_numpy(cols), torch.from_numpy(mask),
                    torch.from_numpy(acc)).numpy()
    want = JACK(backend="xla").sddmm(
        jnp.asarray(hd), jnp.asarray(hs), jnp.asarray(cols),
        jnp.asarray(mask), jnp.asarray(acc))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[~mask], acc[~mask])
    # the ACK routes a dot-mode step through the wrapper on both backends
    from repro_torch.core.ack import ACK
    for backend in ("torch", "cuda"):
        step = ACK(backend=backend).sddmm(
            torch.from_numpy(hd), torch.from_numpy(hs),
            torch.from_numpy(cols), torch.from_numpy(mask),
            torch.from_numpy(acc))
        np.testing.assert_allclose(step.numpy(), got, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad_col", [-1, 5])
def test_sddmm_rejects_columns_outside_h_src(bad_col):
    cols = torch.zeros(4, 3, dtype=torch.int32)
    cols[1, 2] = bad_col
    with pytest.raises(ValueError, match="outside"):
        ops.sddmm(torch.ones(4, 8), torch.ones(5, 8), cols)


def test_zero_padding_is_inert():
    got = ops.spdmm(torch.zeros(16, 8, dtype=torch.int32),
                    torch.zeros(16, 8), torch.randn(16, 16))
    assert float(got.abs().max()) == 0.0


def test_cpu_wrappers_do_not_count_launches():
    ops.reset_launches()
    ops.gemm(torch.ones(4, 4), torch.ones(4, 4))
    ops.spdmm(torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, 8),
              torch.ones(4, 4))
    ops.sddmm(torch.ones(4, 4), torch.ones(4, 4),
              torch.zeros(4, 8, dtype=torch.int32))
    ops.flash_attention(torch.ones(2, 3, 4), torch.ones(2, 5, 4),
                        torch.ones(2, 5, 4))
    ops.densify(torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, 8), 6)
    assert ops.LAUNCHES == {"gemm": 0, "spdmm": 0, "sddmm": 0,
                            "flash_attention": 0, "densify": 0}


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


def _root_script(name):
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _planted_edits():
    kv = _root_script("kernel_variants")
    faults = _root_script("flash_faults").FAULTS
    out = [pytest.param(kv.SOURCE.get(k, k), edits, id=f"{k}:{n}")
           for k, vs in kv.VARIANTS.items() for n, (_, edits) in vs.items()]
    out += [pytest.param("gemm", edits, id=f"gemm_bf16:fault_{n}")
            for n, (_, edits) in kv.GEMM_FAULTS.items()]
    out += [pytest.param("flash_attention", [(old, new)],
                         id=f"flash_attention:{n}")
            for n, (_, old, new) in faults.items()]
    return out


@pytest.mark.parametrize("kernel,edits", _planted_edits())
def test_planted_edits_still_fit_their_sources(kernel, edits):
    # The tile-shape variants and planted faults are text edits of the
    # sources in csrc/: each must still name text that appears exactly once.
    src = build.edited(kernel, [])
    out = build.edited(kernel, edits)
    assert out != src
    for _, new in edits:
        assert new in out


def test_edited_refuses_text_not_in_the_source_once():
    with pytest.raises(ValueError, match="exactly once"):
        build.edited("gemm", [("no such text in the source", "x")])
    with pytest.raises(ValueError, match="exactly once"):
        build.edited("gemm", [("float", "double")])


def _sparse_report(spill=0, drop_last=False):
    # A ptxas -v report in nvcc's layout: the densify kernel and the eight
    # instantiations of the SDDMM body (route, h type, out type).
    names = ["_ZN12_GLOBAL__N_118ell_densify_kernelEPKiPKfPfiiixi"]
    for vec in "01":
        for args in ("ff", "f13__nv_bfloat16", "13__nv_bfloat16f",
                     "13__nv_bfloat16S1_"):
            names.append(f"_ZN12_GLOBAL__N_116sddmm_f32_kernelILb{vec}E"
                         f"{args}EEvPKT0_S4_PKiPKhPKfPT1_iiiixx")
    if drop_last:
        names = names[:-1]
    lines = []
    for i, n in enumerate(names):
        s = spill if i == 3 else 0
        lines += [f"ptxas info    : Compiling entry function '{n}' for "
                  "'sm_90a'",
                  f"ptxas info    : Function properties for {n}",
                  f"    0 bytes stack frame, {s} bytes spill stores, {s} "
                  "bytes spill loads",
                  f"ptxas info    : Used {40 + i} registers, used 0 "
                  "barriers, 2048 bytes smem"]
    return "\n".join(lines)


@pytest.mark.parametrize("case", ["clean", "spill", "missing"])
def test_sparse_nvcc_check_reads_densify_and_every_sddmm_route(case):
    # chip_smoke's reading of the build reports: one row per kernel,
    # each SDDMM instantiation named by its route and types; a spill or
    # a missing instantiation fails the run.
    cs = _root_script("chip_smoke")
    sddmm = _sparse_report(spill=8 if case == "spill" else 0,
                           drop_last=case == "missing")
    gemm = sddmm.split("\nptxas info    : Compiling entry function "
                       "'_ZN12_GLOBAL__N_116sddmm")[0]
    if case != "clean":
        with pytest.raises(SystemExit):
            cs.sparse_nvcc_check(gemm, sddmm)
        return
    rows = cs.sparse_nvcc_check(gemm, sddmm)
    assert rows["ell_densify_kernel"] == {"registers": 40,
                                          "spill_stores": 0,
                                          "spill_loads": 0}
    keys = {k for k in rows if k.startswith("sddmm")}
    assert keys == {f"sddmm_f32_kernel<{r}, {h}, {o}>"
                    for r in ("scalar", "vector") for h in ("fp32", "bf16")
                    for o in ("fp32", "bf16")}
    assert rows["sddmm_f32_kernel<vector, bf16, bf16>"]["registers"] == 48
    assert cs.sparse_nvcc_check("cached", "cached") == {}


def test_densify_bound_counts_only_the_columns_it_reads():
    # Densify's bound: every value read, a column only under a non-zero
    # value (a zero of either sign adds nothing to 0.0f), the block
    # written once, an add a live slot.
    cs = _root_script("chip_smoke")
    vals = torch.zeros(6, 5)
    vals[0, :3] = torch.tensor([1.0, -2.0, 3.0])
    vals[4, 4] = 0.5
    vals[5, 0] = -0.0
    ms, by, live = cs.densify_bound(torch, vals, 45)
    assert live == 4 and by == "bytes"
    assert (ms, by) == cs.bound_ms(4 * 6 * 5 + 4 * 4 + 4 * 6 * 45, 4.0)
