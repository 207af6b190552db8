"""The port on a CUDA device: hand kernels against their plain versions,
the Engine against the float64 reference, a batched lane against the
same request run alone, the LM prefill through the flash kernel
(windowed for gemma3, and its recomputed gradient; non-causal at ragged Tk
for cross-attention and whisper's encoder, with grouped KV heads) against
the same model or function with plain attention, live-graph versions
against a cold compile (with the bytes a delta uploads and a reclaim
frees), and the mesh path on virtual shards of the card against the
device path.

Replays: a device pass replayed as a CUDA graph against the eager route
(``Engine(replay=False)``) bit for bit, for b2 and gat-dot on Cora and
for sampled lanes of differing live counts (a batch of 3 in a bucket of
4), with the eager pass's stats; a released staging or a reclaimed live
version drops its captures and a re-staged replay equals eager; two
engines of an ``OverlayPool`` replaying one program in two threads at
once; the captured serve step against the eager one over gemma3's ring
wrap, over cross caches filled in place before and after the capture,
and over hymba's and xLSTM's recurrent state caches (with those smoke
models on the card against the CPU, and flash at hymba's G = 5), and over
kimi-k2's and deepseek-v3's MoE and latent caches (those smoke models with
moe_impl="a2a" on virtual entries of the card against CPU entries, flash
at kimi's G = 8, d = 112 and MLA's d = 192 with V padded).  bf16 GEMM and
SpDMM operands against the plain versions and bit for bit against the
fp32 kernels on the widened operands.

Every test here is marked ``gpu`` and skips without a card.  This file
imports neither ``jax`` nor ``repro``, so it also runs where JAX is not
installed; there the repository's ``conftest.py`` (which imports JAX) is
left out:

    python -m pytest -q --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_models import build_gat_dot  # noqa: E402
from repro_torch.core import gnn_builders as TB  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import reference as TR  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import Engine, InferenceRequest  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.steps import build_model  # noqa: E402
from repro_torch.models.steps import make_prefill_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

pytestmark = pytest.mark.gpu

GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (64, 32, 16),
               (100, 60, 33), (8, 8, 8), (1, 128, 1), (130, 70, 258),
               (4096, 128, 128)]
SPDMM_SHAPES = [(128, 16, 128, 128), (64, 8, 128, 32), (100, 24, 70, 33),
                (32, 64, 32, 8), (8, 8, 8, 8), (4096, 512, 4096, 128)]
SDDMM_SHAPES = [(128, 16, 128, 128), (64, 8, 96, 256), (56, 24, 70, 33),
                (8, 8, 8, 8)]
# tests/test_kernels.py's flash sweep (fp32, atol 2e-5) and bf16 case
# (rtol / atol 3e-2), plus ragged shapes: (tq, tk, heads, d, causal, dtype)
FLASH_CASES = [(128, 128, 2, 64, True, "float32"),
               (256, 256, 4, 32, True, "float32"),
               (128, 256, 1, 64, False, "float32"),
               (256, 128, 2, 128, True, "float32"),
               (128, 128, 2, 64, True, "bfloat16"),
               (200, 200, 3, 128, True, "float32"),
               (200, 200, 3, 128, True, "bfloat16"),
               (77, 130, 2, 40, False, "bfloat16"),
               (1, 1, 1, 16, True, "float32"),
               (2048, 2048, 64, 128, True, "bfloat16")]   # the path shape


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


# (m, k, n, r0, r1): the path shape and ragged ones, rows [r0, r1) off
# every tile boundary.
GEMM_BITS_CASES = [(4096, 128, 128, 37, 1001), (130, 70, 258, 3, 129),
                   (100, 60, 33, 1, 99), (64, 32, 16, 5, 6),
                   (4096, 128, 8, 63, 65)]


def _unaligned_copy(t):
    # The same values in a view whose rows start 4 bytes past a 16-byte
    # boundary (row stride not a multiple of 4 floats either).
    buf = torch.empty(t.shape[0], t.shape[1] + 1, device=t.device)
    view = buf[:, 1:]
    view.copy_(t)
    return view


@pytest.mark.parametrize("m,k,n,r0,r1", GEMM_BITS_CASES)
def test_cuda_gemm_bits_do_not_depend_on_geometry(cuda, m, k, n, r0, r1):
    # Each output element is one fmaf chain over k with acc added last, so
    # a row slice, unaligned operands (4-byte staging), acc aliasing C and
    # a second run all give the same bits as the aligned whole call.
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(k, n, generator=g, device=cuda)
    acc = torch.randn(m, n, generator=g, device=cuda)
    full = ops.gemm(x, w, acc)
    _close(full, acc + ref.gemm_ref(x, w))
    assert torch.equal(full[r0:r1], ops.gemm(x[r0:r1], w, acc[r0:r1]))
    assert torch.equal(ops.gemm(_unaligned_copy(x), _unaligned_copy(w),
                                _unaligned_copy(acc)), full)
    assert torch.equal(ops.gemm(x, w, acc), full)
    inout = acc.clone()
    rc = ops.entry("gemm")(
        x.data_ptr(), w.data_ptr(), inout.data_ptr(), inout.data_ptr(),
        m, n, k, ops._ld(x), ops._ld(w), ops._ld(inout), ops._ld(inout),
        ops._stream(x))
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(inout, full)


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


def _ell_with_row_len(n1, w, ns, seed):
    """ELL cols / vals with rows of live length 0, 1, w - 1, w and random,
    pads between live slots (vals 0) and after the last, and row_len =
    1 + each row's last live slot."""
    r = np.random.default_rng(seed)
    lens = r.integers(0, w + 1, n1)
    lens[:4] = [0, 1, w - 1, w]
    live = (np.arange(w)[None, :] < lens[:, None]) & (r.random((n1, w)) > 0.3)
    live[np.arange(n1), np.maximum(lens - 1, 0)] |= lens > 0
    cols = np.where(live, r.integers(0, ns, (n1, w)), 0).astype(np.int32)
    vals = np.where(live, r.normal(0, 1, (n1, w)), 0).astype(np.float32)
    row_len = np.where(live.any(1), w - np.argmax(live[:, ::-1], 1), 0)
    return (torch.from_numpy(cols), torch.from_numpy(vals),
            torch.from_numpy(row_len.astype(np.int32)))


@pytest.mark.parametrize("n1,w,ns,f", [(64, 16, 50, 8), (100, 96, 70, 128),
                                       (128, 33, 100, 200),
                                       (4096, 512, 4096, 128)])
def test_cuda_spdmm_row_len_matches_plain(cuda, n1, w, ns, f):
    # The walk stops at row_len: the result is within the kernel
    # tolerance of the plain version and has the same bits as the walk
    # over all w slots; strided h, acc aliasing out.
    cols, vals, row_len = (t.to(cuda) for t in _ell_with_row_len(
        n1, w, ns, seed=n1 + w + f))
    assert row_len[:4].tolist() == [0, 1, w - 1, w]
    g = torch.Generator(device=cuda).manual_seed(6)
    h = torch.randn(ns, 2 * f + 4, generator=g, device=cuda)[:, 4:4 + f]
    acc = torch.randn(n1, f, generator=g, device=cuda)
    ops.reset_launches()
    got = ops.spdmm(cols, vals, h, acc, row_len)
    assert ops.LAUNCHES["spdmm"] == 1
    _close(got, acc + ref.spdmm_ref(cols, vals, h))
    _close(got, acc + ref.spdmm_ref(cols, vals, h, row_len=row_len))
    assert torch.equal(got, ops.spdmm(cols, vals, h, acc))
    # acc aliasing out (the C entry point takes one pointer for both).
    inout = acc.clone()
    rc = ops.entry("spdmm")(
        cols.data_ptr(), vals.data_ptr(), h.data_ptr(), inout.data_ptr(),
        inout.data_ptr(), row_len.data_ptr(), n1, w, f, ops._ld(h),
        ops._ld(inout), ops._ld(inout), ops._stream(h))
    torch.cuda.synchronize()
    assert rc == 0 and torch.equal(inout, got)


def test_cuda_spdmm_rejects_a_bad_row_len(cuda):
    cols = torch.zeros(8, 4, dtype=torch.int32, device=cuda)
    vals, h = torch.zeros(8, 4, device=cuda), torch.zeros(8, 8, device=cuda)
    for bad in (torch.zeros(8, device=cuda),                      # dtype
                torch.zeros(7, dtype=torch.int32, device=cuda)):  # shape
        with pytest.raises(ValueError, match="row_len"):
            ops.spdmm(cols, vals, h, row_len=bad)


@pytest.mark.parametrize("n1,w,ns,f", SDDMM_SHAPES)
def test_cuda_sddmm_matches_plain(cuda, n1, w, ns, f):
    # The Pallas kernel's own function (no mask, no acc; pad slots score
    # row 0), strided operands, at the JAX sweep's rtol 1e-4 / atol 1e-4.
    r = np.random.default_rng(5)
    cols = torch.from_numpy(r.integers(0, ns, (n1, w)).astype(np.int32))
    hd = torch.from_numpy(r.normal(0, 1, (n1, 2 * f)).astype(np.float32))
    hs = torch.from_numpy(r.normal(0, 1, (ns, 2 * f)).astype(np.float32))
    c, d, s = cols.to(cuda), hd.to(cuda)[:, f:], hs.to(cuda)[:, :f]
    ops.reset_launches()
    got = ops.sddmm(d, s, c)
    assert ops.LAUNCHES["sddmm"] == 1
    _close(got, ref.sddmm_ref(d, s, c), rtol=1e-4, atol=1e-4)


def test_cuda_sddmm_masked_path_tile(cuda):
    # The executor's tile shape: n1=4096, w=512, f=128 views of a padded
    # layer tensor, a real mask (12% live slots) and an accumulator;
    # masked slots keep acc exactly.
    n1, w, f = 4096, 512, 128
    g = torch.Generator(device=cuda).manual_seed(1)
    h = torch.randn(2 * n1, f, generator=g, device=cuda)
    hd, hs = h[:n1], h[n1:]
    mask = torch.rand(n1, w, generator=g, device=cuda) < 0.12
    cols = torch.where(mask, torch.randint(0, n1, (n1, w), generator=g,
                                           device=cuda), 0).to(torch.int32)
    acc = torch.randn(n1, w, generator=g, device=cuda)
    got = ops.sddmm(hd, hs, cols, mask, acc)
    _close(got, ref.sddmm_step_ref(hd, hs, cols, mask, acc))
    assert torch.equal(got[~mask], acc[~mask])
    assert torch.equal(ops.sddmm(hd, hs, cols, mask, acc), got)


# (n1, w, n_src, f, kind): hub rows (every slot live) among rows of 25
# live slots, w not a multiple of 32, f = 256 unmasked, f not a multiple
# of 4 (the scalar path).
SDDMM_STEP_CASES = [(512, 512, 600, 128, "hub"), (64, 200, 90, 128, "random"),
                    (40, 77, 60, 256, "unmasked"), (33, 45, 50, 33, "random")]


@pytest.mark.parametrize("n1,w,ns,f,kind", SDDMM_STEP_CASES)
def test_cuda_sddmm_step_matches_plain(cuda, n1, w, ns, f, kind):
    # Against ref.sddmm_step_ref; masked slots keep acc, a second run and
    # the scalar path (unaligned copies of h_dst / h_src) give the same
    # bits.
    g = torch.Generator(device=cuda).manual_seed(n1 + w + f)
    if kind == "hub":
        lens = torch.full((n1,), 25, device=cuda)
        lens[torch.randperm(n1, generator=g, device=cuda)[:32]] = w
        mask = torch.arange(w, device=cuda)[None] < lens[:, None]
    elif kind == "random":
        mask = torch.rand(n1, w, generator=g, device=cuda) < 0.4
    else:
        mask = None
    cols = torch.randint(0, ns, (n1, w), generator=g, device=cuda,
                         dtype=torch.int32)
    if mask is not None:
        cols = torch.where(mask, cols, 0).to(torch.int32)
    hd = torch.randn(n1, 2 * f, generator=g, device=cuda)[:, f:]
    hs = torch.randn(ns, f, generator=g, device=cuda)
    acc = torch.randn(n1, w, generator=g, device=cuda)
    ops.reset_launches()
    got = ops.sddmm(hd, hs, cols, mask, acc)
    assert ops.LAUNCHES["sddmm"] == 1
    _close(got, ref.sddmm_step_ref(hd, hs, cols, mask, acc))
    if mask is not None:
        assert torch.equal(got[~mask], acc[~mask])
    assert torch.equal(ops.sddmm(hd, hs, cols, mask, acc), got)
    assert torch.equal(ops.sddmm(_unaligned_copy(hd), _unaligned_copy(hs),
                                 cols, mask, acc), got)


def test_cuda_run_batch_lane_equals_solo(cuda):
    g = TG.random_graph(120, 700, seed=3, degree="powerlaw").gcn_normalized()
    g.feat_dim, g.n_classes = 12, 4
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    prog = eng.compile(build_gat_dot(TB, g, hidden=16), g)
    xs = [TG.random_features(g, seed=s) for s in range(3)]
    ops.reset_launches()
    ys = eng.run_batch(prog, np.stack(xs))
    modes = eng.exec_stats.tile_ops_by_mode
    assert eng.exec_stats.runs == 1
    assert ops.LAUNCHES["sddmm"] == 3 * modes["sddmm"] > 0
    assert ops.LAUNCHES["spdmm"] == 3 * modes["spdmm"] > 0
    assert ops.LAUNCHES["gemm"] == 3 * modes["gemm"] > 0
    for n, x in enumerate(xs):
        assert torch.equal(ys[n], eng.run(prog, x))
    want = TR.run_reference(build_gat_dot(TB, g, hidden=16), g,
                            torch.as_tensor(xs[0], device=cuda),
                            dtype=torch.float64)
    _close(ys[0], want, rtol=2e-4, atol=2e-5)


def test_cuda_engine_waits_for_the_callers_stream(cuda):
    # CUDA features that the caller's stream is still writing (behind a
    # ~0.1 s spin) when run / submit_batch is called: the engine's stream
    # must wait for them, and the outputs equal the numpy-fed run's.
    g = TG.random_graph(120, 700, seed=3, degree="powerlaw").gcn_normalized()
    g.feat_dim, g.n_classes = 12, 4
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    model = build_gat_dot(TB, g, hidden=16)
    prog = eng.compile(model, g)
    x = TG.random_features(g, seed=7)
    want = eng.run(prog, x)
    src = torch.as_tensor(x, device=cuda)
    torch.cuda.synchronize()

    def written_late():
        xd = torch.zeros_like(src)
        torch.cuda._sleep(200_000_000)
        xd.copy_(src)
        return xd

    assert torch.equal(eng.run(prog, written_late()), want)
    reqs = [InferenceRequest(model=model, graph=g, features=written_late(),
                             request_id=f"r{i}") for i in range(2)]
    for r in eng.submit_batch(reqs):
        assert r.batch_size == 2 and torch.equal(r.output, want)


def test_cuda_sddmm_out_of_range_column_scores_nan(cuda):
    # A live slot with a column outside h_src reads nothing and scores
    # NaN; the other slots are unaffected.
    hd = torch.randn(8, 16, device=cuda)
    hs = torch.randn(5, 16, device=cuda)
    cols = torch.randint(0, 5, (8, 4), device=cuda, dtype=torch.int32)
    cols[2, 1], cols[6, 3] = 5, -1
    got = ops.sddmm(hd, hs, cols)
    torch.cuda.synchronize()
    bad = torch.zeros(8, 4, dtype=torch.bool, device=cuda)
    bad[2, 1] = bad[6, 3] = True
    assert bool(torch.isnan(got[bad]).all())
    _close(got[~bad], ref.sddmm_ref(hd, hs, cols.clamp(0, 4))[~bad])
    mask = ~bad                         # masked out: no gather, acc kept
    assert torch.equal(ops.sddmm(hd, hs, cols, mask)[bad],
                       torch.zeros(2, device=cuda))
    # With a mask and an accumulator (w = 40, not a multiple of 32): live
    # out-of-range slots NaN, the rest the plain step's values, masked
    # slots exactly acc (a masked out-of-range column reads nothing).
    n1, w, ns, f = 64, 40, 50, 128
    g = torch.Generator(device=cuda).manual_seed(8)
    cols = torch.randint(0, ns, (n1, w), generator=g, device=cuda,
                         dtype=torch.int32)
    mask = torch.rand(n1, w, generator=g, device=cuda) < 0.5
    cols[3, 39], cols[10, 0], cols[20, 17] = ns, -1, 1 << 30
    mask[3, 39] = mask[10, 0] = True
    mask[20, 17] = False
    hd, hs = (torch.randn(n, f, generator=g, device=cuda) for n in (n1, ns))
    acc = torch.randn(n1, w, generator=g, device=cuda)
    got = ops.sddmm(hd, hs, cols, mask, acc)
    torch.cuda.synchronize()
    bad = mask & ((cols < 0) | (cols >= ns))
    assert int(bad.sum()) == 2 and bool(torch.isnan(got[bad]).all())
    want = ref.sddmm_step_ref(hd, hs, cols.clamp(0, ns - 1), mask, acc)
    _close(got[~bad], want[~bad])
    assert torch.equal(got[~mask], acc[~mask])


def test_cuda_wrappers_reject_bad_operands(cuda):
    x = torch.zeros(8, 8, device=cuda)
    with pytest.raises(TypeError):
        ops.gemm(x.double(), x.double())
    with pytest.raises(ValueError):
        ops.gemm(x, torch.zeros(8, 8))              # mixed devices
    with pytest.raises(ValueError, match="contiguous"):
        ops.spdmm(torch.zeros(8, 16, dtype=torch.int32, device=cuda)[:, ::2],
                  torch.zeros(8, 8, device=cuda), x)
    cols = torch.zeros(8, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ops.sddmm(x, x, cols, torch.ones(8, 4, device=cuda))  # mask dtype
    with pytest.raises(ValueError, match="shape"):
        ops.sddmm(x, x, cols, acc=torch.zeros(8, 5, device=cuda))


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


@pytest.mark.parametrize("tq,tk,h,d,causal,dtype", FLASH_CASES)
def test_cuda_flash_matches_plain(cuda, tq, tk, h, d, causal, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(h, t, d, generator=g, device=cuda).to(dt)
               for t in (tq, tk, tk))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.dtype == dt
    tol = (0.0, 2e-5) if dt == torch.float32 else (3e-2, 3e-2)
    want = ref.flash_attention_plain(q, k, v, causal)
    _close(got, want, *tol)
    if dt == torch.bfloat16:
        # Limits scaled to bf16 rounding (u = 2^-8), as chip_smoke.py's
        # check_rows: relative L2 <= u whole and <= 2u in every query row.
        err = (got.float() - want.float())
        assert float(err.norm() / want.float().norm()) <= 2.0 ** -8
        rows = err.norm(dim=-1) / want.float().norm(dim=-1)
        assert float(rows.max()) <= 2.0 ** -7
    assert torch.equal(ops.flash_attention(q, k, v, causal), got)


# Grouped KV heads (G query heads per KV head), the bf16 body under the
# row limits and the fp32 body at 2e-5: (tq, tk, heads, G, d, causal,
# dtype); the last is qwen3-0.6b's prefill at B=4 (16 query / 8 KV heads).
FLASH_GQA_CASES = [(128, 128, 2, 2, 64, True, "bfloat16"),
                   (200, 200, 8, 8, 128, True, "bfloat16"),
                   (77, 130, 4, 2, 40, False, "bfloat16"),
                   (256, 128, 4, 2, 128, True, "float32"),
                   (200, 200, 8, 8, 128, True, "float32"),
                   (2048, 2048, 64, 2, 128, True, "bfloat16")]


@pytest.mark.parametrize("tq,tk,h,grp,d,causal,dtype", FLASH_GQA_CASES)
def test_cuda_flash_grouped_heads_match_plain(cuda, tq, tk, h, grp, d,
                                              causal, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(h, tq, d, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(h // grp, tk, d, generator=g, device=cuda).to(dt)
            for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.shape == q.shape
    want = ref.flash_attention_plain(q, k, v, causal)
    # the same function as one KV head per query head
    rep = [x.repeat_interleave(grp, dim=0) for x in (k, v)]
    assert torch.equal(ops.flash_attention(q, *rep, causal), got)
    if dt == torch.float32:
        _close(got, want, 0.0, 2e-5)
    else:
        err = (got.float() - want.float())
        assert float(err.norm() / want.float().norm()) <= 2.0 ** -8
        rows = err.norm(dim=-1) / want.float().norm(dim=-1)
        assert float(rows.max()) <= 2.0 ** -7


def test_cuda_flash_rejects_bad_operands(cuda):
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q)
    big = torch.zeros(2, 8, 264, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, False, window=4)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q[:, :4], q[:, :4], True, window=4)
    with pytest.raises(ValueError, match="k / v"):
        ops.flash_attention(q, q[:1, :, :32], q[:1, :, :32])
    three = torch.zeros(3, 8, 64, device=cuda)       # G would be 2 / 3
    with pytest.raises(ValueError, match="G dividing"):
        ops.flash_attention(q, three, three)
    nc = torch.zeros(2, 64, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(nc, q, q)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, torch.zeros(2, 8, 64))  # mixed devices
    with pytest.raises(ValueError, match="\\[BH, T, d\\]"):
        ops.flash_attention(q[0], q[0], q[0])


# Sliding windows and gemma3's head dims (240: gemma3-12b, 168: gemma3-27b;
# 256 the widest): (T, heads, G, d, window, dtype); window 0 is none, 100
# ends inside a KV tile, 1024 >= T is no window.
FLASH_WINDOW_CASES = [(300, 4, 2, 240, 1, "bfloat16"),
                      (300, 4, 2, 240, 5, "bfloat16"),
                      (300, 4, 1, 168, 64, "bfloat16"),
                      (250, 2, 2, 128, 100, "bfloat16"),
                      (200, 2, 1, 256, 0, "bfloat16"),
                      (1000, 2, 2, 64, 1024, "bfloat16"),
                      (2048, 8, 2, 240, 1024, "bfloat16"),
                      (200, 2, 1, 256, 0, "float32"),
                      (130, 4, 2, 240, 64, "float32"),
                      (77, 2, 1, 168, 5, "float32"),
                      (250, 2, 2, 128, 100, "float32")]
# hymba-1.5b's attention: 25 query heads over 5 KV heads (G = 5) of 64
# under a window of 2,048; its prefill shape at B=4 and its train shape at
# B=2 (the window masks from T = 2,049 on), then ragged T with windows
# that end inside a KV tile, in bf16 and fp32.
FLASH_WINDOW_CASES += [(2048, 100, 5, 64, 2048, "bfloat16"),
                       (4096, 50, 5, 64, 2048, "bfloat16"),
                       (300, 10, 5, 64, 0, "bfloat16"),
                       (300, 10, 5, 64, 100, "bfloat16"),
                       (1100, 25, 5, 64, 1000, "bfloat16"),
                       (77, 5, 5, 64, 5, "bfloat16"),
                       (300, 10, 5, 64, 0, "float32"),
                       (1100, 25, 5, 64, 1000, "float32"),
                       (77, 5, 5, 64, 5, "float32")]


@pytest.mark.parametrize("t,h,grp,d,window,dtype", FLASH_WINDOW_CASES)
def test_cuda_flash_window_and_wide_heads_match_plain(cuda, t, h, grp, d,
                                                       window, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(t + d + window)
    q = torch.randn(h, t, d, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(h // grp, t, d, generator=g, device=cuda).to(dt)
            for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, True, window)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.shape == q.shape
    want = ref.flash_attention_plain(q, k, v, True, window)
    if dt == torch.float32:
        _close(got, want, 0.0, 2e-5)
    else:
        err = (got.float() - want.float())
        assert float(err.norm() / want.float().norm()) <= 2.0 ** -8
        rows = err.norm(dim=-1) / want.float().norm(dim=-1)
        assert float(rows.max()) <= 2.0 ** -7
    assert torch.equal(ops.flash_attention(q, k, v, True, window), got)


@pytest.mark.parametrize("dtype,limit", [("bfloat16", 2e-2),
                                         ("float32", 1e-4)])
@pytest.mark.parametrize("d,window", [(240, 64), (128, 0)])
def test_cuda_flash_gradient_matches_plain_route(cuda, dtype, limit, d,
                                                 window):
    # _FlashAttention (the kernel forward, the chunked plain recompute
    # backward) against autograd through the plain function alone.
    from repro_torch.models import attention as TA
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(d + window)
    b, t, h, kh = 2, 1100, 4, 2
    q = torch.randn(b, t, h, d, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(b, t, kh, d, generator=g, device=cuda).to(dt)
            for _ in range(2))
    w = torch.randn(b, t, h, d, generator=g, device=cuda)

    def grads(fn):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*xs).float() * w).sum().backward()
        return [x.grad.float() for x in xs]

    def plain(q, k, v):
        def heads(x):
            return x.transpose(1, 2).reshape(-1, t, d)
        o = ref.flash_attention_plain(heads(q), heads(k), heads(v), True,
                                      window)
        return o.reshape(b, h, t, d).transpose(1, 2)
    ops.reset_launches()
    got = grads(lambda q, k, v: TA._flash(q, k, v, window))
    assert ops.LAUNCHES["flash_attention"] == 1
    for a, e in zip(got, grads(plain)):
        assert bool(torch.isfinite(a).all())
        assert float((a - e).norm() / e.norm()) <= limit


@pytest.mark.parametrize("dtype,limit", [("bfloat16", 2e-2),
                                         ("float32", 1e-5)])
def test_cuda_gemma3_prefill_matches_plain_attention(cuda, dtype, limit,
                                                     monkeypatch):
    # gemma3-12b at full width, one superblock (5 windowed layers and a
    # global one, d = 240), a prompt of 1100 tokens past the window.
    import dataclasses
    cfg = dataclasses.replace(get_config("gemma3-12b"), n_layers=6,
                              dtype=dtype)
    model = build_model(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 1100)).astype(np.int32)).to(cuda)
    prefill = make_prefill_step(model, cfg)
    ops.reset_launches()
    got = prefill(model, {"tokens": toks}).float()
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    monkeypatch.setattr(ops, "flash_attention", ref.flash_attention_plain)
    want = prefill(model, {"tokens": toks}).float()
    assert got.shape == (1, cfg.vocab) and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) <= limit


@pytest.mark.parametrize("dtype,limit", [("bfloat16", 2e-2),
                                         ("float32", 1e-5)])
def test_cuda_two_layer_prefill_matches_plain_attention(cuda, dtype, limit,
                                                        monkeypatch):
    # qwen3-0.6b at full width, 2 layers, a ragged prompt (300 tokens):
    # one flash launch per layer, logits as with the plain version.
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              dtype=dtype)
    model = build_model(cfg, seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 300)).astype(np.int32)).to(cuda)
    prefill = make_prefill_step(model, cfg)
    ops.reset_launches()
    got = prefill(model, {"tokens": toks}).float()
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    monkeypatch.setattr(ops, "flash_attention", ref.flash_attention_plain)
    want = prefill(model, {"tokens": toks}).float()
    assert got.shape == (2, cfg.vocab) and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) <= limit


# The non-causal mode at ragged Tk, as cross-attention and whisper's
# encoder call it: (tq, tk, heads, G, d, dtype).  The first three are the
# path shapes: llama-3.2-vision's cross layers at B=4 (128 query heads over
# 32 KV heads, 1,601 vision tokens), whisper-base's encoder at B=4 (1,500
# frames) and its cross layers over 448 targets; then the sweep's odd
# sizes (Tk below, inside and past one KV tile, one query, d up to 256).
FLASH_NONCAUSAL_CASES = [(2048, 1601, 128, 4, 128, "bfloat16"),
                         (1500, 1500, 32, 1, 64, "bfloat16"),
                         (448, 1500, 32, 1, 64, "bfloat16"),
                         (2048, 1601, 16, 4, 128, "float32"),
                         (1500, 1500, 8, 1, 64, "float32"),
                         (77, 130, 4, 2, 40, "bfloat16"),
                         (300, 65, 8, 4, 128, "bfloat16"),
                         (129, 257, 4, 1, 256, "bfloat16"),
                         (1, 1601, 8, 4, 128, "bfloat16"),
                         (100, 1000, 4, 2, 240, "bfloat16"),
                         (300, 65, 8, 4, 128, "float32"),
                         (129, 257, 4, 1, 256, "float32")]


@pytest.mark.parametrize("tq,tk,h,grp,d,dtype", FLASH_NONCAUSAL_CASES)
def test_cuda_flash_noncausal_ragged_tk_matches_plain(cuda, tq, tk, h, grp,
                                                      d, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(tq + tk + d)
    q = torch.randn(h, tq, d, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(h // grp, tk, d, generator=g, device=cuda).to(dt)
            for _ in range(2))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, False)
    assert ops.LAUNCHES["flash_attention"] == 1 and got.shape == q.shape
    want = ref.flash_attention_plain(q, k, v, False)
    if dt == torch.float32:
        _close(got, want, 0.0, 2e-5)
    else:
        err = (got.float() - want.float())
        assert float(err.norm() / want.float().norm()) <= 2.0 ** -8
        rows = err.norm(dim=-1) / want.float().norm(dim=-1)
        assert float(rows.max()) <= 2.0 ** -7
    assert torch.equal(ops.flash_attention(q, k, v, False), got)


@pytest.mark.parametrize("dtype,limit", [("bfloat16", 2e-2),
                                         ("float32", 1e-4)])
def test_cuda_cross_attention_route_g4_matches_plain(cuda, dtype, limit,
                                                     monkeypatch):
    # attention(kv_x=) at llama-3.2-vision's head layout (32 query heads
    # over 8 KV heads of 128, G = 4), T = 300 over 1,601 sources: one
    # non-causal launch; output and the gradients in x, kv_x and the
    # weights (the chunked plain recompute) against the plain route.
    from repro_torch.models import attention as TA
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(11)
    d, h, kh, hd, t, s = 4096, 32, 8, 128, 300, 1601
    p = TA.attn_init(g, d, h, kh, hd, dt, kv_input_dim=d, device=cuda)
    x = torch.randn(2, t, d, generator=g, device=cuda).to(dt)
    src = (0.1 * torch.randn(2, s, d, generator=g, device=cuda)).to(dt)
    w = torch.randn(2, t, d, generator=g, device=cuda)

    def run():
        ps = {n: a.clone().requires_grad_() for n, a in p.items()}
        xs = [a.clone().requires_grad_() for a in (x, src)]
        o = TA.attention(ps, xs[0], kv_x=xs[1], causal=False, use_rope=False)
        (o.float() * w).sum().backward()
        return [o.detach().float()] + [a.grad.float() for a in xs] + [
            ps[n].grad.float() for n in sorted(ps)]
    ops.reset_launches()
    got = run()
    assert ops.LAUNCHES["flash_attention"] == 1
    monkeypatch.setattr(ops, "flash_attention", ref.flash_attention_plain)
    for a, e in zip(got, run()):
        assert bool(torch.isfinite(a).all())
        assert float((a - e).norm() / e.norm()) <= limit


def test_cuda_vision_superblock_prefill_matches_plain_attention(
        cuda, monkeypatch):
    # llama-3.2-vision at full width, one superblock (4 self layers and a
    # cross layer), bf16, T = 300 over 1,601 vision tokens: 6 launches.
    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b"),
                              n_layers=5)
    model = build_model(cfg, seed=0)
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (2, 300)
                                                   ).astype(np.int32)),
             "vision": torch.from_numpy(r.normal(0, 0.1, (
                 2, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
                 ).to(torch.bfloat16)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    prefill = make_prefill_step(model, cfg)
    ops.reset_launches()
    got = prefill(model, batch).float()
    assert ops.LAUNCHES["flash_attention"] == 6
    monkeypatch.setattr(ops, "flash_attention", ref.flash_attention_plain)
    want = prefill(model, batch).float()
    assert got.shape == (2, cfg.vocab) and bool(torch.isfinite(got).all())
    assert float((got - want).norm() / want.norm()) <= 2e-2


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-base"])
def test_cuda_captured_decode_reads_filled_cross_caches(cuda, arch):
    # launch.serve.Step captured over cross caches filled in place
    # (fill_cross_caches), token for token the eager step; refilled after
    # the capture with another source, the replays read the new values.
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Step
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, seed=3)
    b, plen, gen, s = 3, 5, 8, 24
    r = np.random.default_rng(1)
    prompts = torch.as_tensor(r.integers(0, cfg.vocab, (b, plen)).astype(
        np.int32), device=cuda)
    srcs = [torch.as_tensor(r.normal(0, 1.0, (b, s, cfg.d_model)).astype(
        np.float32), device=cuda) for _ in range(2)]

    def decode(step, cache, src):
        model.fill_cross_caches(cache, src)
        tok, out = None, []
        for p in range(plen):
            tok = step(prompts[:, p:p + 1], p)
        out.append(tok)
        for i in range(gen - 1):
            tok = step(tok, plen + i)
            out.append(tok)
        return torch.cat(out, dim=1)
    caches = {m: model.init_cache(b, plen + gen, cross_len=s)
              for m in ("eager", "captured")}
    steps = {m: Step(model, cfg, model, caches[m], b,
                     capture=m == "captured") for m in caches}
    for src in srcs:
        want = decode(steps["eager"], caches["eager"], src)
        got = decode(steps["captured"], caches["captured"], src)
        assert steps["captured"].graph is not None
        assert torch.equal(got, want)
    first = decode(steps["eager"], caches["eager"], srcs[0])
    assert not torch.equal(first, want)         # the source matters


# --------------------------------------------------------------------------- #
# Host-streaming residency and remapped binaries.
# --------------------------------------------------------------------------- #
def _powerlaw(nv=120, ne=700, seed=3):
    g = TG.random_graph(nv, ne, seed=seed, degree="powerlaw").gcn_normalized()
    g.feat_dim, g.n_classes = 12, 4
    return g


@pytest.mark.parametrize("which", ["b1", "gat-dot"])
def test_cuda_host_path_equals_device(cuda, which):
    from repro_torch.engine.executor import _host_tiles
    g = _powerlaw()
    model = "b1" if which == "b1" else build_gat_dot(TB, g, hidden=16)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    prog = eng.compile(model, g)
    xs = np.stack([TG.random_features(g, seed=s) for s in range(2)])
    want = eng.run_batch(prog, xs)
    ops.reset_launches()
    got = eng.run_batch(prog, xs, residency="host")
    st = eng.exec_stats
    assert torch.equal(got, want)
    assert st.shards_streamed > 1 and st.h2d_bytes > 0
    modes = st.tile_ops_by_mode
    assert ops.LAUNCHES["gemm"] == 2 * modes["gemm"] > 0
    assert ops.LAUNCHES["spdmm"] == 2 * modes["spdmm"] > 0
    assert ops.LAUNCHES["sddmm"] == 2 * modes.get("sddmm", 0)
    assert _host_tiles(prog.pgraph, True).row("cols", 0)[0].is_pinned()
    ref_model = "b1" if which == "b1" else build_gat_dot(TB, g, hidden=16)
    _close(got[1], TR.run_reference(
        TB.build(ref_model, g) if isinstance(ref_model, str) else ref_model,
        g, torch.as_tensor(xs[1], device=cuda), dtype=torch.float64),
        rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("which", ["b1", "gat-dot"])
def test_cuda_mesh_virtual_shards_equal_device(cuda, which, d):
    """D virtual shards of one card (``DeviceMesh([cuda:0] * D)``): the
    device path's bits, every tile op on the hand kernels (launches equal
    to the pass's tile ops of each mode), the per-device ops summing to
    the device path's, and a batch of lanes equal to solo runs."""
    from repro_torch.engine.executor import _staged
    from repro_torch.launch.mesh import DeviceMesh
    g = _powerlaw(seed=6)
    model = "b1" if which == "b1" else build_gat_dot(TB, g, hidden=16)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    prog = eng.compile(model, g, mesh=d)
    x = TG.random_features(g, seed=3)
    want = eng.run(prog, x)
    # The shards of cuda:0 share the tile copies the engine's "cuda"
    # staging made: each uploads its inverse in-degree only.
    inv = _staged(prog.pgraph, eng.device).inv_deg.numel() * 4
    dev_ops = eng.exec_stats.tile_ops
    mesh = DeviceMesh([torch.device("cuda", 0)] * d)
    ops.reset_launches()
    got = eng.run(prog, x, mesh=mesh)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    st = eng.exec_stats
    assert got.device == torch.device("cuda", 0)
    assert torch.equal(got, want)
    pl = prog.manifest["placement"]["assignment"]
    for k in range(d):
        own = tuple(j for j, a in enumerate(pl) if a == k)
        assert _staged(prog.pgraph, mesh.devices[k], own).uploaded == inv
    modes = st.tile_ops_by_mode
    assert launches["gemm"] == modes["gemm"] > 0
    assert launches["spdmm"] == modes["spdmm"] > 0
    assert launches["sddmm"] == modes.get("sddmm", 0)
    assert sum(r["tile_ops"] for r in st.per_device) == dev_ops
    assert st.halo_bytes == prog.manifest["placement"]["halo_bytes_total"]
    assert st.halo_gather_bytes > 0
    xs = np.stack([x, 0.5 * x])
    ys = eng.run_batch(prog, xs, mesh=mesh)
    assert torch.equal(ys[0], want)
    assert torch.equal(ys[1], eng.run(prog, xs[1]))


def test_cuda_forced_gemm_equal_across_residencies(cuda):
    g = _powerlaw(seed=4)
    x = TG.random_features(g, seed=2)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    prog = eng.compile("b1", g)
    rp = eng.remap(prog, force="gemm")
    ops.reset_launches()
    y = eng.run(rp, x)
    st = eng.exec_stats
    assert st.tiles_remapped == rp.manifest["remap"]["remapped_ops"] > 0
    assert ops.LAUNCHES["gemm"] == st.tile_ops_by_mode["gemm"]
    assert ops.LAUNCHES["densify"] > 0
    assert torch.equal(eng.run(rp, x, residency="host"), y)
    assert eng.exec_stats.tiles_remapped == st.tiles_remapped
    want = TR.run_reference(TB.build("b1", g), g,
                            torch.as_tensor(x, device=cuda),
                            dtype=torch.float64)
    _close(y, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n1,w,n_src", [(64, 24, 45), (4096, 64, 4096)])
def test_cuda_densify_duplicates_same_bits(cuda, n1, w, n_src):
    # A tile whose rows hold the same column many times (values of mixed
    # sign and scale, so the sum order shows in the bits): ten calls give
    # the same bits, those of the plain version's slot-order sum.
    g = torch.Generator(device=cuda).manual_seed(5)
    cols = torch.randint(0, 4, (n1, w), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(n1, w, generator=g, device=cuda) * torch.where(
        torch.rand(n1, w, generator=g, device=cuda) > 0.5, 1e4, 1.0)
    # Zero-valued slots of either sign (which the kernel skips) and sums
    # that cancel exactly: the bits, signs of zero included, are still
    # the plain version's.
    vals[0, :6] = torch.tensor([1.5, -1.5, -0.0, 0.0, 2.0, -0.0])
    cols[0, :6] = torch.tensor([1, 1, 1, 2, 3, 3], dtype=torch.int32)
    vals[1, :3] = -0.0
    ops.reset_launches()
    first = ops.densify(cols, vals, n_src)
    assert ops.LAUNCHES["densify"] == 1
    bits = first.view(torch.int32)
    for _ in range(9):
        assert torch.equal(ops.densify(cols, vals, n_src).view(torch.int32),
                           bits)
    assert torch.equal(ref.densify_ref(cols, vals, n_src).view(torch.int32),
                       bits)
    assert float(first[:, 4:].abs().max()) == 0.0


def test_cuda_host_path_survives_delayed_streams(cuda):
    # The host path's copies run on a side stream and its kernels on the
    # engine's: delaying either behind a ~0.1 s spin must not change a
    # bit.  A missing wait on the copy event (kernels reading a window
    # still in flight) or a missing record_stream shows up here.
    g = _powerlaw(seed=6)
    model = build_gat_dot(TB, g, hidden=16)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    prog = eng.compile(model, g, residency="host")
    x = TG.random_features(g, seed=8)
    want = eng.run(prog, x, residency="device")
    assert torch.equal(eng.run(prog, x), want)       # host default
    side = eng.executor._copy_stream
    assert side is not None
    for delayed in (side, eng.stream, torch.cuda.current_stream()):
        with torch.cuda.stream(delayed):
            torch.cuda._sleep(100_000_000)
        assert torch.equal(eng.run(prog, x), want)


# --------------------------------------------------------------------------- #
# Graph-as-data (the sampling layer's mode) and the conformance inputs.
# --------------------------------------------------------------------------- #
def _bucketed(g, model, targets, fanouts, seed, geom):
    from repro_torch.sampling import (bucket_for, layout_graph, sample_ego,
                                      template_graph)
    X = TG.random_features(g, seed=1)
    ego = sample_ego(g, targets, fanouts, seed=seed)
    sub = ego.graph.gcn_normalized()
    bucket = bucket_for(sub, geom)
    x_pad = np.zeros((bucket.n_vertices, g.feat_dim), np.float32)
    x_pad[: ego.vertices.shape[0]] = X[ego.vertices]
    unpadded = InferenceRequest(model=model, graph=sub,
                                features=X[ego.vertices])
    bucketed = InferenceRequest(
        model=model, graph=template_graph(bucket, geom), features=x_pad,
        graph_data=layout_graph(sub, bucket, geom))
    return unpadded, bucketed


def _sampling_parent(ne=2400):
    g = TG.random_graph(400, ne, seed=3, degree="powerlaw", dedupe=True)
    g.feat_dim, g.n_classes = 16, 4
    return g


@pytest.mark.parametrize("model", ["b1", "b3", "b6"])
def test_cuda_graph_as_data_padded_equals_unpadded(cuda, model):
    geom = PartitionConfig(n1=32, n2=8)
    unpadded, bucketed = _bucketed(_sampling_parent(), model, [5, 9, 77],
                                   (6, 4), 11, geom)
    eng = Engine(geometry=geom, n_pes=4)
    y_ref = eng.submit(unpadded).output
    ops.reset_launches()
    y_bkt = eng.submit(bucketed).output
    modes = eng.exec_stats.tile_ops_by_mode
    assert ops.LAUNCHES["gemm"] == modes["gemm"] > 0
    assert ops.LAUNCHES["spdmm"] == modes["spdmm"] > 0
    assert torch.equal(y_bkt[: y_ref.shape[0]], y_ref)
    sub = unpadded.graph
    _close(y_ref, TR.run_reference(
        TB.build(model, sub), sub,
        torch.as_tensor(unpadded.features, device=cuda),
        dtype=torch.float64), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("model", ["b1", "b6"])
def test_cuda_graph_as_data_lanes_equal_singles(cuda, model):
    geom = PartitionConfig(n1=32, n2=8)
    g = _sampling_parent(ne=24000)
    reqs = [_bucketed(g, model, [5 + i, 90 + i], (6, 4), 11 + i, geom)[1]
            for i in range(3)]
    eng = Engine(geometry=geom, n_pes=4)
    singles = [eng.submit(r).output for r in reqs]
    ops.reset_launches()
    batched = eng.submit_batch(reqs)
    modes = eng.exec_stats.tile_ops_by_mode
    # Three requests run as JAX's bucket of 4 lanes (one zero lane).
    assert ops.LAUNCHES["spdmm"] == 4 * modes["spdmm"] > 0
    for got, want in zip(batched, singles):
        assert got.batch_size == 3
        assert torch.equal(got.output, want)


def test_cuda_malformed_graph_data_launches_nothing(cuda):
    geom = PartitionConfig(n1=32, n2=8)
    _, bucketed = _bucketed(_sampling_parent(), "b1", [5, 9, 77], (6, 4),
                            11, geom)
    eng = Engine(geometry=geom, n_pes=4)
    prog = eng.compile("b1", bucketed.graph)
    gd = bucketed.graph_data
    key = sorted(gd["tiles"])[-1]
    cols = gd["tiles"][key]["cols"].copy()
    cols[3, 0] = geom.n1                       # one row past the block
    bad = {"tiles": {**gd["tiles"], key: {**gd["tiles"][key],
                                          "cols": cols}},
           "inv_in_degree": gd["inv_in_degree"]}
    ops.reset_launches()
    with pytest.raises(ValueError, match="column indices"):
        eng.run(prog, bucketed.features, graph_data=bad)
    assert sum(ops.LAUNCHES.values()) == 0


def test_cuda_stage_copy_time_against_events(cuda):
    # The stage span's copy_us is the device time of the copies on the
    # copy stream: within an event pair recorded around the same staging
    # on that stream, and far above the host's issue time of the
    # asynchronous copies from pinned memory (what the span's duration
    # measures).
    from repro_torch.obs import fit_stage_bw, tracing
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    ex = eng.executor
    arrs = {("t", i): torch.randn(4 << 20).pin_memory() for i in range(4)}
    nbytes = sum(a.numel() * 4 for a in arrs.values())
    for _ in range(2):                         # warm the allocator
        staged, _, _, span = ex._stage(arrs)
        ex._sync()
        ex._stage_done(span)
        del staged
    side = ex._copy_stream
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with tracing() as t:
        a.record(side)
        staged, got, ready, span = ex._stage(arrs, shard=0, layer=0)
        b.record(side)
        torch.cuda.current_stream().wait_event(ready)
        ex._sync()
        ex._stage_done(span)
    torch.cuda.synchronize()
    (ev,) = [e for e in t.events() if e.get("name") == "stage"]
    outer_us = a.elapsed_time(b) * 1e3
    assert got == nbytes == ev["args"]["bytes"]
    assert 0.5 * outer_us <= ev["args"]["copy_us"] <= outer_us * 1.001
    assert ev["dur"] < ev["args"]["copy_us"]
    assert fit_stage_bw(t.events()) == pytest.approx(
        nbytes / (ev["args"]["copy_us"] / 1e6))


def test_cuda_conformance_reports(cuda):
    from repro_torch.obs import build_report, tracing
    g = _powerlaw(seed=9)
    x = TG.random_features(g, seed=1)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4)
    prog = eng.compile("b3", g, use_cache=False)
    for residency in ("device", "host"):
        eng.run(prog, x, residency=residency)          # warm
        with tracing() as t:
            eng.run(prog, x, residency=residency)
        rep = build_report(prog, eng.exec_stats, residency=residency,
                           events=t.events())
        assert rep.measured_s > 0 and rep.per_layer
        for m, e in rep.model_error.items():
            assert rep.model_error_calibrated[m] <= e + 1e-12
        assert ("stage_bw" in rep.calibrated_constants) == \
            (residency == "host")


# --------------------------------------------------------------------------- #
# Live graphs on the card.
# --------------------------------------------------------------------------- #
def _live_delta(g, seed, n_add=6, n_rm=4):
    """A content delta: removals of distinct existing pairs, then adds
    between existing vertices."""
    from repro_torch.livegraph import GraphDelta
    rng = np.random.default_rng(seed)
    d = GraphDelta(g.n_vertices)
    pairs = []
    while len(pairs) < n_rm:
        i = int(rng.integers(0, g.n_edges))
        p = (int(g.src[i]), int(g.dst[i]))
        if p not in pairs:
            pairs.append(p)
    for p in pairs:
        d.remove_edge(*p)
    for _ in range(n_add):
        u, v = map(int, rng.integers(0, g.n_vertices, 2))
        d.add_edge(u, v, float(rng.uniform(0.1, 1.0)))
    return d


def _kind_bytes(t, kind):
    return {"cols": 4 * t.cols.size, "vals": 4 * t.vals.size,
            "mask": t.cols.size, "row_len": 4 * t.cols.shape[0],
            "live_pos": 8 * t.nnz, "live_epos": 8 * t.nnz}[kind]


@pytest.mark.parametrize("which", ["b2", "gat-dot"])
def test_cuda_live_rebind_equals_cold_compile(cuda, which):
    from repro_torch.livegraph import GraphVersionStore, LiveGraphServer
    g = _powerlaw(nv=300, ne=2400, seed=6)
    geom = PartitionConfig(n1=64, n2=16)
    store = GraphVersionStore(g, geometry=geom)
    live = LiveGraphServer(store)
    model = which if which == "b2" else build_gat_dot(TB, g)
    eng = Engine(geom, device=cuda)
    x = TG.random_features(g, seed=1)
    eng.submit(InferenceRequest(model, live, x))
    v1 = live.apply(_live_delta(g, seed=2))
    assert v1.store.eid_capacity >= v1.store.live_edges
    resp = eng.submit(InferenceRequest(model, live, x))
    assert resp.cache_hit and eng.stats.compiles == 1
    cold = Engine(geom, device=cuda)
    g1 = dataclasses.replace(v1.as_graph(), name="cold")   # not live
    want = cold.run(cold.compile(model, g1), x)
    assert torch.equal(resp.output, want)
    prog = eng.compile(model, live)
    assert torch.equal(eng.run(prog, x, residency="host"), want)
    y64 = TR.run_reference(TB.build(model, g1, 0) if which == "b2"
                           else model, g1, torch.as_tensor(x, device=cuda),
                           dtype=torch.float64)
    _close(resp.output, y64, rtol=2e-4, atol=2e-5)


def test_cuda_content_delta_uploads_only_patched_tiles(cuda):
    from repro_torch.engine.executor import _staged
    from repro_torch.livegraph import GraphVersionStore, LiveGraphServer
    g = _powerlaw(nv=300, ne=2400, seed=7)
    geom = PartitionConfig(n1=64, n2=16)
    store = GraphVersionStore(g, geometry=geom)
    live = LiveGraphServer(store)
    eng = Engine(geom, device=cuda)
    x = TG.random_features(g, seed=1)
    eng.submit(InferenceRequest("b2", live, x))
    kinds = _staged(store.head.pgraph, eng.device).kinds()
    v1 = live.apply(_live_delta(g, seed=3, n_add=2, n_rm=2))
    eng.submit(InferenceRequest("b2", live, x))
    st = _staged(v1.pgraph, eng.device)
    patched = [tuple(map(int, k.split(":"))) for k in v1.stats.patched]
    want = v1.pgraph.inv_in_degree.nbytes + sum(
        _kind_bytes(t, kind) for jk in patched
        for t in v1.pgraph.tiles[jk] for kind in kinds)
    assert 0 < len(patched) < len(v1.pgraph.tiles)
    assert st.kinds() == kinds and st.uploaded == want


def test_cuda_reclaimed_version_frees_its_own_bytes(cuda):
    from repro_torch.engine.executor import _staged
    from repro_torch.livegraph import GraphVersionStore, LiveGraphServer
    g = _powerlaw(nv=300, ne=2400, seed=8)
    geom = PartitionConfig(n1=64, n2=16)
    store = GraphVersionStore(g, geometry=geom)
    live = LiveGraphServer(store)
    eng = Engine(geom, device=cuda)
    x = TG.random_features(g, seed=1)
    eng.submit(InferenceRequest("b2", live, x))
    v1 = store.apply(_live_delta(g, seed=4))
    v2 = store.apply(_live_delta(v1.as_graph(), seed=5))
    for v in (v1, v2):
        eng.submit(InferenceRequest("b2", v.as_graph(), x))
    kinds = _staged(v1.pgraph, eng.device).kinds()
    # What reclaiming v1 frees: its copies of the tiles v2 does not hold.
    v2_tiles = {id(t) for ts in v2.pgraph.tiles.values() for t in ts}
    own = sum(_kind_bytes(t, kind) for ts in v1.pgraph.tiles.values()
              for t in ts if id(t) not in v2_tiles for kind in kinds)
    assert own > 0
    live.cutover(v1)                        # v0 retired and reclaimed
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    live.cutover(v2)                        # v1 retired and reclaimed
    torch.cuda.synchronize()
    assert live.reclaimed == [0, 1]
    assert before - torch.cuda.memory_allocated() >= own
    cold = Engine(geom, device=cuda)
    g2c = dataclasses.replace(v2.as_graph(), name="cold")
    assert torch.equal(eng.submit(InferenceRequest("b2", live, x)).output,
                       cold.run(cold.compile("b2", g2c), x))


# --------------------------------------------------------------------------- #
# Replays (CUDA graphs) against the eager route.
# --------------------------------------------------------------------------- #
CO_GEOM = PartitionConfig(n1=1024, n2=128)


def _stats(st):
    d = dataclasses.asdict(st)
    for rec in d["per_layer"] or []:
        rec.pop("wall_s")
    return d


def _replays(prog):
    return list(prog.__dict__.get("_replays", {}).values())


@pytest.mark.parametrize("which", ["b2", "gat-dot"])
def test_cuda_replay_equals_eager(cuda, which):
    g = TG.synthesize("CO").gcn_normalized()
    model = which if which == "b2" else build_gat_dot(TB, g)
    eng, eager = Engine(CO_GEOM), Engine(CO_GEOM, replay=False)
    prog, eprog = eng.compile(model, g), eager.compile(model, g)
    xs = [TG.random_features(g, seed=s) for s in range(4)]
    ops.reset_launches()
    outs, stats = [], []
    for x in xs:
        y = eng.run(prog, x)
        outs.append((y, y.clone()))
        stats.append(_stats(eng.exec_stats))
    launched, replayed = dict(ops.LAUNCHES), dict(ops.REPLAYED)
    modes = eng.exec_stats.tile_ops_by_mode
    for k in ("gemm", "spdmm", "sddmm"):
        # Two eager passes through the wrappers (the first stages the
        # graph), the capture launching nothing, two replays.
        assert launched[k] == 2 * modes.get(k, 0)
        assert replayed[k] == 2 * modes.get(k, 0)
    assert launched["spdmm"] > 0
    (rp,) = _replays(prog)
    assert rp.graph is not None
    for (y, kept), x, st in zip(outs, xs, stats):
        assert torch.equal(y, kept)            # not overwritten since
        assert torch.equal(y, eager.run(eprog, x))
        assert st == _stats(eager.exec_stats)
    assert not _replays(eprog)
    _close(outs[-1][0], TR.run_reference(
        TB.build(model, g) if which == "b2" else model, g,
        torch.as_tensor(xs[-1], device=cuda), dtype=torch.float64),
        rtol=2e-4, atol=2e-5)


def test_cuda_replayed_sampled_lanes(cuda):
    geom = PartitionConfig(n1=32, n2=8)
    g = _sampling_parent(ne=24000)
    reqs = [_bucketed(g, "b6", [5 + i, 90 + i], (6, 4), 11 + i, geom)[1]
            for i in range(8)]
    live = [sum(int(np.asarray(t["mask"]).sum())
                for t in r.graph_data["tiles"].values()) for r in reqs]
    assert len(set(live)) > 4
    eng = Engine(geometry=geom, n_pes=4)
    eager = Engine(geometry=geom, n_pes=4, replay=False)
    for lo in (0, 3, 5, 1, 4):                 # 3 lanes: a bucket of 4
        batch = reqs[lo:lo + 3]
        got, want = eng.submit_batch(batch), eager.submit_batch(batch)
        for a, b in zip(got, want):
            assert a.batch_size == 3 and torch.equal(a.output, b.output)
        assert _stats(eng.exec_stats) == _stats(eager.exec_stats)
    (rp,) = _replays(eng.cache.get(got[0].cache_key))
    assert rp.graph is not None and rp.xs.shape[0] == 4


def test_cuda_released_and_reclaimed_stagings_drop_captures(cuda):
    from repro_torch.engine.executor import release_staging
    from repro_torch.livegraph import GraphVersionStore, LiveGraphServer
    g = _powerlaw(nv=300, ne=2400, seed=9)
    geom = PartitionConfig(n1=64, n2=16)
    x = TG.random_features(g, seed=1)
    eng, eager = Engine(geom), Engine(geom, replay=False)
    prog = eng.compile("b2", g)
    want = eager.run(eager.compile("b2", g), x)
    for _ in range(3):
        assert torch.equal(eng.run(prog, x), want)
    (rp,) = _replays(prog)
    release_staging(prog.pgraph)
    assert rp.dropped and rp.graph is None and rp.reads is None
    for _ in range(3):                         # re-staged, then replayed
        assert torch.equal(eng.run(prog, x), want)
    (rp2,) = _replays(prog)
    assert rp2.graph is not None
    live = LiveGraphServer(GraphVersionStore(g, geometry=geom))
    for _ in range(3):
        eng.submit(InferenceRequest("b2", live, x))
    (rp0,) = _replays(eng.compile("b2", live))
    assert rp0.graph is not None
    v1 = live.apply(_live_delta(g, seed=2))
    live.cutover(v1)                           # v0 retired and reclaimed
    assert live.reclaimed == [0] and rp0.dropped
    cold = Engine(geom, replay=False)
    want1 = cold.run(cold.compile("b2", dataclasses.replace(
        v1.as_graph(), name="cold")), x)
    for _ in range(3):
        assert torch.equal(eng.submit(InferenceRequest("b2", live,
                                                       x)).output, want1)


def test_cuda_pool_engines_replay_concurrently(cuda):
    import threading
    from repro_torch.runtime import OverlayPool
    g = TG.synthesize("CO").gcn_normalized()
    model = build_gat_dot(TB, g)
    pool = OverlayPool(2, geometry=CO_GEOM)
    prog = pool.engines[0].compile(model, g)
    eager = Engine(CO_GEOM, replay=False)
    eprog = eager.compile(model, g)
    xs = [TG.random_features(g, seed=s) for s in range(6)]
    want = [eager.run(eprog, x) for x in xs]
    got = [[None] * len(xs) for _ in pool.engines]
    errors = []

    def drive(i, eng):
        try:
            for r in range(3):
                for n, x in enumerate(xs):
                    got[i][n] = eng.run(prog, x)
        except Exception as e:                  # reported below
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(i, e))
               for i, e in enumerate(pool.engines)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors, errors
    for outs in got:
        for y, w in zip(outs, want):
            assert torch.equal(y, w)
    assert len([rp for rp in _replays(prog) if rp.graph is not None]) == 2


def test_cuda_captured_serve_step_equals_eager_over_gemma3_ring(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              dtype="float32")
    model = build_model(cfg, seed=2)
    assert model.embed.device.type == "cuda"
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 7)).astype(np.int32), device=cuda)
    gen = 12                                   # positions to 18 > window 8
    captured, _, _ = generate(model, cfg, prompts, gen, capture=True)
    eager, _, _ = generate(model, cfg, prompts, gen, capture=False)
    assert captured.shape == (3, gen) and torch.equal(captured, eager)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_cuda_recurrent_smoke_models_match_the_cpu(cuda, arch):
    # The smoke model in fp32 on the card (hymba: the flash kernel under
    # its window of 8, the SSD chunk loop; xLSTM: the mLSTM's quadratic
    # form, the sLSTM's loop) against the same weights on the CPU: forward
    # logits, then decode over 20 positions with the state caches.
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, seed=4)
    cpu = build_model(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32))
    ops.reset_launches()
    got, _ = model(toks.to(cuda))
    assert ops.LAUNCHES["flash_attention"] == (
        cfg.n_layers if arch == "hymba-1.5b" else 0)
    want, _ = cpu(toks)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-5
    caches = {"cuda": model.init_cache(2, 20), "cpu": cpu.init_cache(2, 20)}
    for i in range(20):
        lg, _ = model.decode_step(caches["cuda"], toks[:, i:i + 1].to(cuda),
                                  i)
        lc, _ = cpu.decode_step(caches["cpu"], toks[:, i:i + 1], i)
        assert float((lg.cpu() - lc).abs().max()) / scale < 1e-5
    for a, b in zip(caches["cuda"], caches["cpu"]):
        for k in a:
            assert a[k].device.type == "cuda"
            _close(a[k], b[k], 1e-4, 1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_cuda_captured_decode_updates_recurrent_state_in_place(cuda, arch):
    # launch.serve's captured step over the SSM / mLSTM / sLSTM state
    # caches, token for token the eager step: the replays write the
    # states in place (hymba: 18 positions wrap the rings of 8).
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import generate
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, seed=2)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 7)).astype(np.int32), device=cuda)
    captured, _, _ = generate(model, cfg, prompts, 12, capture=True)
    eager, _, _ = generate(model, cfg, prompts, 12, capture=False)
    assert captured.shape == (3, 12) and torch.equal(captured, eager)


def test_cuda_collected_engine_frees_its_captures(cuda):
    import gc
    g = TG.synthesize("CO").gcn_normalized()
    eng = Engine(CO_GEOM)
    prog = eng.compile("b2", g)
    x = TG.random_features(g, seed=0)
    want = eng.run(prog, x)                    # stages the graph
    torch.cuda.synchronize(cuda)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(cuda)
    reserved = torch.cuda.memory_reserved(cuda)
    for lanes in (1, 2):                       # warm, capture, replay
        for _ in range(3):
            y = eng.run_batch(prog, np.stack([x] * lanes))
            assert all(torch.equal(y[n], want) for n in range(lanes))
    del y
    rps = [rp for rp in _replays(prog) if rp.graph is not None]
    assert len(rps) == 2 and rps[0].graph.pool == rps[1].graph.pool
    held = torch.cuda.memory_allocated(cuda) - base
    assert 0 < held <= eng.executor._held_bytes(prog)
    del eng, rps
    gc.collect()
    assert all(rp.dropped for rp in _replays(prog))
    assert torch.cuda.memory_allocated(cuda) <= base
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved(cuda) <= reserved


# --------------------------------------------------------------------------- #
# bf16 GEMM / SpDMM operands (the Pallas kernels' bf16 sweeps)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_cuda_gemm_bf16_matches_plain_and_the_fp32_kernel(cuda, m, k, n):
    # bf16 x / w (strided x): within the JAX sweep's bf16 tolerance of the
    # plain version, and bit for bit the fp32 kernel on the widened
    # operands (one fmaf chain over k in both bodies); a bf16 output is
    # that result rounded.
    g = torch.Generator(device=cuda).manual_seed(m + 3 * n)
    x = torch.randn(m, 2 * k, generator=g, device=cuda).bfloat16()[:, k:]
    w = torch.randn(k, n, generator=g, device=cuda).bfloat16()
    acc = torch.randn(m, n, generator=g, device=cuda)
    ops.reset_launches()
    got = ops.gemm(x, w, acc)
    assert ops.LAUNCHES["gemm"] == 1 and got.dtype == torch.float32
    _close(got, acc + ref.gemm_ref(x, w), 2e-2, 1e-2)
    wide = ops.gemm(x.float(), w.float(), acc)
    assert torch.equal(got, wide)
    out16 = ops.gemm(x, w, acc, out_dtype=torch.bfloat16)
    assert torch.equal(out16, wide.bfloat16())
    x32 = x.float()
    assert torch.equal(ops.gemm(x32, w.float(), out_dtype=torch.bfloat16),
                       ops.gemm(x32, w.float()).bfloat16())


@pytest.mark.parametrize("n1,w,ns,f", SPDMM_SHAPES)
def test_cuda_spdmm_bf16_h_matches_plain_and_the_fp32_kernel(cuda, n1, w,
                                                             ns, f):
    g = torch.Generator(device=cuda).manual_seed(n1 + f)
    cols = torch.randint(0, ns, (n1, w), generator=g, device=cuda,
                         dtype=torch.int32)
    vals = torch.randn(n1, w, generator=g, device=cuda) * (
        torch.rand(n1, w, generator=g, device=cuda) > 0.4)
    h = torch.randn(ns, 2 * f, generator=g, device=cuda).bfloat16()[:, f:]
    acc = torch.randn(n1, f, generator=g, device=cuda)
    row_len = torch.randint(0, w + 1, (n1,), generator=g, device=cuda,
                            dtype=torch.int32)
    ops.reset_launches()
    got = ops.spdmm(cols, vals, h, acc)
    assert ops.LAUNCHES["spdmm"] == 1 and got.dtype == torch.float32
    _close(got, acc + ref.spdmm_ref(cols, vals, h), 2e-2, 1e-2)
    assert torch.equal(got, ops.spdmm(cols, vals, h.float(), acc))
    assert torch.equal(ops.spdmm(cols, vals, h, None, row_len),
                       ops.spdmm(cols, vals, h.float(), None, row_len))


# --------------------------------------------------------------------------- #
# kimi-k2 and deepseek-v3: flash at their shapes, MoE and MLA on the card
# --------------------------------------------------------------------------- #
def _rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_kimi_group_and_mla_padded_v_match_plain(cuda, dtype):
    # kimi-k2's prefill heads (G = 8, d = 112) and deepseek-v3's MLA call
    # (d = 192, V of 128 zero-padded: the padded columns stay zero), at a
    # ragged T.
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(8)
    t = 300
    q = torch.randn(16, t, 112, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(2, t, 112, generator=g, device=cuda).to(dt)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, True)
    want = ref.flash_attention_plain(q, k, v, True)
    if dtype == "float32":
        _close(got, want, 0.0, 2e-5)
    else:
        assert _rel(got, want) <= 2.0 ** -8
    q, k = (torch.randn(4, t, 192, generator=g, device=cuda).to(dt)
            for _ in range(2))
    v = torch.nn.functional.pad(
        torch.randn(4, t, 128, generator=g, device=cuda).to(dt), (0, 64))
    got = ops.flash_attention(q, k, v, True)
    want = ref.flash_attention_plain(q, k, v, True)
    assert float(got[..., 128:].abs().max()) == 0.0
    if dtype == "float32":
        _close(got, want, 0.0, 2e-5)
    else:
        assert _rel(got, want) <= 2.0 ** -8


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_cuda_moe_mla_smoke_models_match_the_cpu(cuda, arch):
    # The smoke model in fp32 with moe_impl="a2a" on four virtual entries
    # of the card against the same weights on four CPU entries: forward
    # logits and aux (flash, moe_a2a), then decode over 10 positions
    # (moe_local; MLA's absorbed step).
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import DeviceMesh
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, seed=4, moe_impl="a2a",
                        mesh=DeviceMesh([cuda] * 4))
    cpu = build_model(cfg, device="cpu", seed=0, moe_impl="a2a",
                      mesh=DeviceMesh(["cpu"] * 4))
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 10)).astype(np.int32))
    ops.reset_launches()
    got, aux = model(toks.to(cuda))
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    want, want_aux = cpu(toks)
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) / scale < 1e-5
    assert abs(float(aux) - float(want_aux)) < 1e-5
    caches = {"cuda": model.init_cache(2, 10), "cpu": cpu.init_cache(2, 10)}
    for i in range(10):
        lg, _ = model.decode_step(caches["cuda"], toks[:, i:i + 1].to(cuda),
                                  torch.tensor(i, device=cuda))
        lc, _ = cpu.decode_step(caches["cpu"], toks[:, i:i + 1], i)
        assert float((lg.cpu() - lc).abs().max()) / scale < 1e-5


@pytest.mark.parametrize("moe_impl", ["dense", "a2a"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_cuda_captured_decode_over_moe_and_latent_caches(cuda, arch,
                                                         moe_impl):
    # launch.serve's captured step (router sort, capacity dispatch, the
    # MLA caches written at the position tensor) token for token the eager
    # step.
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.serve import generate
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, seed=2, moe_impl=moe_impl,
                        mesh=DeviceMesh([cuda] * 2))
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 7)).astype(np.int32), device=cuda)
    captured, _, _ = generate(model, cfg, prompts, 12, capture=True)
    eager, _, _ = generate(model, cfg, prompts, 12, capture=False)
    assert captured.shape == (3, 12) and torch.equal(captured, eager)


def test_cuda_zero_train_step_matches_the_unsharded_step(cuda):
    # ZeRO-1 over 2 x 2 virtual entries of the card (qwen3's smoke stack
    # of 2 layers split over the 2 data rows): loss, parameters and the
    # gathered state bit for bit make_train_step's after 2 steps.
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import zero as Z
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.steps import init_train_state, make_train_step
    cfg = get_smoke_config("qwen3-0.6b")
    mesh = make_local_mesh(2, 2, [cuda] * 4)
    ref, ropt = init_train_state(build_model(cfg, seed=1))
    model = build_model(cfg, seed=1)
    zs = Z.zero_init(model, mesh)
    rstep, zstep = make_train_step(ref, cfg), Z.make_zero_train_step(
        model, cfg, mesh)
    rng = np.random.default_rng(0)
    for _ in range(2):
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                                    dtype=torch.int32, device=cuda)
                 for k in ("tokens", "labels")}
        ref, ropt, rm = rstep(ref, ropt, batch)
        model, zs, zm = zstep(model, zs, batch)
        assert torch.equal(rm["loss"], zm["loss"])
    for (n, a), (_, b) in zip(ref.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n
    full = Z.zero_gather(zs, model, mesh)
    for n in ropt.master:
        assert torch.equal(ropt.mu[n], full.mu[n]), n
        assert torch.equal(ropt.nu[n], full.nu[n]), n
        assert torch.equal(ropt.master[n], full.master[n]), n


def test_cuda_pipeline_of_layers_is_the_layer_loop(cuda):
    # GPipe over 2 virtual stage entries: bit for bit the per-microbatch
    # loop, each layer's attention through the flash kernel.
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.models.transformer import block_apply
    cfg = get_smoke_config("qwen3-0.6b")
    model = build_model(cfg, seed=0)
    x = model.embed[torch.randint(0, cfg.vocab, (3, 2, 64),
                                  device=cuda).long()]
    pairs = list(zip(model.specs, model.layers))

    def stage(layers, h):
        for spec, bp in layers:
            h, _ = block_apply(cfg, spec, bp, h, None)
        return h

    with torch.no_grad():
        want = torch.stack([stage(pairs, mb) for mb in x])
        ops.reset_launches()
        got = pipeline_apply(stage, [pairs[:1], pairs[1:]], x,
                             DeviceMesh([cuda] * 2, (2,), ("stage",)))
    assert ops.LAUNCHES["flash_attention"] == 3 * cfg.n_layers
    assert torch.equal(got, want)


def test_cuda_argument_bytes_are_the_train_state_s_bytes(cuda):
    # The dry-run's argument bytes of a 1 x 1 mesh: the bytes of the
    # parameters, fp32 master / mu / nu and batch the card holds.
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.steps import init_train_state, input_specs
    cfg = get_smoke_config("qwen3-0.6b")
    cell = ShapeCell("s", 16, 4, "train")
    mesh = make_local_mesh(1, 1, [cuda])
    want = D.argument_bytes(build_model(cfg, device="meta"), cfg, cell,
                            mesh)
    model, opt = init_train_state(build_model(cfg, seed=0))
    batch = input_specs(cfg, cell, device=cuda, zeros=True)
    tensors = (list(model.parameters()) + list(batch.values())
               + [t for d in (opt.mu, opt.nu, opt.master)
                  for t in d.values()])
    assert all(t.device.type == "cuda" for t in tensors)
    assert sum(t.numel() * t.element_size() for t in tensors) == want
