"""The port's last contracts against the JAX package, on the CPU.

* ``Engine.resident_budget_bytes`` set on the Engine (not its executor)
  refuses a device-resident run over budget, as JAX's ``Engine`` does for
  the same program and budget; ``residency="host"`` streams within it bit
  for bit the unbudgeted device run; None lifts the refusal.
* ``ops.flash_attention`` at head dims past 256 (the kernel's
  single-pass bodies on the card, in clusters past d = 576; here the plain
  version),
  causal or not, with grouped KV heads, against JAX's
  ``flash_attention_ref`` in fp32 at rtol 1e-5 / atol 1e-4, and with
  ``out_dtype=bfloat16`` against the reference cast to bf16 at JAX's bf16
  tolerance (rtol 2e-2 / atol 1e-2).
* ``ops.spdmm`` / ``ops.sddmm`` with ``out_dtype=bfloat16``, and
  ``sddmm`` on bf16 operands, against JAX's Pallas ``spdmm`` / ``sddmm``
  run with ``out_dtype=jnp.bfloat16`` in interpret mode, at 2e-2 / 1e-2.
* The six ``examples/torch_*.py``, each in a subprocess with ``--device
  cpu`` (``--quick`` where the twin has it): exit 0 with neither ``jax``
  nor a ``repro`` module imported; without the flag, on a machine that
  shows no card, each exits non-zero with the device message.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as JG  # noqa: E402
from repro.core.passes.partition import PartitionConfig as JPC  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine import ResidentBudgetError as JBudgetError  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sddmm import sddmm as pallas_sddmm  # noqa: E402
from repro.kernels.spdmm import spdmm as pallas_spdmm  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core.passes.partition import PartitionConfig  # noqa: E402
from repro_torch.engine import Engine, ResidentBudgetError  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# --------------------------------------------------------------------------- #
# Engine.resident_budget_bytes
# --------------------------------------------------------------------------- #
def _pair(seed=19):
    """The same graph, program and features in both packages."""
    gs = []
    for pkg in (G, JG):
        g = pkg.random_graph(400, 2400, seed=seed).gcn_normalized()
        g.feat_dim, g.n_classes = 12, 4
        gs.append(g)
    x = G.random_features(gs[0], seed=5)
    eng = Engine(geometry=PartitionConfig(n1=32, n2=8), n_pes=4,
                 device="cpu")
    jeng = JEngine(geometry=JPC(n1=32, n2=8), n_pes=4, verify=False)
    return eng, eng.compile("b1", gs[0]), jeng, jeng.compile("b1", gs[1]), x


def test_budget_set_on_the_engine_reaches_the_executor():
    eng = Engine(device="cpu", resident_budget_bytes=123)
    assert eng.resident_budget_bytes == 123
    eng.resident_budget_bytes = 456
    assert eng.executor.resident_budget_bytes == 456
    eng.resident_budget_bytes = None
    assert eng.executor.resident_budget_bytes is None
    assert "resident_budget_bytes" not in vars(eng)   # no plain attribute


def test_engine_budget_refuses_the_device_path_as_jax_does():
    eng, prog, jeng, jprog, x = _pair()
    f = x.shape[1]
    est = eng.executor.estimate_device_peak_bytes(prog, f)
    jest = jeng._executor.estimate_device_peak_bytes(jprog, f)
    assert est == jest
    eng.resident_budget_bytes = est // 2
    jeng.resident_budget_bytes = est // 2
    with pytest.raises(ResidentBudgetError, match="resident_budget_bytes"):
        eng.run(prog, x)
    with pytest.raises(JBudgetError):
        jeng.run(jprog, jnp.asarray(x))


def test_engine_budget_host_streams_bit_identical_to_unbudgeted_device():
    eng, prog, _, _, x = _pair()
    y_dev = eng.run(prog, x)                   # no budget yet
    window = eng.executor.estimate_host_window_bytes(prog, x.shape[1])
    est = eng.executor.estimate_device_peak_bytes(prog, x.shape[1])
    assert window < est
    eng.resident_budget_bytes = (window + est) // 2
    with pytest.raises(ResidentBudgetError):
        eng.run(prog, x)
    y_host = eng.run(prog, x, residency="host")
    assert eng.exec_stats.peak_stage_bytes <= eng.resident_budget_bytes
    assert torch.equal(y_host, y_dev)


def test_engine_budget_none_lifts_the_refusal():
    eng, prog, _, _, x = _pair()
    y_dev = eng.run(prog, x)
    eng.resident_budget_bytes = 1
    with pytest.raises(ResidentBudgetError):
        eng.run(prog, x)
    eng.resident_budget_bytes = None
    assert torch.equal(eng.run(prog, x), y_dev)


# --------------------------------------------------------------------------- #
# Flash attention at any head dim, out_dtype
# --------------------------------------------------------------------------- #
def _flash_case(d, causal, grp, seed, t=24, h=4):
    r = np.random.default_rng(seed)
    q = r.normal(0, 1, (t, h, d)).astype(np.float32)
    k, v = (r.normal(0, 1, (t, h // grp, d)).astype(np.float32)
            for _ in range(2))
    # JAX's oracle takes one sequence [T, H, d] with a KV head per query
    # head; the port's kernel [BH, T, d] with G query heads a KV head.
    rep = [np.repeat(a, grp, axis=1) for a in (k, v)]
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(rep[0]),
                                    jnp.asarray(rep[1]), causal=causal)
    port = [torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2)))
            for a in (q, k, v)]
    return port, np.asarray(want).transpose(1, 0, 2)


@pytest.mark.parametrize("grp", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [257, 320, 512])
def test_flash_any_head_dim_matches_jax(d, causal, grp):
    (q, k, v), want = _flash_case(d, causal, grp, seed=d + grp)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert ops.LAUNCHES["flash_attention"] == 0      # the CPU's plain route
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-4)
    out = ops.flash_attention(q, k, v, causal, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(out), np.asarray(jnp.asarray(want).astype(jnp.bfloat16),
                             np.float32), rtol=2e-2, atol=1e-2)


def test_flash_out_dtype_widens_bf16_and_refuses_other_types():
    (q, k, v), want = _flash_case(64, True, 2, seed=3)
    qb, kb, vb = (a.bfloat16() for a in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, True, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=1e-2)
    assert ops.flash_attention(qb, kb, vb).dtype == torch.bfloat16
    with pytest.raises(TypeError, match="out_dtype"):
        ops.flash_attention(q, k, v, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*(torch.zeros(2, 4, 0) for _ in range(3)))


# --------------------------------------------------------------------------- #
# SpDMM / SDDMM out_dtype and bf16 SDDMM operands against Pallas
# --------------------------------------------------------------------------- #
# (n1, w, n_src, f): n1 and f are the Pallas blocks (one grid cell)
ELL_SHAPES = [(64, 8, 128, 32), (32, 16, 40, 64)]


def _ell(n1, w, ns, f, seed):
    r = np.random.default_rng(seed)
    cols = r.integers(0, ns, (n1, w)).astype(np.int32)
    vals = (r.normal(0, 1, (n1, w)) * (r.random((n1, w)) > 0.4)
            ).astype(np.float32)
    return cols, vals, r


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n1,w,ns,f", ELL_SHAPES)
def test_spdmm_bf16_out_matches_pallas(n1, w, ns, f, h_dtype):
    cols, vals, r = _ell(n1, w, ns, f, seed=n1 + f)
    h = r.normal(0, 1, (ns, f)).astype(np.float32)
    jh = jnp.asarray(h).astype(getattr(jnp, h_dtype))
    want = pallas_spdmm(jnp.asarray(cols), jnp.asarray(vals), jh, bm=n1,
                        bf=f, interpret=True, out_dtype=jnp.bfloat16)
    th = torch.from_numpy(h).to(getattr(torch, h_dtype))
    got = ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals), th,
                    out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=1e-2)
    # acc stays fp32 and is added before the one rounding
    acc = torch.from_numpy(r.normal(0, 1, (n1, f)).astype(np.float32))
    assert torch.equal(
        ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals), th, acc,
                  out_dtype=torch.bfloat16),
        (acc + ops.spdmm(torch.from_numpy(cols), torch.from_numpy(vals),
                         th)).bfloat16())


@pytest.mark.parametrize("in_dtype,out_dtype", [("bfloat16", "float32"),
                                                ("bfloat16", "bfloat16"),
                                                ("float32", "bfloat16")])
@pytest.mark.parametrize("n1,w,ns,f", ELL_SHAPES)
def test_sddmm_bf16_operands_and_out_match_pallas(n1, w, ns, f, in_dtype,
                                                  out_dtype):
    cols, _, r = _ell(n1, w, ns, f, seed=n1 + w)
    hd = r.normal(0, 1, (n1, f)).astype(np.float32)
    hs = r.normal(0, 1, (ns, f)).astype(np.float32)
    jd, js = (jnp.asarray(a).astype(getattr(jnp, in_dtype))
              for a in (hd, hs))
    want = pallas_sddmm(jd, js, jnp.asarray(cols), bm=n1, bf=f,
                        interpret=True, out_dtype=getattr(jnp, out_dtype))
    td, ts = (torch.from_numpy(a).to(getattr(torch, in_dtype))
              for a in (hd, hs))
    got = ops.sddmm(td, ts, torch.from_numpy(cols),
                    out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=1e-2)
    # bf16 operands score as their fp32 widening does
    if in_dtype == "bfloat16":
        assert torch.equal(got, ops.sddmm(
            td.float(), ts.float(), torch.from_numpy(cols),
            out_dtype=getattr(torch, out_dtype)))


# --------------------------------------------------------------------------- #
# The examples on the port
# --------------------------------------------------------------------------- #
EXAMPLES = {"quickstart": [], "compiler_tour": [], "minibatch_serve": [],
            "serve_gnn": ["--quick"], "lm_pretrain_smoke": ["--quick"],
            "trace_inference": ["--quick", "--out", None]}

# Runs an example's main() and reports whether JAX or the JAX package
# was imported by it.
_RUNNER = (
    "import runpy, sys\n"
    "path = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path(path, run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    if e.code not in (0, None):\n"
    "        raise\n"
    "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
    "             or m.startswith(('jax.', 'repro.')))\n"
    "print('IMPORTED', bad)\n"
    "sys.exit(1 if bad else 0)\n")


def _start(name, args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-c", _RUNNER,
         os.path.join(ROOT, "examples", f"torch_{name}.py"), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def example_runs(tmp_path_factory):
    """Every example started at once (on the CPU, and without the flag
    on a machine that shows no card); name -> (cpu proc, refused proc)."""
    out = tmp_path_factory.mktemp("examples")
    procs = {}
    try:
        for name, extra in EXAMPLES.items():
            args = [str(out / "trace.json") if a is None else a
                    for a in extra]
            procs[name] = (
                _start(name, ["--device", "cpu", *args]),
                _start(name, [a for a in args if a != "--quick"],
                       {"CUDA_VISIBLE_DEVICES": ""}))
        yield {n: tuple((p.communicate(timeout=240)[0], p.returncode)
                        for p in pair) for n, pair in procs.items()}
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_without_jax(example_runs, name):
    (log, rc), _ = example_runs[name]
    assert rc == 0, log[-3000:]
    assert "IMPORTED []" in log


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_without_a_card_fails_loudly(example_runs, name):
    _, (log, rc) = example_runs[name]
    assert rc != 0
    assert "CUDA device by default and none is available" in log, log[-2000:]
