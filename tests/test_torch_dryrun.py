"""The port's dry-run tools (``repro_torch.launch.{dryrun,op_analysis,
roofline}``, ``models.config.SHAPES``, ``models.steps.input_specs`` and the
kernel wrappers' meta route) against JAX's (``repro.launch``): cells and
skip rules, input stand-ins, per-device argument bytes equal to JAX's
``NamedSharding.shard_shape`` bytes for every config on both production
meshes, traced flops against ``FlopCounterMode`` over a real CPU run, the
report's rows, and smoke cells traced end to end on ``meta``."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.distributed.zero import opt_state_specs as j_opt_specs  # noqa
from repro.launch import roofline as JR  # noqa: E402
from repro.models import config as JC  # noqa: E402
from repro.models.steps import build_model as jbuild  # noqa: E402
from repro.models.steps import input_specs as j_input_specs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import op_analysis as OA  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import config as TC  # noqa: E402
from repro_torch.models import steps as TS  # noqa: E402

JMESH = {False: AbstractMesh((16, 16), ("data", "model")),
         True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _jax_dryrun():
    """``repro.launch.dryrun`` (it sets XLA_FLAGS when imported; the
    variable is put back so later subprocesses see this process's)."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return dryrun


# --------------------------------------------------------------------------- #
# Kernel wrappers on meta.
# --------------------------------------------------------------------------- #
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_answer_meta_operands_with_shapes_and_costs():
    seen = []
    before = dict(ops.LAUNCHES)
    with ops.meta_costs(lambda *a: seen.append(a)):
        y = ops.gemm(_meta(64, 32, dtype=torch.bfloat16),
                     _meta(32, 16, dtype=torch.bfloat16),
                     out_dtype=torch.bfloat16)
        assert (y.shape, y.dtype, y.device.type) == ((64, 16),
                                                      torch.bfloat16, "meta")
        assert seen[-1] == ("gemm", 2.0 * 64 * 16 * 32,
                            2.0 * (64 * 32 + 32 * 16 + 64 * 16))
        cols, vals = _meta(128, 8, dtype=torch.int32), _meta(128, 8)
        y = ops.spdmm(cols, vals, _meta(50, 24), acc=_meta(128, 24))
        assert y.shape == (128, 24) and seen[-1][1] == 2.0 * 128 * 8 * 24
        assert ops.densify(cols, vals, 50).shape == (128, 50)
        y = ops.sddmm(_meta(128, 24), _meta(50, 24), cols,
                      mask=_meta(128, 8, dtype=torch.bool))
        assert y.shape == (128, 8) and seen[-1][0] == "sddmm"
        q = _meta(8, 100, 64, dtype=torch.bfloat16)
        kv = _meta(2, 100, 64, dtype=torch.bfloat16)
        y = ops.flash_attention(q, kv, kv, causal=True, window=30)
        assert y.shape == q.shape and y.dtype == torch.bfloat16
        pairs = sum(min(100, i + 1) - max(0, i - 30 + 1) for i in range(100))
        assert seen[-1] == ("flash_attention", 4.0 * 64 * 8 * pairs,
                            2.0 * 64 * (2 * 8 * 100 + 2 * 2 * 100))
    assert [s[0] for s in seen] == ["gemm", "spdmm", "densify", "sddmm",
                                    "flash_attention"]
    assert ops.LAUNCHES == before           # nothing launched
    ops.gemm(_meta(4, 4), _meta(4, 4))      # no sink open: no report
    assert len(seen) == 5


@pytest.mark.parametrize("tq,tk,causal,window", [
    (128, 128, True, 0), (100, 300, True, 0), (300, 100, True, 0),
    (257, 257, True, 64), (64, 80, False, 0), (1, 1, True, 0),
    (2048, 2048, True, 1024)])
def test_flash_pairs_are_the_bound_s_pairs(tq, tk, causal, window):
    if causal:
        want = sum(min(tk, i + 1) - (max(0, i - window + 1) if window else 0)
                   for i in range(tq))
    else:
        want = tq * tk
    assert ops.flash_pairs(tq, tk, causal, window) == want


def test_wrappers_name_mixed_and_unsupported_devices():
    with pytest.raises(ValueError, match="mixed devices"):
        ops.gemm(_meta(4, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="mixed devices"):
        ops.flash_attention(_meta(2, 8, 16), torch.zeros(2, 8, 16),
                            torch.zeros(2, 8, 16))
    y = ops.gemm(torch.ones(2, 3), torch.ones(3, 2))    # the CPU route
    assert torch.equal(y, torch.full((2, 2), 3.0))


# --------------------------------------------------------------------------- #
# Cells and inputs.
# --------------------------------------------------------------------------- #
def test_shape_cells_skip_rules_and_active_params_equal_jax_s():
    jd = _jax_dryrun()
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    assert all(TC.SHAPES[k].tokens == JC.SHAPES[k].tokens
               for k in JC.SHAPES)
    assert D.LONG_OK == jd.LONG_OK
    for arch in ARCHS:
        assert get_config(arch).n_active_params() == \
            jget_config(arch).n_active_params()
        for shape in TC.SHAPES:
            assert D.cell_supported(arch, shape) == \
                jd.cell_supported(arch, shape)


_JDT = {"int32": torch.int32, "bfloat16": torch.bfloat16,
        "float32": torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax_s(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for cell in TC.SHAPES.values():
        got = TS.input_specs(cfg, cell)
        want = j_input_specs(jcfg, JC.SHAPES[cell.name])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (k, cell.name)
            assert t.dtype == _JDT[str(want[k].dtype)], (k, cell.name)
    small = TC.ShapeCell("s", 8, 2, "train")
    z = TS.input_specs(cfg, small, device="cpu", zeros=True)
    assert all(t.device.type == "cpu" and not t.any() for t in z.values())


def _jax_bytes(sharding, leaf):
    return math.prod(sharding.shard_shape(leaf.shape)) * \
        np.dtype(leaf.dtype).itemsize


def _jax_argument_bytes(arch, shape, multi):
    """JAX's per-device bytes of a cell's arguments: params, AdamW state
    (its 4-byte step counter left out: the port keeps it on the host) and
    batch, or params, caches, token and pos."""
    jd = _jax_dryrun()
    am, cfg, cell = JMESH[multi], jget_config(arch), JC.SHAPES[shape]
    model = jbuild(cfg)
    ps = model.param_specs()
    is_p = lambda x: isinstance(x, P)    # noqa: E731
    leaves = jax.tree.leaves(ps)
    total = sum(_jax_bytes(NamedSharding(am, s), lf) for s, lf in zip(
        jax.tree.leaves(JSH.param_specs(ps, am), is_leaf=is_p), leaves))
    specs = j_input_specs(cfg, cell)
    if cell.kind == "train":
        o = j_opt_specs(ps, am)
        for part in (o.mu, o.nu, o.master):
            total += sum(math.prod(NamedSharding(am, s).shard_shape(
                lf.shape)) * 4 for s, lf in zip(
                jax.tree.leaves(part, is_leaf=is_p), leaves))
    if cell.kind == "decode":
        if cfg.encoder_decoder:
            cache = model.init_cache(cell.global_batch,
                                     cfg.decoder_target_len, zeros=False,
                                     cross_len=cell.seq_len)
        else:
            cache = model.init_cache(cell.global_batch, cell.seq_len,
                                     zeros=False)
        sh = jd._cache_shardings(cfg, cell, am, cache)
        total += sum(_jax_bytes(s, lf) for s, lf in zip(
            jax.tree.leaves(sh, is_leaf=lambda x: isinstance(
                x, NamedSharding)), jax.tree.leaves(cache)))
    for k, s in specs.items():
        spec = P() if k == "pos" else JSH.batch_spec(am, s.shape[0],
                                                     len(s.shape) - 1)
        total += _jax_bytes(NamedSharding(am, spec), s)
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_jax_s_shard_bytes(arch):
    cfg = get_config(arch)
    model = TS.build_model(cfg, device="meta")
    for shape in ("train_4k", "decode_32k", "long_500k"):
        if D.cell_supported(arch, shape):
            continue
        for multi in (False, True):
            got = D.argument_bytes(model, cfg, TC.SHAPES[shape],
                                   make_production_mesh(multi))
            assert got == _jax_argument_bytes(arch, shape, multi), (
                shape, multi)


# --------------------------------------------------------------------------- #
# Tracing.
# --------------------------------------------------------------------------- #
def test_traced_peak_counts_each_storage_once_and_frees_it():
    def fn():
        a = torch.empty(1000, device="meta")            # 4,000 B
        b = a.view(10, 100)[:5]                         # a view: nothing
        c = a * 2                                       # 4,000 B
        del a, b
        d = torch.empty(250, dtype=torch.float64,
                        device="meta")                  # 2,000 B
        return c, d

    costs = OA.analyze(fn)
    assert costs.peak_bytes == 8000
    assert costs.hbm_bytes == 8000                      # c's read + write
    assert costs.flops == 0 and costs.unknown_trip_whiles == 0


def test_ring_scaling_is_jax_s():
    from repro.launch.hlo_analysis import analyze as j_analyze
    size, n = 4096, 8
    for op, kind in [("all-reduce", "all-reduce"),
                     ("all-gather", "all-gather"),
                     ("reduce-scatter", "reduce-scatter"),
                     ("all-to-all", "all-to-all"),
                     ("collective-permute", "collective-permute")]:
        hlo = ("ENTRY %main (p: f32[1024]) -> f32[1024] {\n"
               "  %p = f32[1024] parameter(0)\n"
               f"  ROOT %c = f32[1024] {op}(%p), "
               "replica_groups={{0,1,2,3,4,5,6,7}}\n}\n")
        j = j_analyze(hlo, n).collective_bytes[kind]
        assert OA.ring_bytes(kind, size, n) == j, kind


def _flash_recorder(monkeypatch):
    calls = []
    real = ops.flash_attention

    def rec(q, k, v, causal=True, window=0):
        calls.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2]))
        return real(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention", rec)
    return calls


@pytest.mark.parametrize("arch,remat", [("qwen3-0.6b", "full"),
                                        ("gemma3-12b", "none")])
def test_traced_flops_are_flop_counter_s_apart_from_the_kernel_formulas(
        arch, remat, monkeypatch):
    """On meta the flash wrapper counts its kernel's formula (the pairs
    its causal / window skip keeps); on the CPU it runs the plain version,
    whose two products FlopCounterMode counts over all Tq x Tk pairs.
    Everything else is the same count."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              remat=remat)
    cell = TC.ShapeCell("s", 32, 4, "train")
    m = TS.build_model(cfg, device="meta")
    m, opt = TS.init_train_state(m)
    costs = OA.analyze(TS.make_train_step(m, cfg), m, opt,
                       TS.input_specs(cfg, cell))
    real = TS.build_model(cfg, device="cpu")
    real, ropt = TS.init_train_state(real)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32)
             for k in ("tokens", "labels")}
    calls = _flash_recorder(monkeypatch)
    with FlopCounterMode(display=False) as fc:
        TS.make_train_step(real, cfg)(real, ropt, batch)
    plain = sum(4.0 * bh * tq * tk * d for bh, tq, tk, d in calls)
    assert calls and costs.kernel_flops["flash_attention"] < plain
    assert costs.flops - costs.kernel_flops["flash_attention"] == \
        fc.get_total_flops() - plain


def test_smoke_cells_trace_on_meta_and_report_like_jax(tmp_path,
                                                       monkeypatch):
    recs = []
    rec = D.analyze_cell(get_smoke_config("qwen3-0.6b"),
                         TC.ShapeCell("train_s", 32, 32, "train"),
                         make_production_mesh(),
                         {"arch": "qwen3-0.6b", "shape": "train_s",
                          "mesh": "single", "status": "ok"})
    recs.append(rec)
    mem = rec["memory"]
    assert mem["temp_bytes"] > 0 and mem["alias_bytes"] > 0
    assert mem["per_device_total"] == (mem["argument_bytes"]
                                       + mem["output_bytes"]
                                       + mem["temp_bytes"]
                                       - mem["alias_bytes"])
    coll = rec["analysis"]["collective_bytes_per_device"]
    assert coll["reduce-scatter"] == coll["all-gather"] > 0
    assert coll["all-reduce"] > 0
    rec = D.analyze_cell(get_smoke_config("kimi-k2-1t-a32b"),
                         TC.ShapeCell("prefill_s", 16, 4, "prefill"),
                         make_local_mesh(2, 4, ["meta"] * 8),
                         {"arch": "kimi-k2-1t-a32b", "shape": "prefill_s",
                          "mesh": "local", "status": "ok"})
    assert rec["analysis"]["collective_bytes_per_device"]["all-to-all"] > 0
    recs.append(rec)
    rec = D.analyze_cell(get_smoke_config("whisper-base"),
                         TC.ShapeCell("decode_s", 64, 32, "decode"),
                         make_production_mesh(True),
                         {"arch": "whisper-base", "shape": "decode_s",
                          "mesh": "multi", "status": "ok"})
    assert rec["memory"]["alias_bytes"] > 0
    recs.append(rec)
    recs.append({"arch": "x", "shape": "long_500k", "mesh": "single",
                 "skipped": D.cell_supported("granite-8b", "long_500k")})
    recs.append({"arch": "y", "shape": "train_4k", "mesh": "single",
                 "status": "error"})
    for r in recs:
        assert R.fmt_row(r) == JR.fmt_row(r)
        if "kind" in r:
            assert R.model_flops(r) == JR.model_flops(r)
            assert r["roofline"]["dominant"] in ("compute_s", "memory_s",
                                                 "collective_s")
    # The CLI writes artifacts the report reads (never JAX's directory).
    assert os.path.normpath(D.ART_DIR).endswith(
        os.path.join("artifacts", "dryrun_torch"))
    monkeypatch.setattr(D, "ART_DIR", str(tmp_path))
    D.main(["--arch", "whisper-base", "--shape", "decode_32k",
            "--mesh", "single"])
    D.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
            "--mesh", "single"])
    got = json.load(open(tmp_path / "whisper-base__decode_32k__single.json"))
    assert got["status"] == "ok" and got["n_devices"] == 256
    table = R.report(str(tmp_path))
    assert "| whisper-base | decode_32k |" in table
    assert "skip: pure full-attention arch" in table
