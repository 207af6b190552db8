"""Whole runs on the CPU at a 300-vertex graph (the harness's look for a
card skipped), the result line's keys, and the CLI's refusals."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from gnnbench.harness import runner, spec
from gnnbench.tests import tiny

ROOT = spec.ROOT
CELLS = [("gcn-b2-flickr", "resident"), ("gatdot-flickr", "resident"),
         ("gcn-b2-flickr", "hostsend")]


def run_tiny(config, traffic, trace=False, seed=3, seconds=1.5):
    cell = tiny.cell(config, traffic)
    return cell, runner.run_cell(cell, seed, seconds, trace,
                                 time.perf_counter(), device="cpu")


@pytest.mark.parametrize("config,traffic", CELLS)
def test_sound_run_is_correct_and_line_has_the_contract_keys(config,
                                                             traffic):
    cell, r = run_tiny(config, traffic)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= cell.traffic["clients"]
    names = {m["name"] for m in cell.end_to_end}
    assert set(r["metrics"]) == names
    for m in cell.end_to_end:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
        assert r["metrics"][m["name"]]["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert r["checks"]["out_err"]["value"] <= r["checks"]["out_err"]["limit"]
    line = json.loads(json.dumps(r))
    assert line == r


def test_traced_run_reports_per_layer_metrics_it_can_read():
    cell, r = run_tiny("gcn-b2-flickr", "resident", trace=True)
    # The CPU has no device trace, no peak and no replays: those readers
    # find nothing.
    assert set(r["metrics"]) == {"queue_wait_ms", "batch_size_mean",
                                 "t_loh_ms", "compile_ms"}
    assert 1.0 <= r["metrics"]["batch_size_mean"]["value"] <= 4.0
    assert r["correct"] is True


def test_same_seed_gives_same_inputs():
    from gnnbench.harness import inputs
    cell = tiny.cell("gatdot-flickr")
    a = inputs.make(cell.config, cell.traffic, cell.family, 2**31 + 9, "cpu")
    b = inputs.make(cell.config, cell.traffic, cell.family, 2**31 + 9, "cpu")
    assert all((wa == wb).all() for (wa, _), (wb, _) in
               zip(a.linears, b.linears))
    assert (a.features == b.features).all()
    assert [a.order.integers(0, 8) for _ in range(20)] == \
        [b.order.integers(0, 8) for _ in range(20)]


def _cli(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "gnnbench/run.py", "--workload",
         "gcn-b2-flickr.resident", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_cli_without_a_card_prints_no_result():
    p = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_cli_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "gnnbench"), tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path, {})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert runner.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert runner.banned_modules() == ["jax"]
