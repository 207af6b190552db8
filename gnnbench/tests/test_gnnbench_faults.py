"""The rest of a run, on the CPU, with the timed path broken underneath:
each fault a served cell can have must turn ``correct`` false."""
import time

import pytest
import torch

from gnnbench.harness import runner, serve
from gnnbench.tests import tiny


def altered(orig):
    """One answer altered where it is produced: lane 0's first entry of
    every pass moved by a thousandth of the output's largest entry."""
    def run_batch(self, prog, xs, *a, **kw):
        ys = orig(self, prog, xs, *a, **kw).clone()
        ys[0, 0, 0] += 1e-3 * float(ys.abs().max())
        return ys
    return run_batch


def half_left_out(orig):
    """Half of the batch left out: the upper lanes get lane 0's answer."""
    def run_batch(self, prog, xs, *a, **kw):
        n = int(xs.shape[0])
        ys = orig(self, prog, xs[: max(n // 2, 1)], *a, **kw)
        return torch.cat([ys, ys[:1].expand(n - ys.shape[0], -1, -1)])
    return run_batch


def state_unchanged(orig):
    """A pass that hands back the previous pass's output unchanged."""
    last = {}

    def run_batch(self, prog, xs, *a, **kw):
        ys = orig(self, prog, xs, *a, **kw)
        prev = last.get(tuple(xs.shape))
        last[tuple(xs.shape)] = ys
        return ys if prev is None else prev
    return run_batch


@pytest.mark.parametrize("fault", [altered, half_left_out, state_unchanged])
@pytest.mark.parametrize("config", ["gcn-b2-flickr", "gatdot-flickr"])
def test_fault_turns_correct_false(monkeypatch, fault, config):
    from repro_torch.engine.executor import BinaryExecutor
    monkeypatch.setattr(BinaryExecutor, "run_batch",
                        fault(BinaryExecutor.run_batch))
    cell = tiny.cell(config)
    r = runner.run_cell(cell, 11, 0.5, False, time.perf_counter(),
                        device="cpu")
    assert r["correct"] is False
    assert r["checks"]["out_err"]["value"] > r["checks"]["out_err"]["limit"]


@pytest.mark.parametrize("config", ["gcn-b2-flickr", "gatdot-flickr"])
def test_unanswered_request_turns_correct_false(monkeypatch, config):
    """A pass that never returns its answer: the request counts as
    failed and the run is not correct."""
    from repro_torch.runtime import ServeLoop
    monkeypatch.setattr(serve, "DRAIN_S", 0.5)
    cell = tiny.cell(config)
    calls = {"n": 0}
    orig = ServeLoop._execute

    def execute(self, batch, overlay):
        # The window's second batch (warm passes carry request id -1).
        if batch.requests[0].request_id != "-1":
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("planted: a lost batch")
        return orig(self, batch, overlay)
    monkeypatch.setattr(ServeLoop, "_execute", execute)
    r = runner.run_cell(cell, 11, 0.5, False, time.perf_counter(),
                        device="cpu")
    assert r["failed"] > 0 and r["correct"] is False
