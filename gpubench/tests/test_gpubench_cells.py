"""The harness end to end on the CPU, at 2 x 3 atoms: the program's CPU
path against the plain reference, the shape of the last line, and the
checks that must come out false (the control and planted faults)."""

import dataclasses
import json

import numpy as np
import pytest

from gpubench.tests import _cells


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _cells.small_root(str(tmp_path_factory.mktemp("gpubench")))


CELLS = ["afm16.sweep", "afm16.observables"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_program(root, workload):
    rc, line, err = _cells.run_cell(root, workload)
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    for name, r in line["checks"].items():
        assert r["value"] <= r["limit"], name


def _bench(root):
    with open(f"{root}/BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_shape(root, workload, trace):
    rc, line, _ = _cells.run_cell(root, workload, trace=trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = _bench(root)
    metrics = bench["per_layer"] if trace else bench["end_to_end"]
    units = {m["name"]: m["unit"] for m in metrics}
    for name, m in line["metrics"].items():
        assert units[name] == m["unit"]
        assert isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        # A CPU run has no device events: the device's readers stay silent
        assert "solve_roofline_pct" not in line["metrics"]
    else:
        want = {m["name"] for m in metrics
                if workload in m.get("workloads", [workload])}
        assert set(line["metrics"]) == want


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(root, workload):
    """The reference in bfloat16, in the program's place, is not correct."""
    from gpubench.control import readings

    r = readings(root, workload, seed=2**31 + 7, device="cpu")
    assert any(v["value"] > v["limit"] for v in r.values()), r


def _unchanged_steps(monkeypatch):
    """Every RK4 step of the program's solve leaves its state as it was
    (the steps' lengths are zero)."""
    from pulser_tpu_torch.ops import solver

    orig = solver.sesolve_rk4

    def broken(psi0, plan, *a, **k):
        plan = dataclasses.replace(plan, seg_dts=np.zeros_like(plan.seg_dts))
        return orig(psi0, plan, *a, **k)

    monkeypatch.setattr(solver, "sesolve_rk4", broken)


def _altered_draws(monkeypatch):
    """Every shot of every draw is moved to the next outcome."""
    import pulser_tpu_torch.result as result
    from pulser_tpu_torch.emulator import torch_state

    orig = result.multinomial

    def broken(n, probs):
        draws = np.array(orig(n, probs))
        draws = (draws + 1) % len(probs)
        return draws

    monkeypatch.setattr(result, "multinomial", broken)
    monkeypatch.setattr(torch_state, "multinomial", broken)


FAULTS = {"unchanged": _unchanged_steps, "altered": _altered_draws}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch)
    rc, line, err = _cells.run_cell(root, workload)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
