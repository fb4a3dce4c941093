"""The port's tutorials (``docs/tutorials_torch``) and its scale ladder.

Each tutorial runs on the CPU in a fresh interpreter through
``tools/build_tutorials_torch.py --device cpu``, with every assert of
its cells, and must load no module of JAX or of the JAX package; then
the JAX tutorial and the port's run in this process on the same numpy
seed, both in single precision (the JAX package's quantum-jump batch on
its row-batched kernel, interpreted), and the values of
``KEY_VALUES`` must agree: states to 1 − F ≤ 1e-6, density matrices and
populations within 1e-6, seeded counts equal. The XY tutorial's lab
frame reaches 9.99e-07 on its occupations, the largest of these gaps.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tools import build_tutorials_torch as B
from tools import scale_ladder_torch as L
from tools import tutorial_references as R

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = B.names()
REFERENCE = os.path.join(ROOT, "tests", "goldens", "tutorials_reference.json")

#: Parity limits by kind of key value.
PARITY_TOL = {"state": 1e-6, "rho": 1e-6, "populations": 1e-6, "counts": 0.0,
              "exact": 0.0}

_WRAPPER = """
import json, runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print(json.dumps(sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "pulser_tpu")
)))
"""


def test_six_tutorials_mirror_the_jax_package():
    from tools import build_tutorials

    jax_names = sorted(
        os.path.splitext(f)[0]
        for f in os.listdir(build_tutorials.SRC)
        if f.endswith(".py")
    )
    assert NAMES == jax_names and len(NAMES) == 6
    assert sorted(B.KEY_VALUES) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_tutorial_runs_on_the_cpu_without_jax(name, tmp_path):
    """Every cell and assert, in a fresh interpreter; the page and at
    least one figure are written, and no JAX module was loaded."""
    script = os.path.join(ROOT, "tools", "build_tutorials_torch.py")
    out = subprocess.run(
        [sys.executable, "-c", _WRAPPER, script, "--device", "cpu",
         "--out", str(tmp_path), name],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    with open(tmp_path / f"{name}.md") as f:
        page = f.read()
    assert "```python" in page and "torch_device=DEVICE" in page
    assert os.listdir(tmp_path / "figs"), "no figure written"


_NO_MATPLOTLIB = """
import os, sys
sys.modules["matplotlib"] = None
from tools import build_tutorials_torch as B
out = sys.argv[1]
for name in B.names():
    B.execute(name, "cpu", out)
assert sys.modules["matplotlib"] is None
assert "matplotlib.pyplot" not in sys.modules
assert not os.listdir(os.path.join(out, "figs"))
print(len(os.listdir(out)))
"""


def test_tutorials_run_without_matplotlib(tmp_path):
    """As on the card's machine: with matplotlib absent every cell and
    assert runs on the inert stand-in, no figure is written, and the
    stand-in leaves ``sys.modules`` afterwards."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_MATPLOTLIB, str(tmp_path)],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == [str(len(NAMES) + 1)]  # the pages, figs/


@pytest.fixture
def jax_single_precision(monkeypatch):
    """The JAX package as ``tools/tutorial_references.py`` runs it."""
    for key, value in R.JAX_ENV.items():
        monkeypatch.setenv(key, value)
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("name", NAMES)
def test_tutorial_matches_the_jax_package(name, jax_single_precision):
    np.random.seed(R.SEED)
    want = B.KEY_VALUES[name](R.jax_namespace(name))
    np.random.seed(R.SEED)
    got = B.KEY_VALUES[name](B.execute(name, "cpu"))
    assert got.keys() == want.keys()
    for key, (kind, value) in want.items():
        err = B.difference(kind, value, got[key][1])
        assert err <= PARITY_TOL[kind], (key, kind, err)
    # The card's reference values are this run of the JAX tutorial
    with open(REFERENCE) as f:
        ref = B.decode(json.load(f)["tutorials"][name])
    assert ref.keys() == want.keys()
    for key, (kind, value) in want.items():
        assert B.difference(kind, value, ref[key][1]) <= 1e-12, key


def test_committed_pages_exist():
    for name in NAMES:
        page = os.path.join(B.OUT, name + ".md")
        assert os.path.exists(page), f"build_tutorials_torch.py {name}"
    with open(os.path.join(B.OUT, "README.md")) as f:
        readme = f.read()
    for name in NAMES:
        assert f"({name}.md)" in readme


def test_without_a_card_the_first_emulator_raises():
    """No fallback: with ``DEVICE = "cuda"`` and no card, the port's own
    error leaves ``execute`` unchanged."""
    with pytest.raises(RuntimeError, match="No CUDA device is visible"):
        B.execute("04_eom_mode", "cuda")


def test_scale_ladder_run_size_on_the_cpu(monkeypatch):
    """``run_size`` at 8 atoms: the norm holds, the FLOP count is
    ``bench.solve_telemetry``'s on the same ``last_solve_info``, and the
    peak is held to ``capacity.solve_bytes``."""
    import bench
    from pulser_tpu.ops import solver as jax_solver

    from pulser_tpu_torch.parallel import capacity

    calls = []
    solve_bytes = capacity.solve_bytes

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return solve_bytes(*args, **kwargs)

    monkeypatch.setattr(capacity, "solve_bytes", recording)
    rec = L.run_size(8, "cpu", warm_runs=1)
    assert rec["solver_kind"] == "sesolve_torch_loop"
    assert abs(rec["norm"] - 1) <= L.NORM_TOL
    assert rec["peak_bytes"] is None  # not measured on the CPU
    assert calls == [((2, 8), {"n_eval": 2})]
    assert rec["solve_bytes"] == solve_bytes(2, 8, n_eval=2)
    info = {
        "kind": "sesolve_xla_scan",
        "n_steps": rec["n_steps"],
        "dim": 2**8,
        "n": 8,
    }
    monkeypatch.setattr(jax_solver, "last_solve_info", info)
    # bench rounds to 1e-3 TFLOP/s: over 1e-12 s that is one FLOP
    want = bench.solve_telemetry(1e-12)["achieved_tflops_per_s"]
    assert L.solve_flops({**info, "kind": L.LADDER_KIND}) == want
    assert rec["telemetry"]["flops"] == want
    state = rec["state"]
    assert state.shape == (2**8,)
    assert abs(float(torch.linalg.vector_norm(state)) - 1) < 1e-6


def test_capacity_ceiling_solve_is_admitted(monkeypatch):
    """The two faults the ladder found in the capacity contract on an
    H100 80GB HBM3 (85 017 493 504 B measured). The ceiling run:
    ``single_chip_ceiling`` promised 29 qubits while ``check_capacity``
    refused that solve with its two evaluation states (148 B an
    amplitude modelled, 116 measured). The 20-atom card test: a peak of
    478 782 976 B against a modelled 130 023 424 B, the torch loop's
    staged chunk of steps uncounted. The ceiling solve is now admitted,
    and the model covers every measured peak of the ladder's solves and
    of a state-sharded rank."""
    from pulser_tpu_torch.parallel import capacity

    mem = 85_017_493_504
    monkeypatch.setattr(capacity, "measured_memory_bytes", lambda *a: mem)
    n = capacity.single_chip_ceiling(2, mem)
    assert n == 29
    capacity.check_capacity(2, n, n_eval=2, what="ceiling")
    with pytest.raises(capacity.CapacityError):
        capacity.check_capacity(2, n + 1, n_eval=2)
    for qubits, peak in (
        (20, 478_782_976),
        (24, 1_984_468_480),
        (25, 3_893_042_688),
        (26, 7_785_653_248),
        (29, 62_279_824_384),
    ):
        assert peak <= capacity.solve_bytes(2, qubits, n_eval=2), qubits
        assert peak <= capacity.solve_bytes(2, qubits), qubits
    # SHARD_STATE24: a rank of 2 held 1 077 313 536 B for its 2^23 share
    assert 2 * 1_077_313_536 <= capacity.solve_bytes(2, 24, n_eval=2)
