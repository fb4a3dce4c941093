"""The benchmark's pieces on their own: the traffic's draws, the count of
the work, the reference's random numbers, what a run may import, and
that a piece is found by its name."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gpubench.harness import spec, traffic
from gpubench.reference import rydberg as R
from gpubench.tests import _cells

HARNESS = os.path.join(_cells.REPO, "gpubench")
FORBIDDEN = {"jax", "jaxlib", "flax", "pulser_tpu"}


def _traffic(name):
    with open(os.path.join(HARNESS, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _picked(tr, seed, n_done):
    sample = traffic.CheckSample(tr, seed)
    for job in traffic.first(tr, seed, n_done):
        sample.offer(job, {"index": job["index"]})
    return [j["index"] for j in sample.picked()]


@pytest.mark.parametrize("name", ["sweep", "observables"])
def test_draws_repeat_for_one_seed(name):
    tr = _traffic(name)
    seed = 2**31 + 99
    assert traffic.first(tr, seed, 200) == traffic.first(tr, seed, 200)
    assert _picked(tr, seed, 57) == _picked(tr, seed, 57)
    other = traffic.first(tr, seed + 1, 200)
    assert other != traffic.first(tr, seed, 200)


@pytest.mark.parametrize("n_done", [1, 3, 57])
def test_the_check_sample_keeps_the_last_job_and_draws_the_rest_evenly(n_done):
    tr = {"check_jobs": 4}
    counts = np.zeros(n_done)
    for seed in range(2**31, 2**31 + 600):
        picked = _picked(tr, seed, n_done)
        assert picked[-1] == n_done - 1
        assert len(picked) == min(4, n_done) == len(set(picked))
        assert picked == sorted(picked)
        counts[picked[:-1]] += 1
    if n_done > 4:
        # each earlier job is kept with probability 3 / (n_done - 1)
        want = 600 * 3 / (n_done - 1)
        assert abs(counts[:-1].mean() - want) < 1e-9
        assert counts[:-1].min() > 0.4 * want and counts[:-1].max() < 1.8 * want


def test_every_seed_draws_the_same_set_of_work():
    tr = _traffic("sweep")
    k = tr["strata"]
    sets = [
        sorted(tuple(sorted(j["params"].items())) for j in traffic.first(tr, s, k))
        for s in (1, 2**31 + 5)
    ]
    assert sets[0] == sets[1]
    # The first draw by name takes the stratum midpoints, the others a
    # lattice over the same range
    for i, name in enumerate(sorted(tr["draws"])):
        v = np.array([p[i][1] for p in sets[0]])
        lo, hi = tr["draws"][name]
        assert lo < v.min() and v.max() < hi
        assert abs(v.mean() - (lo + hi) / 2) < (hi - lo) / k
    midpoints = np.sort([p[0][1] for p in sets[0]])
    lo, hi = tr["draws"][sorted(tr["draws"])[0]]
    np.testing.assert_allclose(midpoints, lo + (hi - lo) * (np.arange(k) + 0.5) / k)


def test_work_count_matches_a_hand_count():
    cfg = {
        "register": {"coords_um": [[0.0, 0.0], [6.0, 0.0]]},
        "pulses": [{"duration": 3, "amplitude": ["ConstantWaveform", 1.0],
                    "detuning": ["ConstantWaveform", 0.0]}],
        "evaluation_times": 2,
    }
    work = spec.load_module(_cells.REPO, "work", "afm16").count(cfg, {})
    # 2 atoms, 3 samples, the end one ns after the last: RK4 steps at
    # 0-1-2-3 ns (3 steps); per amplitude and step 4 x (2 x 4 + 4) + 28
    # = 76 flops, 4 amplitudes
    assert work["flops"] == 76 * 4 * 3
    # in: the state (4 x 8 B) and 4 samples of 2 float32 streams; out: the
    # state at 2 times
    assert work["bytes"] == 4 * 8 * 3 + 2 * 4 * 4


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(HARNESS, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(HARNESS, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = (
                [a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom)
                else []
            )
            for m in mods:
                top = m.split(".")[0]
                assert top not in FORBIDDEN | {"pulser_tpu_torch"}, (name, m)
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench.harness import spec\n"
        "for n in ('afm16',):\n"
        "    spec.load_module(%r, 'reference', n)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (_cells.REPO, _cells.REPO)
    loaded = eval(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True
    ).stdout)
    assert not set(loaded) & (FORBIDDEN | {"pulser_tpu_torch"})


def test_a_run_loads_no_jax(tmp_path):
    """Everything a run loads, in a fresh interpreter: one traced run of
    each entry on the CPU, then the process's modules."""
    root = _cells.small_root(str(tmp_path))
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench.tests import _cells\n"
        "for w in ('afm16.sweep', 'afm16.observables'):\n"
        "    rc, line, err = _cells.run_cell(%r, w, seconds=0.2, trace=1)\n"
        "    assert rc == 0, err\n"
        "import gpubench.control\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (_cells.REPO, root)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "pulser_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def _add_metric(root, name, source):
    with open(os.path.join(root, "gpubench", "metrics", f"{name}.py"), "w") as f:
        f.write(source)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": name, "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "sequence", "moves": "jobs_per_s",
        "workloads": ["afm16.sweep"],
    })
    with open(path, "w") as f:
        json.dump(bench, f)


def test_an_added_metric_file_is_picked_up(tmp_path):
    root = _cells.small_root(str(tmp_path))
    _add_metric(root, "jobs_in_window", "def read(w):\n    return float(w.jobs)\n")
    rc, line, err = _cells.run_cell(root, "afm16.sweep", seconds=0.5, trace=1)
    assert rc == 0, err
    assert line["metrics"]["jobs_in_window"]["value"] >= 1


def test_a_piece_that_loads_jax_leaves_no_result(tmp_path):
    """A metric's reader, added as a later change would add it, that
    imports JAX: the run names it, exits 3 and prints no result."""
    root = _cells.small_root(str(tmp_path))
    _add_metric(root, "with_jax", "import jax\n\n\ndef read(w):\n    return 1.0\n")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from gpubench.tests import _cells\n"
        "rc, line, err = _cells.run_cell(%r, 'afm16.sweep', seconds=0.2, trace=1)\n"
        "print(rc, len(line), repr(err[-300:]))\n"
    ) % (_cells.REPO, root)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    rc, n_keys, err = out.stdout.strip().splitlines()[-1].split(" ", 2)
    assert (rc, n_keys) == ("3", "0")
    assert "forbidden modules loaded: jax" in err


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and the harness: no result."""
    root = tmp_path / "bare"
    shutil.copytree(HARNESS, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(_cells.REPO, "BENCHMARK.json"), root)
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "afm16.sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_the_register_and_the_samples_are_the_programs():
    """The configuration's atoms are the tutorial's square at the blockade
    radius of U, and the reference's samples are the program's."""
    import pulser_tpu_torch as P

    from gpubench.harness import sequence

    with open(os.path.join(HARNESS, "configs", "afm16.json")) as f:
        cfg = json.load(f)
    u = 2 * np.pi * cfg["constants"]["u_2pi"]
    np.testing.assert_allclose(
        cfg["values_2pi"]["omega_max"] / 2.3, cfg["constants"]["u_2pi"]
    )
    assert P.MockDevice.interaction_coeff == cfg["constants"]["c6_rad_um6_per_us"]
    square = P.Register.square(
        4, spacing=P.MockDevice.rydberg_blockade_radius(u), prefix="q"
    )
    reg = sequence.register(P, cfg["register"])
    for built in (reg, square):
        np.testing.assert_allclose(
            np.array([q.as_array() for q in built.qubits.values()]),
            R.register_coords(cfg["register"]), atol=1e-12,
        )
    seq = sequence.sequence(P, cfg)
    ch = P.sample(seq).channel_samples["ch"]
    amp, det = R.pulse_samples(cfg["pulses"], R.values_of(cfg, {}), _cells.REPO)
    np.testing.assert_allclose(np.asarray(ch.amp), amp, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ch.det), det, atol=1e-12)


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "afm16.sweep",
         "--seed", "3", "--seconds", "2", "--trace", "0"],
        cwd=_cells.REPO, capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
