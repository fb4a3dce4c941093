"""The port's phase timing and tracing against the JAX package's.

``pulser_tpu_torch/profiling.py`` keeps ``pulser_tpu/profiling.py``'s
registry (lock-guarded wall-clock totals and call counts per phase) and
marks each phase with ``torch.profiler.record_function``. The emulator's
phases carry the JAX package's names: for the same scenario both
packages report the same set of phases, where a route differs by design
the test names the difference.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import pulser_tpu
import pulser_tpu.emulator
import pulser_tpu.profiling
import pulser_tpu_torch
import pulser_tpu_torch.emulator
from pulser_tpu_torch import profiling

torch.set_num_threads(1)


def test_profiling_phases_recorded():
    """Phase timings accumulate around emulator solves and annotate
    traces; the report exposes totals and call counts (the counterpart
    of ``tests/test_emulator.py::test_profiling_phases_recorded``)."""
    profiling.reset_phases()
    reg = pulser_tpu_torch.Register({"q0": (0, 0), "q1": (0, 8)})
    seq = pulser_tpu_torch.Sequence(reg, pulser_tpu_torch.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(pulser_tpu_torch.Pulse.ConstantPulse(200, 1.0, 0.0, 0.0), "ryd")
    from pulser_tpu_torch.emulator.simulation import TorchEmulator

    TorchEmulator.from_sequence(seq, torch_device="cpu").run()
    report = profiling.phase_report()
    assert report["emulator.build_plan"]["calls"] >= 1
    assert report["emulator.sesolve"]["total_s"] > 0
    profiling.reset_phases()
    assert profiling.phase_report() == {}


def test_nested_phases_and_reset():
    profiling.reset_phases()
    with profiling.phase("outer"):
        for _ in range(3):
            with profiling.phase("inner"):
                time.sleep(0.002)
    report = profiling.phase_report(reset=True)
    assert report["outer"]["calls"] == 1.0
    assert report["inner"]["calls"] == 3.0
    assert report["inner"]["total_s"] >= 0.006
    assert report["outer"]["total_s"] >= report["inner"]["total_s"]
    assert profiling.phase_report() == {}


def test_phase_records_when_the_block_raises():
    profiling.reset_phases()
    with pytest.raises(ValueError):
        with profiling.phase("failing"):
            raise ValueError("inside")
    assert profiling.phase_report(reset=True)["failing"]["calls"] == 1.0


def test_phases_from_threads_all_count():
    """The registry is shared and lock-guarded: phases timed in more
    threads than cores, switching as often as the interpreter allows, all
    land in it (a lost update would lose a call)."""
    profiling.reset_phases()
    n_threads, n_calls = 16, 200
    barrier = threading.Barrier(n_threads)

    def work(i: int) -> None:
        barrier.wait()
        for _ in range(n_calls):
            with profiling.phase("shared"):
                with profiling.phase(f"own{i}"):
                    pass

    threads = [
        threading.Thread(target=work, args=(i,)) for i in range(n_threads)
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    report = profiling.phase_report(reset=True)
    assert report["shared"]["calls"] == n_threads * n_calls
    for i in range(n_threads):
        assert report[f"own{i}"]["calls"] == n_calls


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    from pulser_tpu_torch.emulator import TorchEmulator

    seq = _seq(pulser_tpu_torch)
    with profiling.trace(str(tmp_path), device="cpu"):
        TorchEmulator.from_sequence(seq, torch_device="cpu").run()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "emulator.sesolve" in names
    assert "emulator.build_plan" in names


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_trace_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="No CUDA device is visible"):
        with profiling.trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()


# -- the same scenario through both packages ------------------------------


def _seq(P):
    reg = P.Register.rectangle(1, 3, spacing=8.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(
        P.Pulse.ConstantDetuning(P.BlackmanWaveform(500, np.pi), -2.0, 0.0),
        "ryd",
    )
    return seq


def _noiseless(P):
    return {}


def _jumps(P):
    """Dephasing with shot-to-shot noise: the batched quantum jumps."""
    return dict(
        noise_model=P.NoiseModel(
            dephasing_rate=0.05, amp_sigma=0.02, runs=5, samples_per_run=2
        ),
        evaluation_times="Minimal",
    )


def _pure_batch(P):
    """Shot-to-shot noise without collapse operators: the pure-state
    batch."""
    return dict(
        noise_model=P.NoiseModel(
            amp_sigma=0.02, p_false_pos=0.01, runs=5, samples_per_run=2
        ),
        evaluation_times="Minimal",
    )


def _mesolve(P):
    """Dephasing alone: the master equation of one density matrix."""
    return dict(noise_model=P.NoiseModel(dephasing_rate=0.1))


#: The phases the port marks at each layer boundary a run crosses and the
#: JAX package leaves unmarked: the sampling, the emulator's construction
#: and its Hamiltonian data, the whole ``run()``, the draws of the shots.
LAYER_PHASES = {
    "emulator.sample_sequence",
    "emulator.init",
    "emulator.hamiltonian_data",
    "emulator.run",
    "results.sample",
}
#: The one-solve path also marks its step policy and result wrapping
#: under the names the noisy batches use, and the fetch of its states
ONE_SOLVE = {"emulator.step_policy", "emulator.wrap_results", "results.fetch"}
#: The pure-state trajectory batch: its plan and the steps before it,
#: and the tally of its shots into counts
PURE_BATCH = {
    "emulator.build_plan_batched",
    "emulator.noise_trajectories",
    "emulator.traj_draw",
    "emulator.coeff_batch",
    "emulator.step_policy",
    "emulator.counts",
}

#: (scenario, emulator options as a function of the package namespace,
#: phases only the port reports beyond LAYER_PHASES, with why)
SCENARIOS = [
    ("noiseless", _noiseless, ONE_SOLVE),
    ("noisy_jumps", _jumps, set()),
    # The port times the pure-state batch's plan, its noise draws and
    # step policy as both packages time the quantum-jump batch's; the JAX
    # package leaves them unmarked. The port draws this batch's shots
    # without wrapping its states into results
    ("noisy_pure_batch", _pure_batch, PURE_BATCH),
    ("mesolve", _mesolve, ONE_SOLVE),
]


def _phases(P, prof, emulator_cls, options, device_kw) -> set[str]:
    prof.reset_phases()
    np.random.seed(7)
    emu = emulator_cls.from_sequence(_seq(P), **options(P), **device_kw)
    with warnings.catch_warnings():
        # A noisy run's results resample their counts, and say so
        warnings.simplefilter("ignore", UserWarning)
        emu.run().sample_final_state(100)
    return set(prof.phase_report(reset=True))


@pytest.mark.parametrize(
    "options,port_only", [s[1:] for s in SCENARIOS], ids=[s[0] for s in SCENARIOS]
)
def test_phase_names_equal_the_jax_packages(monkeypatch, options, port_only):
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    want = _phases(
        pulser_tpu,
        pulser_tpu.profiling,
        pulser_tpu.emulator.TpuEmulator,
        options,
        {},
    )
    got = _phases(
        pulser_tpu_torch,
        profiling,
        pulser_tpu_torch.emulator.TorchEmulator,
        options,
        {"torch_device": "cpu"},
    )
    assert want and all(
        name.split(".")[0] in ("emulator", "results") for name in got
    )
    assert got - port_only - LAYER_PHASES == want
    assert port_only | LAYER_PHASES <= got


# -- self time, counters, and the phases and reads of one job ---------------


def test_self_time_of_nested_phases():
    """A phase's self time is its total less the totals of the phases
    opened inside it on the same thread; a grandchild counts in its parent
    only, and a phase of another thread in none."""
    profiling.reset_phases()

    def elsewhere() -> None:
        with profiling.phase("other"):
            time.sleep(0.02)

    other = threading.Thread(target=elsewhere)
    with profiling.phase("outer"):
        time.sleep(0.002)
        for _ in range(2):
            with profiling.phase("inner"):
                time.sleep(0.002)
                with profiling.phase("leaf"):
                    time.sleep(0.002)
        with profiling.phase("side"):
            other.start()
            other.join()
    report = profiling.phase_report(reset=True)
    outer, inner = report["outer"], report["inner"]
    leaf, side = report["leaf"], report["side"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"] - side["total_s"], abs=1e-12
    )
    assert inner["self_s"] == pytest.approx(
        inner["total_s"] - leaf["total_s"], abs=1e-12
    )
    assert leaf["self_s"] == leaf["total_s"] >= 0.004
    assert side["self_s"] == side["total_s"] >= report["other"]["total_s"]
    assert 0.002 <= outer["self_s"] < outer["total_s"]


def test_a_phase_marks_the_timeline_only_while_a_profiler_records(
    monkeypatch,
):
    """Without a profiler a phase opens no ``record_function`` range (one
    costs many times the rest of a phase); under one it opens one."""
    opened = []
    real = torch.profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    profiling.reset_phases()
    with profiling.phase("quiet"):
        pass
    assert opened == []
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]
    ):
        with profiling.phase("seen"):
            pass
    assert opened == ["seen"]
    assert set(profiling.phase_report(reset=True)) == {"quiet", "seen"}


def test_self_time_of_a_phase_closed_out_of_order():
    """A phase left open across a generator's yield and closed after a
    later phase still closes its own entry of the thread's stack."""
    profiling.reset_phases()

    def gen():
        with profiling.phase("held"):
            yield

    g = gen()
    next(g)
    with profiling.phase("after"):
        g.close()
    with profiling.phase("next"):
        pass
    report = profiling.phase_report(reset=True)
    assert set(report) == {"held", "after", "next"}
    assert report["after"]["self_s"] <= report["after"]["total_s"]
    assert report["next"]["self_s"] == report["next"]["total_s"]


def test_counters_and_their_reset():
    profiling.reset_phases()
    profiling.count("a")
    profiling.count("a", 3)
    profiling.count("b", 0)
    with profiling.phase("p"):
        profiling.count("c")
    assert profiling.counter_report() == {"a": 4, "b": 0, "c": 1}
    # A phase reset leaves the counters, and the other way round
    profiling.phase_report(reset=True)
    assert profiling.counter_report() == {"a": 4, "b": 0, "c": 1}
    with profiling.phase("p"):
        pass
    assert profiling.counter_report(reset=True) == {"a": 4, "b": 0, "c": 1}
    assert profiling.counter_report() == {}
    assert set(profiling.phase_report()) == {"p"}
    # reset_phases clears both
    profiling.count("a")
    profiling.reset_phases()
    assert profiling.phase_report() == {} and profiling.counter_report() == {}


def test_counts_from_threads_all_count():
    profiling.reset_phases()
    n_threads, n_counts = 8, 500

    def work() -> None:
        for _ in range(n_counts):
            profiling.count("shared")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert profiling.counter_report(reset=True) == {
        "shared": n_threads * n_counts
    }


def _afm(rows: int, cols: int):
    """Pulser's AFM tutorial sweep (its values, 252/800/500 ns) on a
    ``rows`` x ``cols`` rectangle at the blockade radius of U = 2π,
    parametrized by Ω_max and δ_f."""
    P = pulser_tpu_torch
    reg = P.Register.rectangle(rows, cols, spacing=9.757, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    omega, delta_f = seq.declare_variable("omega"), seq.declare_variable("df")
    d0 = -6 * 2 * np.pi
    rise = P.RampWaveform(252, 0.0, omega)
    sweep = P.RampWaveform(800, d0, delta_f)
    fall = P.RampWaveform(500, omega, 0.0)
    seq.add(P.Pulse.ConstantDetuning(rise, d0, 0.0), "ryd")
    seq.add(P.Pulse.ConstantAmplitude(omega, sweep, 0.0), "ryd")
    seq.add(P.Pulse.ConstantDetuning(fall, delta_f, 0.0), "ryd")
    return seq


def _emulator_job(seq, n_eval: int) -> None:
    """A job of the sweep: build, the emulator, its run, the final state
    fetched and 100 shots."""
    from pulser_tpu_torch.emulator import TorchEmulator

    built = seq.build(omega=2 * np.pi * 2.3, df=2 * np.pi * 2)
    times = np.linspace(0, built.get_duration() * 1e-3, n_eval)
    res = TorchEmulator.from_sequence(
        built, evaluation_times=times, torch_device="cpu"
    ).run()
    res.states[-1].full()
    np.random.seed(3)
    res.sample_final_state(100)


def _backend_job(seq, n_eval: int) -> None:
    """A job of the observables traffic: occupations at ``n_eval`` times,
    the correlation matrix, the energy and 100 bitstrings at the end."""
    from pulser_tpu_torch.emulator import TorchBackendV2, TorchConfig

    P = pulser_tpu_torch
    built = seq.build(omega=2 * np.pi * 2.3, df=2 * np.pi * 2)
    np.random.seed(3)
    TorchBackendV2(
        built,
        config=TorchConfig(
            observables=[
                P.Occupation(evaluation_times=list(np.linspace(0, 1, n_eval))),
                P.CorrelationMatrix(evaluation_times=[1.0]),
                P.Energy(evaluation_times=[1.0]),
                P.BitStrings(evaluation_times=[1.0], num_shots=100),
            ],
            torch_device="cpu",
        ),
    ).run()


def _ranges(path) -> list[tuple[float, float, str]]:
    events = json.loads(path.read_text())["traceEvents"]
    return [
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
    ]


def _inside(ranges, inner: str, outer: str) -> bool:
    """Whether every range ``inner`` lies inside some range ``outer``."""
    outs = [(a, b) for a, b, n in ranges if n == outer]
    ins = [(a, b) for a, b, n in ranges if n == inner]
    return bool(ins) and all(
        any(a0 <= a and b <= b0 for a0, b0 in outs) for a, b in ins
    )


#: (inner, outer) of the phases one job of each cell crosses
EMULATOR_NESTING = [
    ("emulator.hamiltonian_data", "emulator.init"),
    ("emulator.step_policy", "emulator.run"),
    ("emulator.build_plan", "emulator.run"),
    ("emulator.sesolve", "emulator.run"),
    ("emulator.wrap_results", "emulator.run"),
]
BACKEND_NESTING = EMULATOR_NESTING + [
    ("emulator.run", "backend.run"),
    ("backend.observables", "backend.run"),
    ("observable.occupation", "backend.observables"),
    ("observable.correlation_matrix", "backend.observables"),
    ("observable.energy", "backend.observables"),
    ("observable.bitstrings", "backend.observables"),
]


def test_trace_of_one_job_of_each_cell_holds_the_layer_phases(tmp_path):
    """A CPU Chrome trace of a 2x3-atom emulator job and a backend job
    with the observables traffic holds every layer phase, nested as the
    layers call each other."""
    seq = _afm(2, 3)
    with profiling.trace(str(tmp_path / "emu"), device="cpu"):
        _emulator_job(seq, 11)
    with profiling.trace(str(tmp_path / "backend"), device="cpu"):
        _backend_job(seq, 11)
    emu = _ranges(tmp_path / "emu" / "trace.json")
    backend = _ranges(tmp_path / "backend" / "trace.json")
    assert {n for *_, n in emu} >= {
        "sequence.build", "emulator.sample_sequence", "emulator.init",
        "emulator.hamiltonian_data", "emulator.run", "emulator.step_policy",
        "emulator.build_plan", "emulator.sesolve", "emulator.wrap_results",
        "results.fetch", "results.sample",
    }
    assert {n for *_, n in backend} >= {
        "sequence.build", "emulator.sample_sequence", "emulator.init",
        "emulator.run", "backend.run", "backend.observables",
        "observable.occupation", "observable.correlation_matrix",
        "observable.energy", "observable.bitstrings",
    }
    for inner, outer in EMULATOR_NESTING:
        assert _inside(emu, inner, outer), (inner, outer)
    for inner, outer in BACKEND_NESTING:
        assert _inside(backend, inner, outer), (inner, outer)
    # The backend's own job holds no fetch of the states and no
    # emulator built inside its run
    assert not _inside(backend, "emulator.init", "backend.run")
    assert "results.fetch" not in {n for *_, n in backend}
    # The fetch and the shots come after the run, outside it
    assert not _inside(emu, "results.fetch", "emulator.run")
    assert not _inside(emu, "results.sample", "emulator.run")


@pytest.mark.parametrize(
    "rows,cols,n_eval", [(2, 3, 11), (1, 4, 7), (2, 4, 5)]
)
def test_sync_counts_of_one_job_of_each_cell(rows, cols, n_eval):
    """The reads that wait for the card, by site, of one job of each cell
    after a first: on the CPU the same sites count as on the card.

    The emulator job stages the interaction-picture solve's 7 inputs and
    the occupancy patterns of its two phase evaluators, one a group of up
    to six qubits (this size runs the torch loop), and fetches its final
    state once; the
    backend job reads each occupation, each distinct pair of the
    correlation matrix and the energy once, the norm of each state it
    hands its observables once (the coarse steps renormalize on the
    device), stages the Hamiltonian's diagonal and its coefficients at
    the end, and fetches the amplitudes once for the bitstrings."""
    n = rows * cols
    stage = 7 + 2 * -(-n // 6)
    seq = _afm(rows, cols)
    for job, want in (
        (
            _emulator_job,
            {"sync.solver.stage": stage, "sync.results.fetch": 1},
        ),
        (
            _backend_job,
            {
                "sync.solver.stage": stage,
                "sync.results.norm": n_eval,
                "sync.operator.expect": n * n_eval + n * (n + 1) // 2 + 1,
                "sync.operator.stage": 3,
                "sync.state.probabilities": 1,
            },
        ),
    ):
        job(seq, n_eval)
        profiling.reset_phases()
        job(seq, n_eval)
        assert profiling.counter_report(reset=True) == want, job.__name__


#: Each dissipative route's host-to-device copies on a two-qubit lab-frame
#: solve (one collapse operator, one chunk of trajectories), by array.
DISSIPATIVE_COPIES = {
    # detunings, initial state, drives, diagonal; the chunk's thresholds
    # and uniforms; the operators and Σ L†L of the trajectory scan
    "mcsolve_rk4": 4 + 2 + 2,
    # ρ0, Σ L†L and the unit-coefficient table of the collapse algebra,
    # detunings, drives, diagonal
    "mesolve_rk4": 1 + 2 + 3,
    # the knot gather (two indices, the fractions) and the three raw
    # leaves; initial state, diagonals, thresholds, uniforms, the
    # evaluation map; the operators and Σ L†L of the scan
    "mcsolve_rk4_batched": 3 + 3 + 5 + 2,
    # ρ0, the knot gather and the three raw leaves, diagonals, Σ L†L and
    # the unit-coefficient table, the evaluation map
    "mesolve_rk4_batched": 1 + 3 + 3 + 1 + 2 + 1,
}


@pytest.mark.parametrize("solve", sorted(DISSIPATIVE_COPIES))
def test_dissipative_routes_count_each_copy(solve):
    """The quantum-jump and master-equation routes count
    ``sync.solver.stage`` once per array they copy to the device, as the
    Schrödinger routes do."""
    from pulser_tpu_torch.ops import solver

    knots = np.linspace(0, 0.01, 11)
    coeffs = {"amp": np.ones((1, 2, 11), complex), "det": np.zeros((1, 2, 11))}
    eval_t = np.array([0.01])
    psi0, rho0 = np.eye(4)[0], np.eye(4) / 4
    args = (((1, 0, 0),), 2, 2, [np.diag([1.0, 0.0])])
    if solve.endswith("_batched"):
        plan = solver.build_plan_batched(
            knots, {k: np.stack([v] * 3) for k, v in coeffs.items()},
            eval_t, max_step=1e-3, host_stage=False,
        )
        diag = np.zeros((3, 4))
        kw = {"seeds": [1, 2, 3]} if solve.startswith("mc") else {}
    else:
        plan = solver.build_plan(knots, coeffs, eval_t, max_step=1e-3)
        diag = np.zeros(4)
        kw = {"ntraj": 2, "seed": 1} if solve.startswith("mc") else {}
    start = psi0 if solve.startswith("mc") else rho0
    profiling.counter_report(reset=True)
    getattr(solver, solve)(start, plan, diag, *args, device="cpu", **kw)
    assert profiling.counter_report(reset=True) == {
        "sync.solver.stage": DISSIPATIVE_COPIES[solve]
    }
