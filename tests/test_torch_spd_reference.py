"""The benchmark's ``spd16`` cell at a small size on the CPU: the port's
noisy pure-state route through the harness's ``noisy`` entry, against
the plain reference of ``gpubench/reference/spd16.py``.

The configuration is ``spd16``'s (the AFM sweep under SPAM, doppler and
amplitude noise) on a 2 x 3 block of its square, with 4 realizations of
50 samples and the pulses' durations cut to 100/300/200 ns. The
reference replays the Pulser API's draws from each job's numpy seed and
integrates the realizations in float64; ``counts_gap`` pairs the
program's shots with the replayed draws.
"""

from __future__ import annotations

import json
import os
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

import pulser_tpu
import pulser_tpu_torch
from pulser_tpu.emulator import TpuEmulator
from gpubench.harness import jobs as jobsmod
from gpubench.harness import spec, traffic
from gpubench.harness import sequence as seqmod
from gpubench.reference import spd16 as ref
from gpubench.tests import _cells
from pulser_tpu_torch import profiling

CELL = "spd16.shots"
RUNS = 4
DURATIONS = (100, 300, 200)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout of the benchmark whose ``spd16`` is the small one."""
    root = _cells.small_root(str(tmp_path_factory.mktemp("spd")))
    path = os.path.join(root, "gpubench", "configs", "spd16.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["noise"]["runs"] = RUNS
    for pulse, duration in zip(cfg["pulses"], DURATIONS):
        pulse["duration"] = duration
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


@pytest.fixture(scope="module")
def cell(root):
    return spec.load_cell(root, CELL)


def _runner(cell):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        return jobsmod.Runner(cell, "cpu", jobsmod.Spans())


def _jobs(cell, seed, count=2):
    return traffic.first(cell.traffic, seed, count)


def _run_jobs(cell, jobs):
    runner = _runner(cell)
    for job in jobs:
        job["outputs"] = runner.run(job)
    return jobs


# -- the program against the reference ---------------------------------------


@pytest.mark.parametrize("seed", [2**31 + 12345, 3000000011])
def test_the_programs_counts_read_under_the_limit(cell, seed):
    """Two jobs through the ``noisy`` entry: every time's 200 shots pair
    with the replayed draws within a tiny window, far under the limit."""
    jobs = _run_jobs(cell, _jobs(cell, seed))
    assert pulser_tpu_torch.ops.solver.last_solve_info["kind"] == (
        "sesolve_batched_torch"
    )
    for job in jobs:
        counts = job["outputs"]["counts"]
        assert len(counts) == cell.config["evaluation_times"]
        assert all(sum(c.values()) == RUNS * 50 for c in counts)
    want = ref.expected(cell.config, cell.traffic, jobs)
    r = ref.compare(cell.config, cell.traffic, jobs, want)["counts_gap"]
    assert r["value"] <= r["limit"] / 100, r


def test_the_replayed_realizations_equal_the_ports(cell):
    """The reference's draws from a job's seed are the port's noise
    realizations (its private trajectories and per-atom drives), and the
    two leave numpy's generator at the same point after the run."""
    job = _jobs(cell, 2**31 + 99, 1)[0]
    runner = _runner(cell)
    np.random.seed(job["np_seed"])
    seq = runner.build(job)
    emu = pulser_tpu_torch.emulator.TorchEmulator.from_sequence(
        seq, noise_model=runner.noise,
        evaluation_times=runner.evaluation_times(seq.get_duration()),
        torch_device="cpu",
    )
    trajs = [t for t, _ in emu._hamiltonian_data.noise_trajectories]
    batch = emu._noisy_coeff_batch()
    emu.run()
    after = np.random.rand()

    cfg = cell.config
    n_times = cfg["evaluation_times"]
    dr = ref.draws(cfg, n_times, job["np_seed"])
    for r, tr in enumerate(trajs):
        assert list(tr.bad_atoms.values()) == list(dr["undriven"][r])
        assert list(tr.doppler_detune.values()) == list(dr["doppler"][r])
        assert tr.amp_fluctuations["ch"] == dr["amplitude"][r]
    assert dr["undriven"].shape == (RUNS, 6)
    # The generator's state after every replayed draw
    rs = np.random.RandomState(job["np_seed"])
    ref.realizations(cfg["noise"], 6, rs)
    rs.uniform(size=6)
    rs.rand(RUNS * n_times * 50)
    rs.uniform(size=(RUNS * n_times * 50, 6))
    assert rs.rand() == after
    # Each atom's drive: the port's samples (½ Ω_k at the knots, δ_k)
    coords = np.asarray(cfg["register"]["coords_um"])
    driven = ~dr["undriven"]
    profile = ref.beam_profile(coords, 175.0)
    factors = dr["amplitude"][:, None] * profile[None] * driven
    amp, det = _samples(cfg, job)
    n_s = len(amp)
    np.testing.assert_allclose(
        batch.amp[:, 0, :, :n_s].real, 0.5 * factors[:, :, None] * amp,
        rtol=1e-12, atol=1e-12,
    )
    np.testing.assert_allclose(
        batch.det[:, 0, :, :n_s],
        driven[:, :, None] * (det + dr["doppler"][:, :, None]),
        rtol=1e-12, atol=1e-12,
    )
    # The interaction diagonals, in the port's state order (r first); the
    # port rounds the distances to its coordinate precision
    c6 = cfg["constants"]["c6_rad_um6_per_us"]
    np.testing.assert_allclose(
        batch.diags[:, ::-1], ref.interaction_diags(coords, c6, driven),
        rtol=1e-5,
    )


def _samples(cfg, job):
    """The shared amplitude and detuning samples (rad/µs) of a job."""
    from gpubench.reference import rydberg as R

    return R.pulse_samples(
        cfg["pulses"], R.values_of(cfg, job["params"]), ref.ROOT
    )


def test_the_bfloat16_control_fails_the_limit(root):
    """The reference in bfloat16, in the program's place, is not correct."""
    from gpubench.control import readings

    r = readings(root, CELL, seed=2**31 + 7, device="cpu")["counts_gap"]
    assert r["value"] > r["limit"], r


# -- the comparison alone ----------------------------------------------------


NOISE = {"p_false_pos": 0.01, "p_false_neg": 0.05}


def _toy(seed=5, n=3, runs=2, spr=6):
    """A two-realization draw of 3 atoms: its distributions, uniforms,
    flip uniforms and the counts the reference itself draws."""
    g = np.random.default_rng(seed)
    p = g.random((runs, 1 << n)) ** 2
    p /= p.sum(axis=1, keepdims=True)
    cdf = np.concatenate([np.zeros((runs, 1)), np.cumsum(p, axis=1)], axis=1)
    u = g.random((runs, 1, spr))
    v = g.random((runs, 1, spr, n))
    counts = ref.sample(cdf[:, None], u, v, NOISE, n)[0]
    return cdf, u[:, 0], v[:, 0], counts, n


def test_counts_gap_reads_zero_for_identical_draws():
    cdf, u, v, counts, n = _toy()
    assert ref.time_gap(counts, cdf, u, v, NOISE, n) == 0.0


def test_counts_gap_reads_the_distance_of_one_moved_shot():
    """One draw's outcome moved to the next one up: the gap is how far
    its uniform lies below that outcome's interval (no flips, so the
    shot's label is its outcome), unless another pairing does better."""
    cdf, u, v, _, n = _toy()
    v = np.ones_like(v)  # no flip
    counts = ref.sample(cdf[:, None], u[:, None], v[:, None], NOISE, n)[0]
    r, s = 0, int(np.argmax(u[0]))
    x = int(np.searchsorted(cdf[r, 1:], u[r, s]))
    assert x + 1 < (1 << n)
    moved = Counter(counts)
    moved[format(x, f"0{n}b")] -= 1
    moved[format(x + 1, f"0{n}b")] += 1
    moved = +moved
    gap = ref.time_gap(moved, cdf, u, v, NOISE, n)
    want = cdf[r, x + 1] - u[r, s]
    assert 0.0 < gap <= want
    # One realization, its other draws at the top: no pairing does
    # better than the moved one, so the gap is its distance exactly
    cdf, u, v, _, n = _toy(runs=1)
    v = np.ones_like(v)
    s = int(np.argmin(u[0]))
    x = int(np.searchsorted(cdf[0, 1:], u[0, s]))
    only = np.full_like(u, 0.999)
    only[0, s] = u[0, s]
    assert int(np.searchsorted(cdf[0, 1:], 0.999)) > x
    counts = ref.sample(cdf[:, None], only[:, None], v[:, None], NOISE, n)[0]
    moved = Counter(counts)
    moved[format(x, f"0{n}b")] -= 1
    moved[format(x + 1, f"0{n}b")] += 1
    gap = ref.time_gap(+moved, cdf, only, v, NOISE, n)
    assert gap == pytest.approx(cdf[0, x + 1] - u[0, s])


@pytest.mark.parametrize(
    "broken",
    ["a shot short", "an unknown label", "wrong width", "not a count"],
)
def test_counts_gap_reads_one_for_counts_that_cannot_pair(broken):
    cdf, u, v, counts, n = _toy()
    bad = Counter(counts)
    key = next(iter(bad))
    if broken == "a shot short":
        bad[key] -= 1
    elif broken == "an unknown label":
        bad[key] -= 1
        bad["x" * n] = 1
    elif broken == "wrong width":
        bad[key] -= 1
        bad["0" * (n + 1)] = 1
    else:
        bad = [key]
    assert ref.time_gap(bad, cdf, u, v, NOISE, n) == 1.0


def test_work_count_matches_a_hand_count():
    cfg = {
        "register": {"coords_um": [[0.0, 0.0], [6.0, 0.0]]},
        "pulses": [{"duration": 3, "amplitude": ["ConstantWaveform", 1.0],
                    "detuning": ["ConstantWaveform", 0.0]}],
        "evaluation_times": 2,
        "noise": {"runs": 5},
    }
    work = spec.load_module(_cells.REPO, "work", "spd16").count(cfg, {})
    # 5 realizations of afm16's count: 76 flops per amplitude and step,
    # 4 amplitudes, 3 steps
    assert work["flops"] == 5 * 76 * 4 * 3
    # in: the state (4 x 8 B) and each realization's 2 atoms x 4 samples
    # of 2 float32 streams; out: 5 states at 2 times
    assert work["bytes"] == 4 * 8 * (1 + 5 * 2) + 5 * 2 * 2 * 4 * 4


# -- the port's phases and counters on the route -----------------------------


def test_the_new_phases_and_counters_fire_once_a_job(cell):
    """A warm job: the realizations' draw, coefficients and step policy
    once, one solve whose states come back once, and one sampling pass
    that computes the weight rows as it draws and tallies the counts
    once, with no result wrapped."""
    runner = _runner(cell)
    first, job = _jobs(cell, 2**31 + 5)
    runner.run(first)
    profiling.reset_phases()
    runner.run(job)
    report = profiling.phase_report(reset=True)
    phases = {k: v["calls"] for k, v in report.items()}
    counters = profiling.counter_report(reset=True)
    for name in (
        "emulator.noise_trajectories", "emulator.traj_draw",
        "emulator.coeff_batch", "emulator.step_policy",
        "emulator.build_plan_batched", "emulator.sesolve_batched",
        "emulator.sample_counts", "emulator.counts", "emulator.run",
    ):
        assert phases[name] == 1.0, name
    assert "emulator.wrap_results" not in phases
    assert "emulator.traj_weights" not in phases
    read = cell.phases("traj_prep") + cell.phases("traj_sampling")
    assert set(read) <= set(phases)
    assert counters["traj.realizations"] == RUNS
    # One fetch of the states; the torch loop stages its 7 inputs and
    # the occupancy patterns of its two phase evaluators (6 qubits: one
    # group each), as the coherent route's loop does
    assert counters["sync.solver.fetch"] == 1
    assert counters["sync.solver.stage"] == 7 + 2
    assert sum(v for k, v in counters.items() if k.startswith("sync.")) == 10
    # The fetch brings back each realization's state (64 complex64
    # amplitudes) after every step of the loop that ends at an
    # evaluation time or more
    fetched = counters["traj.fetched_bytes"]
    assert fetched % (RUNS * 64 * 8) == 0
    assert fetched // (RUNS * 64 * 8) >= cell.config["evaluation_times"]


def test_renormalizing_each_realization_equals_the_whole_batch():
    """The route renormalizes each realization's states as it reaches
    them: the same bits as one division of the whole batch."""
    from pulser_tpu_torch.emulator.simulation import _renormalized

    g = np.random.default_rng(3)
    batch = (
        g.standard_normal((5, 7, 256)) + 1j * g.standard_normal((5, 7, 256))
    ).astype(np.complex64)
    batch[2, 3] = 0.0
    norms = np.linalg.norm(batch, axis=-1, keepdims=True)
    whole = batch / np.where(norms == 0, 1.0, norms)
    for b, states in enumerate(batch):
        one = _renormalized(states)
        assert one.dtype == whole.dtype
        assert one.tobytes() == whole[b].tobytes()


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_counts_equal_the_jax_packages_with_or_without_tracing(
    cell, monkeypatch, traced
):
    """Seed for seed, the port's counts on this route (under a profiler
    that records its phases, or with none) are the JAX package's, in
    double precision exactly: the phases and counters move no draw."""
    import jax

    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    monkeypatch.delenv("PULSER_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PULSER_TPU_SESOLVE_PALLAS_BATCHED", raising=False)
    cfg = cell.config
    job = _jobs(cell, 2**31 + 21, 1)[0]
    values = seqmod.build_values(job["params"])

    def counts(P, emulator, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            noise = seqmod.noise_model(P, cfg)
        seq = seqmod.sequence(P, cfg, tuple(job["params"])).build(**values)
        times = np.linspace(0.0, seq.get_duration() * 1e-3, 21)
        np.random.seed(job["np_seed"])
        emu = emulator.from_sequence(
            seq, noise_model=noise, evaluation_times=times, **kw
        )
        return [dict(r.bitstring_counts) for r in emu.run()]

    jax.config.update("jax_enable_x64", True)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        want = counts(pulser_tpu, TpuEmulator)
        profiling.reset_phases()
        if traced:
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
            ):
                got = counts(
                    pulser_tpu_torch, pulser_tpu_torch.emulator.TorchEmulator,
                    torch_device="cpu",
                )
        else:
            got = counts(
                pulser_tpu_torch, pulser_tpu_torch.emulator.TorchEmulator,
                torch_device="cpu",
            )
    finally:
        torch.set_default_dtype(old)
    assert profiling.counter_report(reset=True)["traj.realizations"] == RUNS
    assert got == want


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("renormalize", [False, True], ids=["raw", "renorm"])
@pytest.mark.parametrize("basis", ["ground-rydberg", "digital"])
def test_ket_state_draws_equal_those_of_the_wrapped_results_weights(
    basis, renormalize, dtype
):
    """Drawn from kets without wrapping them, the counts are those drawn
    from the kets' results (``TorchResult._weights`` rows,
    trajectory-major) from the same generator state, Counter for Counter
    and in order, with the generator left at the same draw, in single
    and in double precision."""
    from pulser_tpu_torch.emulator import simulation as sim
    from pulser_tpu_torch.emulator.qobj import Qobj
    from pulser_tpu_torch.emulator.sim_result import TorchResult

    n, n_eval = 7, 4
    g = np.random.default_rng(11)
    states = (
        g.standard_normal((5, n_eval, 1 << n))
        + 1j * g.standard_normal((5, n_eval, 1 << n))
    ).astype(dtype) * 0.09
    states[1, 2] *= 40.0  # one state far from its norm
    ns = [30 + e % 7 for e in range(5 * n_eval)]
    spam = {"epsilon": 0.01, "epsilon_prime": 0.05}
    time_index = [0, 1, 1, 3]  # two times read the same state
    rows = []
    for states_t in states:
        if renormalize:
            states_t = sim._renormalized(states_t)
        for ti in time_index:
            ket = Qobj(states_t[ti], dims=[[2] * n, [1] * n])
            rows.append(TorchResult(tuple(range(n)), basis, ket, True)._weights())
    np.random.seed(5)
    want = sim._sample_weight_rows(rows, ns, n_eval, n, spam)
    want_next = np.random.rand()
    np.random.seed(5)
    got = sim._sample_ket_states(
        states, renormalize, time_index, basis == "ground-rydberg",
        ns, n_eval, n, spam,
    )
    assert np.random.rand() == want_next
    assert [list(c.items()) for c in got] == [list(c.items()) for c in want]
    assert sum(sum(c.values()) for c in got) == sum(ns)


def test_the_routes_counts_equal_those_of_its_wrapped_results(
    cell, monkeypatch
):
    """In single precision, the route's counts are those drawn from its
    states wrapped into results, each weight row read from
    ``CoherentResults`` at its evaluation time, seed for seed."""
    from pulser_tpu_torch.emulator import simulation as sim
    from pulser_tpu_torch.emulator.qobj import Qobj

    runner = _runner(cell)
    job = _jobs(cell, 2**31 + 77, 1)[0]
    want = runner.run(dict(job))["counts"]
    emus = []
    original = sim.TorchEmulator._noisy_states_batched

    def keep(self, *a, **k):
        emus.append(self)
        return original(self, *a, **k)

    def from_wrapped_results(
        states, renormalize, time_index, reverse, ns, n_times, width,
        meas_errors,
    ):
        emu = emus[-1]
        rows = []
        for states_t in states:
            if renormalize:
                states_t = sim._renormalized(states_t)
            cres = emu._wrap_coherent(
                [Qobj(s, dims=[[2] * width, [1] * width]) for s in states_t]
            )
            for t in emu._eval_times_array:
                rows.append(cres[cres._get_index_from_time(t, 1.0e-3)]._weights())
        return sim._sample_weight_rows(rows, ns, n_times, width, meas_errors)

    monkeypatch.setattr(sim.TorchEmulator, "_noisy_states_batched", keep)
    monkeypatch.setattr(sim, "_sample_ket_states", from_wrapped_results)
    got = runner.run(dict(job))["counts"]
    assert emus
    assert [list(c.items()) for c in got] == [list(c.items()) for c in want]


def test_on_the_cpu_the_route_draws_on_the_host(cell, monkeypatch):
    """On the CPU the batch takes the torch loop, whose states come back
    to the host: the route draws them with ``_sample_ket_states`` and
    never with the card's sampler; its counts and the generator's next
    draw are those of the host pass over the solve's states from the
    generator's state at the draws."""
    import pulser_tpu_torch.ops.kernels as K
    from pulser_tpu_torch.emulator import simulation as sim

    calls = []
    host_pass = sim._sample_ket_states

    def keep(states, *rest):
        calls.append((np.random.get_state(), np.array(states), rest))
        return host_pass(states, *rest)

    def refuse(*a, **k):
        raise AssertionError("the card's sampler ran on the CPU")

    monkeypatch.setattr(sim, "_sample_ket_states", keep)
    monkeypatch.setattr(sim, "_sample_batched_kets", refuse)
    monkeypatch.setattr(K, "sample_states", refuse)
    job = _jobs(cell, 2**31 + 91, 1)[0]
    got = _runner(cell).run(dict(job))["counts"]
    got_next = np.random.rand()
    assert len(calls) == 1
    state, states, rest = calls[0]
    assert isinstance(states, np.ndarray) and states.shape[0] == RUNS
    np.random.set_state(state)
    want = host_pass(states, *rest)
    assert np.random.rand() == got_next
    assert [list(c.items()) for c in got] == [list(c.items()) for c in want]


def test_a_uniform_above_a_rows_rounded_total_draws_its_last_outcome(
    monkeypatch,
):
    """A float32 row of measurement weights whose cumulative sum ends
    below 1, and uniforms on both sides of that total: those below draw
    as a plain searchsorted does, the one above draws the row's last
    outcome of positive weight (before, an index past the row's end,
    read as the all-ground bitstring, whose weight here is 0)."""
    from pulser_tpu_torch.emulator.simulation import _sample_weight_rows

    n = 10
    g = np.random.default_rng(0)
    for _ in range(100):
        w = g.gamma(0.3, size=1 << n).astype(np.float32) ** 2
        w[0] = w[-3:] = 0.0  # the all-ground and the last outcomes
        w = w / np.add.accumulate(w)[-1]
        cum = np.cumsum(w)
        if cum[-1] < 1.0:
            break
    assert cum[-1] < 1.0
    below = g.random(7) * float(cum[-1])
    above = (float(cum[-1]) + 1.0) / 2
    rnd = np.concatenate([below, [above]])
    monkeypatch.setattr(np.random, "rand", lambda size: rnd.copy())
    counts = _sample_weight_rows(w[None], [len(rnd)], 1, n, None)[0]
    want = Counter(
        format(int(i), f"0{n}b") for i in np.searchsorted(cum, below)
    )
    want[format((1 << n) - 4, f"0{n}b")] += 1
    assert counts == want


# -- the metrics' readers -----------------------------------------------------


@pytest.mark.parametrize(
    "metric",
    ["traj_prep_ms", "traj_sampling_ms", "traj_fetch_mb_per_job",
     "traj_solve_roofline_pct"],
)
def test_a_reader_finds_nothing_in_a_window_without_its_phases(cell, metric):
    """A program that marks none of the route's phases and keeps no
    counter (and a run without a trace): the reader returns None."""
    from gpubench.harness.main import Window

    profiling.reset_phases()
    w = Window(cell, 3, jobsmod.Spans(), {}, {"flops": 1.0, "bytes": 1.0})
    assert cell.module("metrics", metric).read(w) is None
