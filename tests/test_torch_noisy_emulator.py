"""The port's noisy quantum-jump path end to end, against pulser_tpu.

A 4-atom sequence under SPAM, doppler, amplitude (with laser waist) and
dephasing noise runs in both packages after ``np.random.seed(77)``:
``pulser_tpu`` through ``TpuEmulator.from_sequence`` with its rows
kernel in interpret mode, the port through ``TorchEmulator`` on inputs
carried across with :mod:`pulser_tpu_torch.interop`. The numpy global
RNG is consumed in the same order by both, so:

- the coefficient batch of the fast path (rank factors, diagonals,
  repetitions) and the step-policy inputs derived from it are bit-equal;
- both return ``NoisyResults`` at the same evaluation times, and the
  bitstring counts are equal at every evaluation time, up to the draws
  that lie within 1e-5 of a cumsum bin edge (each may move one count).

The same holds on the lab-frame route: under Pulser's effective-noise
Pauli channel (general collapse operators) both packages solve in the
lab frame and draw the counts on the host.

Without collapse operators (SPAM, doppler and amplitude noise only) both
packages integrate the trajectories as one pure-state batch
(``sesolve_rk4_batched``) and sample on the host from the numpy global
RNG: the stream is left at the same point and the counts are equal, in
double precision exactly, in single precision up to one draw that may
sit within float32 rounding of a cumsum bin edge.

Depolarizing noise (the serial quantum-jump solve per trajectory),
relaxation, more atoms than the kernels take (the batched torch scan)
and register noise (one jittered ``Register3D`` per trajectory) give the
JAX package's seeded counts, and no entry point moves to the CPU unless
it is asked to.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import jax
import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.ops import solver as jax_solver

from pulser_tpu_torch.emulator import NoisyResults, Solver, TorchEmulator
from pulser_tpu_torch.emulator import simulation as torch_sim
from pulser_tpu_torch.interop import (
    from_jax_device,
    from_jax_noise_model,
    from_jax_register,
    from_jax_samples,
)
from pulser_tpu_torch.ops import solver as torch_solver
from pulser_tpu_torch.result import SampledResult
from torch_parity import assert_lindblad_policy_matches

torch.set_num_threads(1)

SEED = 77
EDGE_TOL = 1e-5
NOISE = dict(
    dephasing_rate=0.08,
    amp_sigma=0.02,
    temperature=40,
    laser_waist=175,
    state_prep_error=0.05,
    p_false_pos=0.01,
    p_false_neg=0.02,
    runs=6,
    samples_per_run=4,
)


@pytest.fixture
def jax_rows(monkeypatch):
    """The JAX package on its single-chip rows kernel (interpret mode),
    in single precision."""
    monkeypatch.setenv("PULSER_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PULSER_TPU_MCWF_ROWS", "1")
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _sequence(local=False, shape=(2, 2), duration=400):
    """A 2x2 register (or ``shape``) under a global Rydberg pulse of
    ``duration`` ns; with ``local``, a second (local) Rydberg channel on
    the same basis, which takes the emulator's generic coefficient batch
    instead of the factored one."""
    reg = tpu.Register.rectangle(*shape, spacing=7.0, prefix="q")
    seq = tpu.Sequence(reg, tpu.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(tpu.Pulse.ConstantPulse(duration, 2 * np.pi, -1.0, 0.0), "ryd")
    if local:
        seq.declare_channel("loc", "rydberg_local", initial_target="q0")
        seq.add(tpu.Pulse.ConstantPulse(200, 1.0, 0.5, 0.0), "loc")
    return seq


def _noise(**params):
    """A ``pulser_tpu.NoiseModel`` (default: :data:`NOISE`); ``runs``
    is deprecated but is how these configurations set the trajectory
    count."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return tpu.NoiseModel(**(params or NOISE))


def _jax_emulator(seq, noise, **kw):
    return TpuEmulator.from_sequence(
        seq, noise_model=noise, evaluation_times="Minimal", **kw
    )


def _port_emulator(seq, noise, **kw):
    return TorchEmulator(
        from_jax_samples(tpu.sampler.sample(seq)),
        from_jax_register(seq.register),
        from_jax_device(seq.device),
        noise_model=from_jax_noise_model(noise),
        evaluation_times="Minimal",
        torch_device="cpu",
        **kw,
    )


def _both(seq, noise):
    np.random.seed(SEED)
    jemu = _jax_emulator(seq, noise)
    np.random.seed(SEED)
    temu = _port_emulator(seq, noise)
    return jemu, temu


def _near_edge_draws(args, spec):
    """How many of the fused solve's draws lie within EDGE_TOL of a
    cumsum bin edge of their (trajectory, time) row."""
    psi0, plans, diags, pairs, d, n, cops, seeds = args[:8]
    states = torch_solver.mcsolve_rk4_batched(
        psi0, plans, diags, pairs, d, n, cops, seeds, dtype=psi0.dtype,
        ip=True, device="cpu",
    )
    samp_u, row_traj, row_ti = spec
    p = np.abs(states) ** 2
    cum = np.cumsum(p, axis=-1, dtype=np.float32)[row_traj, row_ti]
    v = np.asarray(samp_u, np.float32) * cum[:, -1:]
    edge = np.min(np.abs(v[:, :, None] - cum[:, None, :]), axis=-1)
    return int(np.count_nonzero(edge <= EDGE_TOL))


@pytest.mark.parametrize("local", [False, True])
def test_noisy_run_matches_pulser_tpu(jax_rows, monkeypatch, local):
    seq, noise = _sequence(local), _noise()
    np.random.seed(SEED)
    jres = _jax_emulator(seq, noise).run()
    assert jax_solver.last_solve_info["kind"] == "mcwf_rows_pallas"
    jax_after = np.random.rand()

    captured = {}
    fused = torch_solver.mcsolve_rows_codes

    def record(*args, **kwargs):
        captured["args"], captured["spec"] = args, args[8]
        return fused(*args, **kwargs)

    monkeypatch.setattr(torch_solver, "mcsolve_rows_codes", record)
    np.random.seed(SEED)
    temu = _port_emulator(seq, noise)
    factored = temu._fast_coeff_batch(
        list(temu._hamiltonian_data.noise_trajectories)
    )
    assert (factored is None) == local
    tres = temu.run()
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_rows_torch" and info["sampled"]
    assert info["n_steps"] == jax_solver.last_solve_info["n_steps"]
    # The global RNG was consumed in the same order and amount
    assert np.random.rand() == jax_after

    assert isinstance(tres, NoisyResults)
    assert type(tres).__name__ == type(jres).__name__
    assert np.array_equal(tres._sim_times, jres._sim_times)
    assert tres.n_measures == jres.n_measures == 24
    near = _near_edge_draws(captured["args"], captured["spec"])
    moved = 0
    for t_res, j_res in zip(tres, jres):
        assert isinstance(t_res, SampledResult)
        assert t_res.evaluation_time == j_res.evaluation_time
        tc, jc = t_res.bitstring_counts, j_res.bitstring_counts
        assert sum(tc.values()) == sum(jc.values()) == 24
        moved += sum(
            abs(tc.get(k, 0) - jc.get(k, 0)) for k in set(tc) | set(jc)
        )
    print(f"{near} draws within {EDGE_TOL} of a bin edge")
    assert moved <= 2 * near


def test_results_api_matches_pulser_tpu(jax_rows):
    seq, noise = _sequence(), _noise()
    np.random.seed(SEED)
    jres = _jax_emulator(seq, noise).run()
    np.random.seed(SEED)
    tres = _port_emulator(seq, noise).run()
    assert tres.results == jres.results
    want = np.asarray(jres.get_final_state().full())
    assert np.allclose(tres.get_final_state().full(), want, atol=1e-12)
    n_r = tpu.emulator.qobj.basis(2, 0).proj()
    obs = tpu.emulator.qobj.tensor([n_r] + [tpu.emulator.qobj.qeye(2)] * 3)
    want_ev = np.asarray(jres.expect([obs.full()])[0])
    got_ev = np.asarray(tres.expect([np.asarray(obs.full())])[0])
    assert np.allclose(got_ev, want_ev, atol=1e-12)


def test_fast_coeff_batch_and_policy_are_bit_equal(jax_rows):
    seq, noise = _sequence(), _noise()
    jemu, temu = _both(seq, noise)
    jb = jemu._fast_coeff_batch(
        list(jemu._hamiltonian_data.noise_trajectories)
    )
    tb = temu._fast_coeff_batch(
        list(temu._hamiltonian_data.noise_trajectories)
    )
    assert jb is not None and tb is not None
    assert tb.reps == jb.reps
    assert np.array_equal(tb.diags, np.asarray(jb.diags))
    for got, want in zip(
        tb.amp_factors + tb.det_factors, jb.amp_factors + jb.det_factors
    ):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    knots = np.asarray(jb.template.sampling_times)
    assert np.array_equal(tb.template.sampling_times, knots)
    for got, want in zip(
        temu._factored_policy(tb, knots), jemu._factored_policy(jb, knots)
    ):
        if want is None:
            assert got is None
        else:
            assert np.array_equal(got, np.asarray(want))
    # The dense views and the batch branch of _sharp_knots
    assert np.array_equal(tb.amp, np.asarray(jb.amp))
    assert np.array_equal(tb.det, np.asarray(jb.det))
    got = temu._sharp_knots(tb, knots)
    want = jemu._sharp_knots(jb, knots)
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, np.asarray(want))
    # The whole policy of the batch, in its one home
    assert_lindblad_policy_matches(temu, jemu, tb, jb)


def test_repeated_runs_redraw_trajectories(jax_rows):
    """A second run() draws fresh noise trajectories in both packages,
    from the same point of the RNG stream."""
    seq, noise = _sequence(), _noise()
    jemu, temu = _both(seq, noise)
    np.random.seed(5)
    jemu.run()
    j2 = jemu.run()
    j_after = np.random.rand()
    np.random.seed(5)
    temu.run()
    t2 = temu.run()
    assert np.random.rand() == j_after
    assert [r.n_samples for r in t2] == [r.n_samples for r in j2] == [24, 24]


def test_n_trajectories_and_solver_options():
    seq = _sequence()
    noise = _noise()
    np.random.seed(SEED)
    emu = _port_emulator(seq, noise, n_trajectories=3)
    assert emu.n_trajectories == 3
    assert emu.solver == Solver.DEFAULT
    np.random.seed(SEED)
    emu = _port_emulator(seq, noise, solver=Solver.MCSOLVER)
    assert emu.n_trajectories == 6
    assert emu.solver == Solver.MCSOLVER


@pytest.mark.parametrize(
    "params, types, shape, kind",
    [
        # SPAM and doppler only: no collapse operators, the pure-state
        # batch
        (
            dict(state_prep_error=0.05, p_false_pos=0.01, temperature=40),
            {"SPAM", "doppler"},
            (2, 2),
            "sesolve_batched_torch",
        ),
        # depolarizing: the serial quantum-jump solve, one per trajectory
        (
            dict(depolarizing_rate=0.1, temperature=40),
            {"depolarizing", "doppler"},
            (2, 2),
            "mcwf_serial_torch",
        ),
        # relaxation: a single matrix unit on the interaction-picture
        # grid, the batched torch scan
        (
            dict(relaxation_rate=0.2, temperature=40),
            {"relaxation", "doppler"},
            (2, 2),
            "mcwf_batched_torch",
        ),
        # more atoms than the quantum-jump kernels take: the scan
        (
            dict(dephasing_rate=0.1, temperature=40),
            {"dephasing", "doppler"},
            (2, 7),
            "mcwf_batched_torch",
        ),
        # register (position) noise jitters the atoms in three
        # dimensions: one interaction diagonal per trajectory
        (
            dict(trap_waist=1.0, trap_depth=150.0, temperature=40),
            {"register", "doppler"},
            (2, 2),
            "sesolve_batched_torch",
        ),
    ],
    ids=[
        "spam_doppler", "depolarizing", "relaxation", "fourteen_atoms",
        "register_noise",
    ],
)
def test_configurations_outside_the_slice_raise(params, types, shape, kind):
    """Every noisy configuration runs and gives the JAX package's seeded
    counts (double precision, the RNG stream left at the same point)."""
    noise = _noise(**params, runs=6, samples_per_run=4)
    assert set(noise.noise_types) == types
    # Fourteen atoms for 100 ns: a few dozen steps of a 2^14 batch
    seq = _sequence(shape=shape, duration=100 if shape == (2, 7) else 400)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # complex128, as the JAX side
    try:
        np.random.seed(SEED)
        jres = _jax_emulator(seq, noise).run()
        j_after = np.random.rand()
        np.random.seed(SEED)
        res = _port_emulator(seq, noise).run()
    finally:
        torch.set_default_dtype(old)
    assert np.random.rand() == j_after
    assert isinstance(res, NoisyResults) and res.n_measures == 24
    assert torch_solver.last_solve_info["kind"] == kind
    assert [dict(r.bitstring_counts) for r in res] == [
        dict(r.bitstring_counts) for r in jres
    ]


@pytest.fixture
def jax_unsharded(monkeypatch):
    """The JAX package on one device, on its default (XLA) routes."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    monkeypatch.delenv("PULSER_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PULSER_TPU_SESOLVE_PALLAS_BATCHED", raising=False)


#: SPAM, doppler and amplitude noise with a laser waist: no collapse
#: operators.
PURE_NOISE = {k: v for k, v in NOISE.items() if k != "dephasing_rate"}


@pytest.mark.parametrize("double", [True, False], ids=["double", "single"])
@pytest.mark.parametrize("local", [False, True], ids=["factored", "generic"])
def test_pure_state_noisy_run_matches_pulser_tpu(
    jax_unsharded, monkeypatch, double, local
):
    """SPAM + doppler + amplitude on 4 atoms through both packages on the
    same seed: same route, same plan, same RNG stream afterwards, and
    equal counts (in single precision one draw may sit within float32
    rounding of a bin edge and move one count from a bin to the next)."""
    seq, noise = _sequence(local), _noise(**PURE_NOISE)
    assert set(noise.noise_types) == {"SPAM", "doppler", "amplitude"}
    jax.config.update("jax_enable_x64", double)
    torch.set_default_dtype(torch.float64 if double else torch.float32)
    try:
        np.random.seed(SEED)
        jemu = _jax_emulator(seq, noise)
        assert jemu._can_batch_trajectories()
        jres = jemu.run()
        jax_after = np.random.rand()

        captured = {}
        solve = torch_solver.sesolve_rk4_batched

        def record(*args, **kwargs):
            captured["plans"] = args[1]
            captured["states"] = solve(*args, **kwargs)
            return captured["states"]

        monkeypatch.setattr(torch_solver, "sesolve_rk4_batched", record)
        np.random.seed(SEED)
        temu = _port_emulator(seq, noise)
        tres = temu.run()
        assert np.random.rand() == jax_after
    finally:
        jax.config.update("jax_enable_x64", True)
        torch.set_default_dtype(torch.float32)
    info = torch_solver.last_solve_info
    assert info["kind"] == "sesolve_batched_torch"
    assert info["n_traj"] == len(captured["states"]) <= 6
    states = captured["states"]
    assert states.dtype == (np.complex128 if double else np.complex64)
    assert states.shape[1:] == (2, 16)
    # Renormalized after the coarsened solve
    assert np.allclose(np.linalg.norm(states, axis=-1), 1.0, atol=1e-6)
    assert isinstance(tres, NoisyResults)
    assert np.array_equal(tres._sim_times, jres._sim_times)
    assert tres.n_measures == jres.n_measures == 24
    moved = 0
    for t_res, j_res in zip(tres, jres):
        assert t_res.evaluation_time == j_res.evaluation_time
        tc, jc = t_res.bitstring_counts, j_res.bitstring_counts
        assert sum(tc.values()) == sum(jc.values()) == 24
        moved += sum(
            abs(tc.get(k, 0) - jc.get(k, 0)) for k in set(tc) | set(jc)
        )
    assert moved <= (0 if double else 2)


def test_pure_state_batch_policy_matches_pulser_tpu(jax_unsharded):
    """The step policy of the pure-state batch reads the per-trajectory
    shims: both packages build the same plan from the same draws."""
    seq, noise = _sequence(), _noise(**PURE_NOISE)
    jemu, temu = _both(seq, noise)
    jb, tb = jemu._noisy_coeff_batch(), temu._noisy_coeff_batch()
    assert len(tb.shims) == len(jb.shims) == len(tb.reps)
    for got, want in zip(tb.shims, jb.shims):
        assert type(got).__name__ == type(want).__name__ == "_CoeffShim"
        assert got.max_flip_gap == want.max_flip_gap > 0
        assert np.array_equal(got.amp_coeffs, np.asarray(want.amp_coeffs))
        assert np.array_equal(got.det_coeffs, np.asarray(want.det_coeffs))
    opts_t, opts_j = {}, {}
    temu._validate_options(opts_t)
    jemu._validate_options(opts_j)
    step_t = temu._coarse_ip_step("k", 1e-3, 12.0, tb.shims, opts_t)
    step_j = jemu._coarse_ip_step("k", 1e-3, 12.0, jb.shims, opts_j)
    assert step_t == step_j and step_t[1]
    # The whole policy of the batch, in its one home, against the JAX
    # package's steps: sticky quantized step, cap, coarsening, marks
    knots = np.asarray(jb.template.sampling_times)
    base = min(float(np.median(np.diff(knots))), 1e-3)
    fine = jemu._sticky_quantized_step(
        "sesolve_batch", base, 0.8 / max(1.3 * 12.0, 1e-9)
    )
    fine = min(fine, float(opts_j["max_step"]))
    want = jemu._coarse_ip_step(
        "sesolve_batch_coarse", fine, 12.0, jb.shims, opts_j
    )
    got = temu._step_policy(
        tb.template, 12.0, "sesolve_batch", 1.3, tb, opts_t
    )
    assert (got.max_step, got.coarsen) == want and got.coarsen
    assert not (got.mcwf_ip or got.mesolve_ip)
    assert temu._sticky_steps == jemu._sticky_steps
    marks, want_marks = got.breakpoints(), jemu._sharp_knots(jb, knots)
    assert (marks is None) == (want_marks is None)
    if want_marks is not None:
        assert np.array_equal(marks, np.asarray(want_marks))


def test_spd16_batch_inputs_match_pulser_tpu(jax_unsharded, monkeypatch):
    """SPD16 (the 16-atom sweep under SPAM, doppler and amplitude noise)
    with 4 trajectories, in single precision: from one numpy seed both
    packages draw the same coefficient batch, build the same batched plan
    and hand the batched solve the same per-trajectory diagonals, bit for
    bit. The solves themselves (2^16 amplitudes) are not run."""
    import chip_smoke
    from pulser_tpu.emulator import simulation as jax_sim

    seq, noise = chip_smoke.spd16_sequence(tpu, runs=4)
    assert set(noise.noise_types) == {"SPAM", "doppler", "amplitude"}

    class Stop(Exception):
        pass

    captured = {}

    def recorder(key):
        def record(*args, **kwargs):
            captured[key] = args
            raise Stop

        return record

    monkeypatch.setattr(jax_sim, "sesolve_rk4_batched", recorder("jax"))
    monkeypatch.setattr(torch_solver, "sesolve_rk4_batched", recorder("port"))
    jax.config.update("jax_enable_x64", False)
    try:
        jemu, temu = _both(seq, noise)
        jb, tb = jemu._noisy_coeff_batch(), temu._noisy_coeff_batch()
        for emu in (jemu, temu):
            np.random.seed(SEED)
            with pytest.raises(Stop):
                emu.run()
    finally:
        jax.config.update("jax_enable_x64", True)
    assert tb.reps == jb.reps and len(tb.reps) == 4
    for name in ("amp", "det", "diags"):
        assert np.array_equal(
            np.asarray(getattr(tb, name)), np.asarray(getattr(jb, name))
        ), name
    jargs, targs = captured["jax"], captured["port"]
    assert targs[3:6] == jargs[3:6] and targs[5] == 16  # pairs, d, n
    jplans, tplans = jargs[1], targs[1]
    assert tplans.n_traj == jplans.n_traj == 4
    jplan, tplan = jplans.plan, tplans.plan
    for field in (
        "dts", "store_idx", "grid", "eval_times", "eval_map", "seg_map",
        "seg_dts", "eval_det_cum", "knots",
    ):
        assert np.array_equal(
            getattr(tplan, field), np.asarray(getattr(jplan, field))
        ), field
    assert (tplan.n_eval, tplan.eval_idx0) == (jplan.n_eval, jplan.eval_idx0)
    assert tplan.stage_arrays.keys() == jplan.stage_arrays.keys()
    for name, arr in tplan.stage_arrays.items():
        assert np.array_equal(arr, np.asarray(jplan.stage_arrays[name])), name
    for got, want in zip(tplan.stage_knots, jplan.stage_knots):
        assert np.array_equal(got, np.asarray(want))
    # The per-trajectory interaction diagonals, (4, 2^16)
    diags = np.asarray(targs[2])
    assert diags.shape == (4, 1 << 16)
    assert np.array_equal(diags, np.asarray(jargs[2]))
    # The trajectories differ in their drives (amplitude and doppler)
    amp, det = np.asarray(tb.amp), np.asarray(tb.det)
    assert np.max(np.abs(amp[0] - amp[1])) > 0
    assert np.max(np.abs(det[0] - det[1])) > 0


def test_pure_state_run_twice_and_progress(jax_unsharded, capsys):
    """A second run() redraws the trajectories from the same point of
    the RNG stream as the JAX package's."""
    seq, noise = _sequence(), _noise(**PURE_NOISE)
    jemu, temu = _both(seq, noise)
    np.random.seed(5)
    jemu.run()
    j2 = jemu.run()
    j_after = np.random.rand()
    np.random.seed(5)
    temu.run()
    t2 = temu.run(print_progress=True)
    assert np.random.rand() == j_after
    assert "(batched)" in capsys.readouterr().out
    assert [r.n_samples for r in t2] == [r.n_samples for r in j2] == [24, 24]


def test_spam_with_another_initial_state_raises():
    """State-preparation errors assume the all-ground initial state."""
    np.random.seed(SEED)
    emu = _port_emulator(_sequence(), _noise(**PURE_NOISE))
    psi = np.zeros(16, complex)
    psi[0] = 1.0
    emu.set_initial_state(psi)
    with pytest.raises(NotImplementedError, match="different from the ground"):
        emu.run()


def test_master_equation_solver_raises():
    """``Solver.MESOLVER`` under this file's noise runs now: one density
    matrix per trajectory in one batched solve on the interaction-picture
    grid, the same seeded counts as the JAX package's, the RNG stream
    left at the same point."""
    from pulser_tpu.emulator.simulation import Solver as JaxSolver

    seq, noise = _sequence(), _noise()
    np.random.seed(SEED)
    jres = _jax_emulator(seq, noise, solver=JaxSolver.MESOLVER).run()
    j_after = np.random.rand()
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # complex128, as the JAX side
    try:
        np.random.seed(SEED)
        tres = _port_emulator(seq, noise, solver=Solver.MESOLVER).run()
    finally:
        torch.set_default_dtype(old)
    assert np.random.rand() == j_after
    info = torch_solver.last_solve_info
    assert info["kind"] == "mesolve_batched_cpu" and info["ip"]
    assert [dict(r.bitstring_counts) for r in tres] == [
        dict(r.bitstring_counts) for r in jres
    ]


#: Pulser's effective-noise Pauli channel, X, Y and Z in the ground-
#: rydberg basis order, strong enough that the 400 ns pulse jumps.
PAULIS = [
    np.array(p, dtype=complex)
    for p in ([[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]])
]


@pytest.fixture
def jax_f32(monkeypatch):
    """The JAX package in single precision, on its default routes."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def test_pauli_channel_run_matches_pulser_tpu(jax_f32, monkeypatch):
    """The lab-frame route end to end: the same seeded counts as the JAX
    package's vmapped XLA scan plus host sampling, away from bin edges
    (each draw within 1e-5 of a cumsum edge may move one count)."""
    seq = _sequence()
    noise = _noise(
        **NOISE, eff_noise_rates=[0.3] * 3, eff_noise_opers=PAULIS
    )
    assert "eff_noise" in noise.noise_types
    np.random.seed(SEED)
    jres = _jax_emulator(seq, noise).run()
    assert jax_solver.last_solve_info["kind"] == "mcwf_batched"
    jax_after = np.random.rand()

    captured = {}
    sample = torch_sim._host_sample_codes

    def record(states, ns, rnd):
        captured.update(states=states, ns=ns, rnd=rnd)
        return sample(states, ns, rnd)

    monkeypatch.setattr(torch_sim, "_host_sample_codes", record)
    np.random.seed(SEED)
    tres = _port_emulator(seq, noise).run()
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_torch" and info["n_cops"] == 4
    assert info["n_steps"] == jax_solver.last_solve_info["n_steps"]
    assert np.random.rand() == jax_after
    assert isinstance(tres, NoisyResults)
    assert tres.n_measures == jres.n_measures == 24

    # Draws near a bin edge of their (trajectory, time) entry
    states, ns, rnd = captured["states"], captured["ns"], captured["rnd"]
    dim = states.shape[-1]
    cum = np.cumsum((np.abs(states) ** 2)[..., ::-1].reshape(-1, dim), 1)
    v = np.repeat(cum[:, -1], ns) * rnd
    edge = np.min(np.abs(v[:, None] - np.repeat(cum, ns, 0)), axis=1)
    near = int(np.count_nonzero(edge <= EDGE_TOL))
    moved = 0
    for t_res, j_res in zip(tres, jres):
        tc, jc = t_res.bitstring_counts, j_res.bitstring_counts
        assert sum(tc.values()) == sum(jc.values()) == 24
        moved += sum(
            abs(tc.get(k, 0) - jc.get(k, 0)) for k in set(tc) | set(jc)
        )
    print(f"{near} draws within {EDGE_TOL} of a bin edge")
    assert moved <= 2 * near


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    """Given no device, the entry points run on the card; without one
    they raise instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        torch_solver._resolve_device(None)
    assert torch_solver._resolve_device("cpu") == torch.device("cpu")
    seq = _sequence()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEmulator(
            from_jax_samples(tpu.sampler.sample(seq)),
            from_jax_register(seq.register),
            from_jax_device(seq.device),
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_solver.sesolve_rk4_batched(
            np.ones(4, np.complex64), None, None, ((1, 0, 0),), 2, 2, True
        )
    # ... the noisy emulator of the pure-state batch included
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TorchEmulator(
            from_jax_samples(tpu.sampler.sample(seq)),
            from_jax_register(seq.register),
            from_jax_device(seq.device),
            noise_model=from_jax_noise_model(_noise(**PURE_NOISE)),
        )
