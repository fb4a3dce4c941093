"""Register noise in the port against pulser_tpu.

Register (position) noise jitters every atom of every noise trajectory
in three dimensions: one ``(N, 2)`` in-plane normal draw at σ_xy, then
one ``(N,)`` axial draw at σ_z, from the numpy global RNG, last among a
trajectory's draws. Each trajectory then carries its own ``Register3D``,
so its own interaction diagonal, its own step policy and its own
laser-waist profile. Held against the JAX package at 4 atoms:

- the jittered positions are bit-equal after one ``np.random.seed``, for
  2-D and 3-D registers and for coordinates given as torch tensors;
- the coefficient batch (diagonals, waist-scaled drive factors, flip
  gaps) and the step policy built from it are bit-equal;
- REGNOISE10's route on the card, the row-batched quantum-jump solve in
  single precision, gives the counts of the JAX rows kernel (interpret
  mode) and per-trajectory Rydberg populations within 1e-5;
- without collapse operators (the trajectory-batched K1's route, its
  plain version on the CPU) and with relaxation (the batched torch scan)
  the per-trajectory states agree within 1e-10 in complex128, and the
  seeded counts are equal.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import jax
import pulser_tpu as tpu
from pulser_tpu.emulator import TpuEmulator
from pulser_tpu.hamiltonian_data import hamiltonian_data as jax_hd
from pulser_tpu.ops import solver as jax_solver

import pulser_tpu_torch as ptt
from pulser_tpu_torch.emulator import TorchEmulator
from pulser_tpu_torch.hamiltonian_data import hamiltonian_data as torch_hd
from pulser_tpu_torch.ops import solver as torch_solver
from torch_parity import assert_lindblad_policy_matches

torch.set_num_threads(1)

SEED = 1234
#: REGNOISE10's noise (``chip_smoke.regnoise10_sequence``) at 4 atoms and
#: 6 trajectories of 4 samples.
REGNOISE = dict(
    state_prep_error=0.005,
    p_false_pos=0.01,
    p_false_neg=0.02,
    temperature=50.0,
    amp_sigma=0.02,
    laser_waist=175.0,
    dephasing_rate=0.05,
    trap_waist=1.0,
    trap_depth=150.0,
    runs=6,
    samples_per_run=4,
)
#: Without dephasing: no collapse operators.
PURE = {k: v for k, v in REGNOISE.items() if k != "dephasing_rate"}
#: Relaxation is a matrix unit: the batched torch scan.
RELAX = dict(PURE, relaxation_rate=0.2)
POPULATION_TOL = 1e-5
STATE_TOL = 1e-10


def _sequence(P, shape=(2, 2)):
    """NOISY10's sweep, shortened, on a 2x2 register at 7 µm."""
    reg = P.Register.rectangle(*shape, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    om = 2 * np.pi * 1.5
    seq.add(
        P.Pulse.ConstantDetuning(P.RampWaveform(200, 0.0, om), -8.0, 0.0),
        "ryd",
    )
    seq.add(
        P.Pulse.ConstantAmplitude(om, P.RampWaveform(400, -8.0, 4.0), 0.0),
        "ryd",
    )
    return seq


def _noise(P, params):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # runs=
        return P.NoiseModel(**params)


def _emulator(P, params, seed=SEED):
    np.random.seed(seed)
    if P is tpu:
        return TpuEmulator.from_sequence(
            _sequence(P), noise_model=_noise(P, params),
            evaluation_times="Minimal",
        )
    return TorchEmulator.from_sequence(
        _sequence(P), noise_model=_noise(P, params),
        evaluation_times="Minimal", torch_device="cpu",
    )


@pytest.fixture
def jax_unsharded(monkeypatch):
    """The JAX package on one device, on its default (XLA) routes."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    monkeypatch.delenv("PULSER_TPU_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("PULSER_TPU_SESOLVE_PALLAS_BATCHED", raising=False)


@pytest.fixture
def jax_rows(monkeypatch):
    """The JAX package on its rows kernel (interpret mode), in single
    precision: REGNOISE10's route."""
    monkeypatch.setenv("PULSER_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PULSER_TPU_MCWF_ROWS", "1")
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


@pytest.fixture
def double():
    """The port in complex128, as the JAX side under jax_enable_x64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def _qubits(P, kind):
    """``(qubits, coordinate tensor or None)`` of the register to jitter."""
    if kind == "3d":
        reg = P.Register3D.cuboid(2, 2, 2, spacing=6.0, prefix="q")
        return reg.qubits, None
    reg = P.Register.rectangle(2, 3, spacing=7.0, prefix="q")
    if kind == "tensor" and P is ptt:
        coords = torch.tensor(
            np.stack([np.asarray(p) for p in reg.qubits.values()]),
            requires_grad=True,
        )
        return P.Register(dict(zip(reg.qubit_ids, coords))).qubits, coords
    return reg.qubits, None


@pytest.mark.parametrize("kind", ["2d", "3d", "tensor"])
def test_noisy_positions_are_the_jax_draws(double, kind):
    """After one seed both packages draw the same jitter in the same
    order: equal positions, bit for bit, and the RNG left at the same
    point. Tensor coordinates keep their graph through the z = 0 pad."""
    out = []
    for P, hd in ((tpu, jax_hd), (ptt, torch_hd)):
        noise = _noise(
            P, dict(trap_waist=1.0, trap_depth=150.0, temperature=50.0)
        )
        qubits, coords = _qubits(P, kind)
        np.random.seed(SEED)
        reg = hd._noisy_register(qubits, noise)
        after = np.random.rand()
        assert type(reg).__name__ == "Register3D"
        out.append((reg, after, coords))
    (jreg, j_after, _), (treg, t_after, coords) = out
    assert t_after == j_after
    assert treg.qubit_ids == jreg.qubit_ids
    for qid in jreg.qubit_ids:
        got = treg.qubits[qid].as_array(detach=True)
        want = np.asarray(jreg.qubits[qid].as_array(detach=True))
        assert got.shape == (3,)
        assert np.array_equal(got, want), qid
    if coords is not None:
        pos = torch.stack([p.as_tensor() for p in treg.qubits.values()])
        (grad,) = torch.autograd.grad(pos.sum(), coords)
        assert torch.equal(grad, torch.ones_like(coords))


def test_trajectories_carry_their_own_registers():
    """Each noise trajectory's register is its own ``Register3D``, equal
    to the JAX package's bit for bit, and so is its interaction matrix."""
    jemu = _emulator(tpu, REGNOISE)
    temu = _emulator(ptt, REGNOISE)
    jt = jemu._hamiltonian_data.noise_trajectories
    tt = temu._hamiltonian_data.noise_trajectories
    assert len(tt) == len(jt) == 6
    seen = set()
    for (t, t_reps), (j, j_reps) in zip(tt, jt):
        assert t_reps == j_reps
        assert type(t.register).__name__ == "Register3D"
        seen.add(id(t.register))
        for qid in j.register.qubit_ids:
            assert np.array_equal(
                t.register.qubits[qid].as_array(detach=True),
                np.asarray(j.register.qubits[qid].as_array(detach=True)),
            )
        assert np.array_equal(
            t.interaction_matrix.as_array(detach=True),
            np.asarray(j.interaction_matrix.as_array(detach=True)),
        )
    assert len(seen) == 6


def test_coefficient_batch_under_register_noise_is_bit_equal(jax_rows):
    """The batch's diagonals differ per trajectory; the laser-waist
    fractions (3-D positions, one memo entry per register) scale each
    trajectory's drive factors; all of it, and the step policy, is
    bit-equal to the JAX package's."""
    jemu = _emulator(tpu, REGNOISE)
    temu = _emulator(ptt, REGNOISE)
    jb = jemu._fast_coeff_batch(
        list(jemu._hamiltonian_data.noise_trajectories)
    )
    tb = temu._fast_coeff_batch(
        list(temu._hamiltonian_data.noise_trajectories)
    )
    assert tb.reps == jb.reps
    assert np.array_equal(tb.diags, np.asarray(jb.diags))
    assert len(np.unique(tb.diags, axis=0)) == len(tb.diags)
    assert np.array_equal(tb._flip_gaps, np.asarray(jb._flip_gaps))
    assert len(set(tb._flip_gaps.tolist())) > 1
    for got, want in zip(
        tb.amp_factors + tb.det_factors, jb.amp_factors + jb.det_factors
    ):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    # The waist profile differs between trajectories (their atoms moved)
    amp_rows = np.asarray(tb.amp_factors[1])
    assert len(np.unique(amp_rows.reshape(len(tb.reps), -1), axis=0)) > 1
    knots = np.asarray(jb.template.sampling_times)
    for got, want in zip(
        temu._factored_policy(tb, knots), jemu._factored_policy(jb, knots)
    ):
        if want is None:
            assert got is None
        else:
            assert np.array_equal(got, np.asarray(want))
    # The whole policy of the batch, in its one home
    assert_lindblad_policy_matches(temu, jemu, tb, jb)


def _trajectory_populations(args, solve, n) -> np.ndarray:
    """``(B, n)`` final Rydberg populations of each trajectory of a
    recorded ``mcsolve_rows_codes`` call, recomputed by ``solve``."""
    states = np.asarray(solve(args), np.complex128)[:, -1]
    probs = np.abs(states) ** 2
    idx = np.arange(probs.shape[1])
    ryd = np.stack([((idx >> (n - 1 - q)) & 1) == 0 for q in range(n)])
    return probs @ ryd.T.astype(float)


def test_rows_route_matches_the_jax_rows_kernel(jax_rows, monkeypatch):
    """REGNOISE10's route at 4 atoms in single precision: the port's rows
    solve (its plain version on the CPU) against the JAX rows kernel in
    interpret mode. Equal seeded counts at every evaluation time, the
    RNG left at the same point, per-trajectory Rydberg populations within
    1e-5."""
    from pulser_tpu.emulator import simulation as jax_sim

    recorded = {}

    def recorder(module, key):
        fused = module.mcsolve_rows_codes

        def record(*args, **kwargs):
            recorded[key] = (args, kwargs)
            return fused(*args, **kwargs)

        monkeypatch.setattr(module, "mcsolve_rows_codes", record)

    recorder(jax_sim._solver_mod, "jax")
    recorder(torch_solver, "torch")
    jres = _emulator(tpu, REGNOISE).run()
    assert jax_solver.last_solve_info["kind"] == "mcwf_rows_pallas"
    j_after = np.random.rand()
    tres = _emulator(ptt, REGNOISE).run()
    info = torch_solver.last_solve_info
    assert info["kind"] == "mcwf_rows_torch"
    assert info["n_steps"] == jax_solver.last_solve_info["n_steps"]
    assert np.random.rand() == j_after
    assert [dict(r.bitstring_counts) for r in tres] == [
        dict(r.bitstring_counts) for r in jres
    ]

    (ja, jkw), (ta, _) = recorded["jax"], recorded["torch"]
    assert len(np.unique(np.asarray(ta[2]).reshape(6, -1), axis=0)) == 6
    want = _trajectory_populations(
        ja,
        lambda a: jax_solver.mcsolve_rk4_batched(
            *a[:8], mesh=None,
            **{k: v for k, v in jkw.items() if k in ("dtype", "ip")},
        ),
        4,
    )
    got = _trajectory_populations(
        ta,
        lambda a: torch_solver.mcsolve_rk4_batched(
            *a[:8], dtype=a[0].dtype, ip=True, device="cpu"
        ),
        4,
    )
    assert np.max(np.abs(got - want)) <= POPULATION_TOL


@pytest.mark.parametrize(
    "params,kind",
    [(PURE, "sesolve_batched_torch"), (RELAX, "mcwf_batched_torch")],
    ids=["no_collapse_operators", "relaxation_scan"],
)
def test_batched_routes_match_in_double(jax_unsharded, double, params, kind):
    """Without collapse operators (K1 batched's route) and under
    relaxation (the torch scan): each trajectory's final state within
    1e-10 of the JAX package's in complex128, then equal seeded counts
    from a full run."""
    out = []
    for P in (tpu, ptt):
        emu = _emulator(P, params)
        runs = list(emu._noisy_runs(False))
        out.append(
            [np.asarray(r.states[-1].full()).ravel() for r, _ in runs]
        )
    assert torch_solver.last_solve_info["kind"] == kind
    assert len(out[0]) == len(out[1]) == 6
    for want, got in zip(*out):
        assert np.max(np.abs(got - want)) <= STATE_TOL

    jres = _emulator(tpu, params).run()
    j_after = np.random.rand()
    tres = _emulator(ptt, params).run()
    assert np.random.rand() == j_after
    assert [dict(r.bitstring_counts) for r in tres] == [
        dict(r.bitstring_counts) for r in jres
    ]
