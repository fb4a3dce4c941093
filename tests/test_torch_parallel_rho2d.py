"""Row-sharded density matrices and the 2-D trajectory × state mesh.

The remaining cases of ``tests/test_parallel.py``, ported as in
``test_torch_parallel_traj.py``: the port's side in a world of
:data:`WORLD` CPU ranks (ρ's rows over all of them; a 2 × 2 mesh), the
JAX side on a ``Mesh`` of the same shape from the conftest's virtual
devices. Port sharded against JAX sharded: 1e-10 in complex128; against
port serial: 1e-12; seeded counts equal.
"""

from __future__ import annotations

import numpy as np
import pytest

import pulser_tpu_torch as ptt
from pulser_tpu_torch.ops import solver as tsolver
from pulser_tpu_torch.parallel import RankPool, comm, mesh2d, state_sharding

from test_torch_parallel_traj import WORLD, jax_mesh, on_ranks

PAIRS = ((1, 0, 0),)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(
        WORLD, str(tmp_path_factory.mktemp("store") / "store"), timeout_s=120
    ) as p:
        yield p




def _rho_case(build_plan):
    n = 5
    rng = np.random.default_rng(7)
    knots = np.linspace(0.0, 0.3, 16)
    eval_times = np.array([0.0, 0.15, 0.3])
    amp = rng.uniform(1, 5, size=(1, n, 16)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, (1, n, 16))
    )
    det = rng.normal(0, 3, size=(1, n, 16))
    plan = build_plan(
        knots, {"amp": amp, "det": det}, eval_times, max_step=1e-3
    )
    diag = rng.uniform(0, 10, size=2**n)
    c_deph = np.sqrt(0.5) * np.diag([1.0, -1.0]).astype(complex)
    c_rel = np.sqrt(0.3) * np.array([[0, 1], [0, 0]], complex)
    psi0 = rng.normal(size=2**n) + 1j * rng.normal(size=2**n)
    psi0 /= np.linalg.norm(psi0)
    return plan, diag, [c_deph, c_rel], np.outer(psi0, psi0.conj()), n


def _batch_2d_case(build_plan_batched):
    n, n_traj = 7, 6
    dim = 2**n
    rng = np.random.default_rng(17)
    n_knots = 11
    knots = np.linspace(0.0, 0.4, n_knots)
    eval_times = np.array([0.0, 0.2, 0.4])
    amp = np.stack(
        [
            rng.uniform(1, 4, size=(1, n, n_knots))
            * np.exp(1j * rng.uniform(0, 2 * np.pi, size=(1, n, 1)))
            for _ in range(n_traj)
        ]
    )
    det = np.stack(
        [
            rng.normal(0, 2, size=(1, n, 1)) * np.ones((1, n, n_knots))
            for _ in range(n_traj)
        ]
    )
    plans = build_plan_batched(
        knots, {"amp": amp, "det": det}, eval_times, max_step=2e-3
    )
    diags = np.stack([rng.uniform(0, 6, dim) for _ in range(n_traj)])
    psi0 = np.zeros(dim, complex)
    psi0[-1] = 1.0
    return psi0, plans, diags, n


def _dephasing_sequence(P):
    from test_torch_parallel_traj import mod_device

    seq = P.Sequence(
        P.Register.square(2, spacing=7.0, prefix="q"), mod_device(P)
    )
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(300, 2 * np.pi, 1.0, 0.0), "ryd")
    return seq


def _six_atoms(P):
    reg = P.Register.rectangle(2, 3, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(300, 2 * np.pi, -1.0, 0.0), "ryd")
    return seq


OBS = np.diag([1, 0] * 8).astype(complex)


# -- the rank-side scenarios ----------------------------------------------


def _rho(sharded):
    plan, diag, cops, rho0, n = _rho_case(tsolver.build_plan)
    mesh = comm.make_mesh((WORLD,), ("state",)) if sharded else None
    return tsolver.mesolve_rk4(
        rho0, plan, diag, PAIRS, 2, n, cops, dtype=np.complex128,
        state_mesh=mesh, device="cpu",
    )


def _rho_emulation():
    """⟨OBS⟩ of the dephasing run, and the state mesh the emulator took."""
    from pulser_tpu_torch.emulator import TorchEmulator

    meshes = []
    orig = state_sharding.default_state_mesh

    def spy(*args, **kwargs):
        mesh = orig(*args, **kwargs)
        meshes.append(None if mesh is None else mesh.size())
        return mesh

    state_sharding.default_state_mesh = spy
    try:
        res = TorchEmulator.from_sequence(
            _dephasing_sequence(ptt),
            noise_model=ptt.NoiseModel(dephasing_rate=0.2),
            torch_device="cpu",
        ).run()
    finally:
        state_sharding.default_state_mesh = orig
    return np.asarray(res.expect([OBS])[0], float), meshes


def _batch_2d(sharded):
    psi0, plans, diags, n = _batch_2d_case(tsolver.build_plan_batched)
    if not sharded:
        return tsolver.sesolve_rk4_batched(
            psi0, plans, diags, PAIRS, 2, n, True, dtype=np.complex128,
            device="cpu",
        )
    mesh = comm.make_mesh((2, WORLD // 2), ("traj", "state"))
    return mesh2d.sesolve_ip_2d_sharded(
        psi0, plans, diags, PAIRS, n, mesh, dtype=np.complex128, device="cpu"
    )


def _six_atom_counts():
    from pulser_tpu_torch.emulator import TorchEmulator

    mesh = mesh2d.default_2d_mesh(6, 5)
    tsolver.last_solve_info.clear()
    np.random.seed(29)
    nm = ptt.NoiseModel(
        amp_sigma=0.05, laser_waist=120.0, runs=5, samples_per_run=2
    )
    res = TorchEmulator.from_sequence(
        _six_atoms(ptt), noise_model=nm, torch_device="cpu"
    ).run()
    layout = None if mesh is None else tuple(mesh.shape)
    return (
        layout,
        tsolver.last_solve_info.get("kind"),
        [dict(r) for r in res.results],
    )


def _policy():
    def layout(n, n_traj):
        m = mesh2d.default_2d_mesh(n, n_traj)
        if m is None:
            return None
        names = m.mesh_dim_names
        return {name: int(m.shape[names.index(name)]) for name in names}

    return [layout(7, 8), layout(5, 8), layout(7, 1)]


# -- the tests -------------------------------------------------------------


def test_mesolve_rho_sharded_matches_serial(pool):
    """ρ's rows over 4 ranks with a diagonal (dephasing) and an
    off-diagonal (relaxation: the L ρ L† column moves) collapse operator,
    in the lab frame."""
    from pulser_tpu.ops.solver import build_plan, mesolve_rk4

    sharded = on_ranks(pool, _rho, True)
    serial = on_ranks(pool, _rho, False)
    np.testing.assert_allclose(sharded, serial, atol=1e-12, rtol=0)
    plan, diag, cops, rho0, n = _rho_case(build_plan)
    ref = mesolve_rk4(
        rho0, plan, diag, PAIRS, 2, n, cops, dtype=np.complex128,
        state_mesh=jax_mesh((WORLD,), ("state",)),
    )
    np.testing.assert_allclose(sharded, ref, atol=1e-10, rtol=0)
    traces = np.einsum("tii->t", sharded)
    np.testing.assert_allclose(traces.real, 1.0, atol=1e-5)


def test_mesolve_rho_sharded_rejects_bad_mesh():
    """A rank count that does not divide 2^N fails loudly."""
    from jax.sharding import Mesh

    import jax
    from pulser_tpu.ops.solver import build_plan, mesolve_rk4
    from torch_parity import StubMesh

    n = 2
    knots = np.linspace(0.0, 0.1, 4)
    coeffs = {"amp": np.ones((1, n, 4), complex), "det": np.zeros((1, n, 4))}
    rho0 = np.eye(4, dtype=complex) / 4
    tplan = tsolver.build_plan(knots, coeffs, np.array([0.1]), max_step=1e-3)
    with pytest.raises(ValueError, match="cannot shard a dim-4 density"):
        tsolver.mesolve_rk4(
            rho0, tplan, np.zeros(4), PAIRS, 2, n, [],
            state_mesh=StubMesh(8), device="cpu",
        )
    plan = build_plan(knots, coeffs, np.array([0.1]), max_step=1e-3)
    mesh = Mesh(np.array(jax.devices()), axis_names=("state",))
    with pytest.raises(ValueError, match="cannot shard a dim-4 density"):
        mesolve_rk4(
            rho0, plan, np.zeros(4), PAIRS, 2, n, [], state_mesh=mesh
        )


def test_emulator_uses_rho_sharding(pool, monkeypatch):
    """With the ρ threshold lowered to 4, the emulator's master-equation
    solve row-shards ρ over the world and matches the serial run."""
    env = {"PULSER_TPU_RHO_SHARD_MIN_QUBITS": "4"}
    exp, meshes = on_ranks(pool, _rho_emulation, env=env, x64=True)
    assert meshes == [WORLD]
    exp_serial, meshes = on_ranks(
        pool, _rho_emulation,
        env={**env, "PULSER_TPU_DISABLE_SHARDING": "1"}, x64=True,
    )
    assert meshes == [None]
    np.testing.assert_allclose(exp, exp_serial, atol=1e-12, rtol=0)
    import pulser_tpu as tpu
    from pulser_tpu.emulator import TpuEmulator

    monkeypatch.setenv("PULSER_TPU_RHO_SHARD_MIN_QUBITS", "4")
    res = TpuEmulator.from_sequence(
        _dephasing_sequence(tpu), noise_model=tpu.NoiseModel(dephasing_rate=0.2)
    ).run()
    np.testing.assert_allclose(
        exp, np.asarray(res.expect([OBS])[0], float), atol=1e-10, rtol=0
    )


def test_sesolve_ip_2d_mesh_matches_batched(pool):
    """A 2 × 2 trajectory × state mesh equals the plain batch: the traj
    axis without a collective, XOR-partner exchanges on the state axis."""
    from pulser_tpu.ops.solver import build_plan_batched
    from pulser_tpu.parallel.mesh2d import sesolve_ip_2d_sharded

    sharded = on_ranks(pool, _batch_2d, True)
    serial = on_ranks(pool, _batch_2d, False)
    assert sharded.shape == serial.shape == (6, 3, 2**7)
    np.testing.assert_allclose(sharded, serial, atol=1e-12, rtol=0)
    psi0, plans, diags, n = _batch_2d_case(build_plan_batched)
    ref = sesolve_ip_2d_sharded(
        psi0, plans, diags, PAIRS, n,
        jax_mesh((2, WORLD // 2), ("traj", "state")), dtype=np.complex128,
    )
    np.testing.assert_allclose(sharded, ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(
        np.linalg.norm(sharded[:, -1], axis=-1), 1.0, atol=1e-9
    )


def test_emulator_noisy_run_routes_to_2d_mesh(pool, monkeypatch):
    """A forced 2 × 2 mesh carries the pure-state noisy batch (5
    trajectories, padded to 6) and reproduces the serial counts and the
    JAX package's on its own 2 × 2 mesh."""
    env = {"PULSER_TPU_TRAJ_STATE_MESH": "2x2"}
    layout, kind, counts = on_ranks(pool, _six_atom_counts, env=env, x64=True)
    assert layout == (2, 2) and kind == "sesolve_2d_sharded_torch"
    layout, kind, serial = on_ranks(
        pool, _six_atom_counts,
        env={"PULSER_TPU_DISABLE_SHARDING": "1"}, x64=True,
    )
    assert layout is None and kind == "sesolve_batched_torch"
    assert counts == serial
    import pulser_tpu as tpu
    from pulser_tpu.emulator import TpuEmulator
    from pulser_tpu.parallel import mesh2d as jax_mesh2d

    monkeypatch.setenv("PULSER_TPU_TRAJ_STATE_MESH", "2x2")
    assert jax_mesh2d.default_2d_mesh(6, 5) is not None
    np.random.seed(29)
    nm = tpu.NoiseModel(
        amp_sigma=0.05, laser_waist=120.0, runs=5, samples_per_run=2
    )
    res = TpuEmulator.from_sequence(_six_atoms(tpu), noise_model=nm).run()
    assert counts == [dict(r) for r in res.results]


def test_default_2d_mesh_policy(pool, monkeypatch):
    """The automatic 2-D mesh engages only past the state threshold with
    at least 4 ranks and 2 trajectories, the state axis first; the JAX
    package's policy on its 8 devices agrees."""
    from pulser_tpu.parallel import mesh2d as jax_mesh2d

    env = {"PULSER_TPU_STATE_SHARD_MIN_QUBITS": "6"}
    m, below, few = on_ranks(pool, _policy, env=env)
    assert m == {"traj": 2, "state": 2}
    assert below is None and few is None
    assert on_ranks(
        pool, _policy, env={**env, "PULSER_TPU_DISABLE_SHARDING": "1"}
    ) == [None, None, None]
    monkeypatch.setenv("PULSER_TPU_STATE_SHARD_MIN_QUBITS", "6")
    jm = jax_mesh2d.default_2d_mesh(7, 8)
    assert jm.shape["state"] >= 2 and jm.shape["traj"] >= 2
    assert jm.shape["state"] * jm.shape["traj"] <= 8
    assert jax_mesh2d.default_2d_mesh(5, 8) is None
    assert jax_mesh2d.default_2d_mesh(7, 1) is None
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    assert jax_mesh2d.default_2d_mesh(7, 8) is None
