"""State sharding of the port in a gloo world, against the JAX package.

The cases of ``tests/test_parallel.py`` that shard a statevector (qubits
in the interaction picture, XY mode, qutrits and d=4 qudits), ported as
in ``test_torch_parallel_traj.py``: the port's side in a world of
:data:`WORLD` CPU ranks (``k = 2`` sharded qubits), the JAX side on a
``Mesh`` of as many of the conftest's virtual devices. Port sharded
against JAX sharded: 1e-10 in complex128; against port serial: 1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest

import pulser_tpu_torch as ptt
from pulser_tpu_torch.ops import solver as tsolver
from pulser_tpu_torch.parallel import RankPool, comm, state_sharding

from test_torch_parallel_traj import (
    WORLD,
    _task,
    jax_mesh,
    on_ranks,
)

PAIRS = ((1, 0, 0),)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(
        WORLD, str(tmp_path_factory.mktemp("store") / "store"), timeout_s=120
    ) as p:
        yield p




def _state_case(build_plan, n, seed=2):
    rng = np.random.default_rng(seed)
    n_knots, t_end = 11, 0.25
    knots = np.linspace(0.0, t_end, n_knots)
    eval_times = np.array([0.0, t_end / 2, t_end])
    amp = rng.uniform(2, 8, size=(1, n, n_knots)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, size=(1, n, 1))
    )
    det = rng.normal(0, 4, size=(1, n, n_knots))
    plan = build_plan(
        knots, {"amp": amp, "det": det}, eval_times, max_step=1e-3
    )
    diag = rng.uniform(0, 25, size=2**n)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    return plan, diag, psi0


def _xy_case(build_plan, n):
    rng = np.random.default_rng(8)
    n_knots, t_end = 9, 0.2
    knots = np.linspace(0.0, t_end, n_knots)
    eval_times = np.array([0.0, t_end / 2, t_end])
    amp = rng.uniform(2, 6, size=(1, n, n_knots)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, size=(1, n, 1))
    )
    det = rng.normal(0, 3, size=(1, n, n_knots))
    plan = build_plan(
        knots, {"amp": amp, "det": det}, eval_times, max_step=1e-3
    )
    u = rng.normal(0, 2, size=(n, n))
    u = (u + u.T) / 2
    np.fill_diagonal(u, 0.0)
    diag = rng.uniform(0, 10, size=2**n)
    psi0 = np.zeros(2**n, complex)
    psi0[0] = 1.0
    return plan, u[None], diag, psi0


def _qudit_case(build_plan, n, d, pairs, seed):
    rng = np.random.default_rng(seed)
    nb = len(pairs)
    n_knots, t_end = 9, 0.15
    knots = np.linspace(0.0, t_end, n_knots)
    eval_times = np.array([0.0, t_end / 2, t_end])
    amp = rng.uniform(2, 6, size=(nb, n, n_knots)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, size=(nb, n, 1))
    )
    det = rng.normal(0, 3, size=(nb, n, n_knots))
    plan = build_plan(
        knots, {"amp": amp, "det": det}, eval_times, max_step=1e-3
    )
    diag = rng.uniform(0, 10, size=d**n)
    psi0 = np.zeros(d**n, complex)
    psi0[0] = 1.0
    return plan, diag, psi0


def _qudit_occ(pairs, n, d):
    idx = np.arange(d**n)
    occ = np.zeros((len(pairs), n, d**n))
    for b, (_, _, kp) in enumerate(pairs):
        for q in range(n):
            occ[b, q] = ((idx // (d ** (n - 1 - q))) % d == kp).astype(float)
    return occ


def _state_mesh():
    return comm.make_mesh((WORLD,), ("state",))


# -- the rank-side scenarios ----------------------------------------------


def _statevector(n, sharded):
    plan, diag, psi0 = _state_case(tsolver.build_plan, n)
    return tsolver.sesolve_rk4(
        psi0, plan, diag, PAIRS, 2, n, dtype=np.complex128, ip_occ=True,
        state_mesh=_state_mesh() if sharded else None, device="cpu",
    )


def _statevector_on_two(n):
    """The state sharded over the first 2 of the 4 ranks; ranks 2 and 3,
    outside the mesh, receive the result."""
    plan, diag, psi0 = _state_case(tsolver.build_plan, n)
    mesh = comm.make_mesh((2,), ("state",))
    out = tsolver.sesolve_rk4(
        psi0, plan, diag, PAIRS, 2, n, dtype=np.complex128, ip_occ=True,
        state_mesh=mesh, device="cpu",
    )
    return out, comm.in_mesh(mesh), state_sharding.default_state_mesh(n).size()


def _xy(n, sharded):
    plan, u, diag, psi0 = _xy_case(tsolver.build_plan, n)
    return tsolver.sesolve_rk4(
        psi0, plan, diag, ((0, 1, 1),), 2, n, xy_static=u, xy_indices=(0, 1),
        dtype=np.complex128, state_mesh=_state_mesh() if sharded else None,
        device="cpu",
    )


def _qudit(n, d, seed, sharded):
    pairs = ((1, 0, 0), (1, 2, 2))
    plan, diag, psi0 = _qudit_case(tsolver.build_plan, n, d, pairs, seed)
    return tsolver.sesolve_rk4(
        psi0, plan, diag, pairs, d, n, ip_occ=True, dtype=np.complex128,
        state_mesh=_state_mesh() if sharded else None, device="cpu",
    )


def _ryd_sequence(P):
    reg = P.Register.square(2, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.devices.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(300, 2 * np.pi, 2.0, 0.3), "ryd")
    return seq


def _mw_sequence(P):
    reg = P.Register.square(2, spacing=8.0, prefix="q")
    seq = P.Sequence(reg, P.devices.MockDevice)
    seq.declare_channel("mw", "mw_global")
    seq.add(P.Pulse.ConstantPulse(250, 2 * np.pi, 1.0, 0.2), "mw")
    return seq


def _qutrit_sequence(P):
    reg = P.Register.square(2, spacing=6.0, prefix="q")
    seq = P.Sequence(reg, P.devices.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_global")
    seq.add(P.Pulse.ConstantPulse(200, 2 * np.pi, 1.0, 0.0), "ryd")
    seq.add(
        P.Pulse.ConstantPulse(200, np.pi, -1.0, 0.5), "ram",
        protocol="no-delay",
    )
    return seq


SEQUENCES = {
    "ryd": _ryd_sequence,
    "mw": _mw_sequence,
    "qutrit": _qutrit_sequence,
}


def _final_state(P, Emulator, which, **kw) -> np.ndarray:
    sim = Emulator.from_sequence(SEQUENCES[which](P), **kw)
    return sim.run().get_final_state(ignore_global_phase=False).full()[:, 0]


def _port_routed(which: str) -> tuple[np.ndarray, dict[str, int]]:
    """The port's final state, and the calls each sharded solve took."""
    from pulser_tpu_torch.emulator import TorchEmulator

    calls = {}
    names = (
        "sesolve_ip_statevector_sharded",
        "xy_sesolve_statevector_sharded",
        "qudit_sesolve_ip_statevector_sharded",
    )
    saved = {name: getattr(state_sharding, name) for name in names}

    def spy(name):
        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*args, **kwargs)

        return wrapped

    for name in names:
        setattr(state_sharding, name, spy(name))
    try:
        psi = _final_state(ptt, TorchEmulator, which, torch_device="cpu")
    finally:
        for name, fn in saved.items():
            setattr(state_sharding, name, fn)
    return psi, calls


def _jax_final(which: str) -> np.ndarray:
    import pulser_tpu as tpu
    from pulser_tpu.emulator import TpuEmulator

    return _final_state(tpu, TpuEmulator, which)


def _emulator_case(pool, monkeypatch, which, threshold, route):
    """The port routes ``which`` through ``route`` with the threshold
    lowered, matching its serial run and the JAX package's sharded one."""
    env = {"PULSER_TPU_STATE_SHARD_MIN_QUBITS": str(threshold)}
    psi, calls = on_ranks(pool, _port_routed, which, env=env, x64=True)
    assert calls == {route: 1}, calls
    psi_serial, calls = on_ranks(
        pool, _port_routed, which,
        env={**env, "PULSER_TPU_DISABLE_SHARDING": "1"}, x64=True,
    )
    assert calls == {}
    np.testing.assert_allclose(psi, psi_serial, atol=1e-12, rtol=0)
    monkeypatch.setenv("PULSER_TPU_STATE_SHARD_MIN_QUBITS", str(threshold))
    np.testing.assert_allclose(psi, _jax_final(which), atol=1e-10, rtol=0)
    return psi


# -- the tests -------------------------------------------------------------


def test_statevector_sharded_matches_single_device(pool):
    """12 qubits over 4 ranks (2 sharded qubits): the drives on them
    exchange XOR-partner blocks."""
    from pulser_tpu.ops.solver import build_plan
    from pulser_tpu.parallel import sesolve_ip_statevector_sharded

    n = 12
    shd = on_ranks(pool, _statevector, n, True)
    ref = on_ranks(pool, _statevector, n, False)
    assert shd.shape == ref.shape == (3, 2**n)
    np.testing.assert_allclose(shd, ref, atol=1e-12, rtol=0)
    plan, diag, psi0 = _state_case(build_plan, n)
    jax_shd = sesolve_ip_statevector_sharded(
        psi0, plan, diag, PAIRS, n, jax_mesh((WORLD,), ("state",)),
        dtype=np.complex128,
    )
    np.testing.assert_allclose(shd, jax_shd, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(shd[-1]), 1.0, atol=1e-8)


def test_ranks_outside_the_state_mesh_receive_the_result(pool):
    """A power-of-two mesh on part of the world (2 of 4 ranks, as
    ``default_state_mesh`` keeps in a world of 3): the ranks it leaves out
    return the same states, equal to the serial solve's; the default mesh
    of this world takes all 4 ranks."""
    n = 8
    results = pool.run(_task, _statevector_on_two, (n,), {}, False)
    serial = on_ranks(pool, _statevector, n, False)
    assert [r[1] for r in results] == [True, True, False, False]
    assert {r[2] for r in results} == {WORLD}
    for out, _, _ in results:
        np.testing.assert_array_equal(out, results[0][0])
    np.testing.assert_allclose(results[0][0], serial, atol=1e-12, rtol=0)


def test_statevector_sharded_rejects_bad_mesh():
    """2 qubits cannot split over 4 ranks, in either package."""
    from pulser_tpu.ops.solver import build_plan
    from pulser_tpu.parallel import sesolve_ip_statevector_sharded as jax_fn
    from torch_parity import StubMesh

    plan, diag, psi0 = _state_case(tsolver.build_plan, 2)
    with pytest.raises(ValueError, match="cannot shard 2 qubits over 4"):
        state_sharding.sesolve_ip_statevector_sharded(
            psi0, plan, diag, PAIRS, 2, StubMesh(WORLD), device="cpu"
        )
    with pytest.raises(ValueError, match="mesh size must be a power of two"):
        state_sharding.sesolve_ip_statevector_sharded(
            psi0, plan, diag, PAIRS, 2, StubMesh(3), device="cpu"
        )
    jplan, jdiag, _ = _state_case(build_plan, 2)
    with pytest.raises(ValueError, match="cannot shard 2 qubits over 4"):
        jax_fn(psi0, jplan, jdiag, PAIRS, 2, jax_mesh((WORLD,), ("state",)))


def test_emulator_uses_statevector_sharding(pool, monkeypatch):
    """With the threshold lowered to 4, the coherent solve of 4 atoms runs
    the distributed statevector."""
    _emulator_case(
        pool, monkeypatch, "ryd", 4, "sesolve_ip_statevector_sharded"
    )


def test_xy_statevector_sharded_matches_single_device(pool):
    """12-qubit XY mode: the flip-flop term lowers and raises the sharded
    qubits through XOR-partner exchanges."""
    from pulser_tpu.ops.solver import build_plan, sesolve_rk4

    n = 12
    shd = on_ranks(pool, _xy, n, True)
    ref = on_ranks(pool, _xy, n, False)
    assert shd.shape == ref.shape == (3, 2**n)
    np.testing.assert_allclose(shd, ref, atol=1e-12, rtol=0)
    plan, u, diag, psi0 = _xy_case(build_plan, n)
    jax_shd = sesolve_rk4(
        psi0, plan, diag, ((0, 1, 1),), 2, n, xy_static=u, xy_indices=(0, 1),
        dtype=np.complex128, state_mesh=jax_mesh((WORLD,), ("state",)),
    )
    np.testing.assert_allclose(shd, jax_shd, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(shd[-1]), 1.0, atol=1e-8)


def test_emulator_xy_uses_statevector_sharding(pool, monkeypatch):
    _emulator_case(
        pool, monkeypatch, "mw", 4, "xy_sesolve_statevector_sharded"
    )


def test_qutrit_basis_routes_to_qudit_sharding(pool, monkeypatch):
    """A qutrit-basis run above the threshold takes the embedded d=4
    qudit sharding, never the d=2 one."""
    psi = _emulator_case(
        pool, monkeypatch, "qutrit", 2, "qudit_sesolve_ip_statevector_sharded"
    )
    assert psi.shape == (3**4,)
    assert abs(np.linalg.norm(psi) - 1) < 1e-6


@pytest.mark.parametrize(
    "n,d,seed",
    [(8, 3, 12), (6, 4, 21)],
    ids=["qutrit_sharded_sesolve", "leakage_d4_sharded_sesolve"],
)
def test_qudit_sharded_sesolve_matches_serial(pool, n, d, seed):
    """8 qutrits (embedded into d=4; the ranks take the top 2 bits, digit
    0 whole) and 6 d=4 qudits: the ground-rydberg pair (1, 0) rides a pure
    exchange, the digital pair (1, 2) an exchange and a local bit
    reversal."""
    from pulser_tpu.ops.solver import build_plan, sesolve_rk4

    shd = on_ranks(pool, _qudit, n, d, seed, True)
    ref = on_ranks(pool, _qudit, n, d, seed, False)
    assert shd.shape == ref.shape == (3, d**n)
    np.testing.assert_allclose(shd, ref, atol=1e-12, rtol=0)
    pairs = ((1, 0, 0), (1, 2, 2))
    plan, diag, psi0 = _qudit_case(build_plan, n, d, pairs, seed)
    jax_shd = sesolve_rk4(
        psi0, plan, diag, pairs, d, n, ip_occ=_qudit_occ(pairs, n, d),
        dtype=np.complex128, state_mesh=jax_mesh((WORLD,), ("state",)),
    )
    np.testing.assert_allclose(shd, jax_shd, atol=1e-10, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(shd[-1]), 1.0, atol=1e-8)


def test_qudit_embed_indices_roundtrip():
    from pulser_tpu.parallel.state_sharding import qudit_embed_indices

    g4 = state_sharding.qudit_embed_indices(3, 3)
    # digits (a, b, c) -> a*16 + b*4 + c
    assert g4[0] == 0
    assert g4[1] == 1  # (0,0,1)
    assert g4[3] == 4  # (0,1,0)
    assert g4[9] == 16  # (1,0,0)
    assert g4[26] == 2 * 16 + 2 * 4 + 2
    assert len(np.unique(g4)) == 27
    np.testing.assert_array_equal(g4, qudit_embed_indices(3, 3))
