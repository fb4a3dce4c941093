"""Trajectory sharding of the port in a gloo world, against the JAX package.

Each case of ``tests/test_parallel.py`` that shards trajectories, ported:
the port's side runs in a world of :data:`WORLD` CPU ranks
(:class:`pulser_tpu_torch.parallel.RankPool`, started once per module,
one torch thread a rank, a ``FileStore`` rendezvous under ``tmp_path``);
the JAX side runs in the test process on a ``Mesh`` of the same shape,
taken from the conftest's 8 virtual devices. Port sharded against JAX
sharded: 1e-10 in complex128; port sharded against port serial: 1e-12;
seeded counts equal; every rank returns the same result.

The rank-side functions live at module level and this module imports
neither ``jax`` nor ``pulser_tpu`` at its top (the ranks import it), so
the JAX side's imports sit inside the tests.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import pytest
import torch

import pulser_tpu_torch as ptt
from pulser_tpu_torch.ops import solver as tsolver
from pulser_tpu_torch.parallel import RankPool, comm, default_mesh

#: Ranks of the port's world, and devices of the JAX side's mesh.
WORLD = 4
PAIRS = ((1, 0, 0),)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(
        WORLD, str(tmp_path_factory.mktemp("store") / "store"), timeout_s=120
    ) as p:
        yield p


def _task(fn: Callable, args: tuple, env: dict, x64: bool) -> Any:
    """Runs ``fn(*args)`` on a rank with ``env`` set (and torch's default
    dtype at float64 with ``x64``), restoring both after."""
    saved = {k: os.environ.get(k) for k in env}
    dtype = torch.get_default_dtype()
    os.environ.update({k: v for k, v in env.items() if v is not None})
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
    if x64:
        torch.set_default_dtype(torch.float64)
    try:
        return fn(*args)
    finally:
        torch.set_default_dtype(dtype)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def on_ranks(
    pool: RankPool, fn: Callable, *args: Any, env: dict | None = None,
    x64: bool = False,
) -> Any:
    """``fn(*args)`` on every rank; asserts the ranks agree exactly and
    returns rank 0's result."""
    results = pool.run(_task, fn, args, dict(env or {}), x64)
    for r in results[1:]:
        _assert_same(results[0], r)
    return results[0]


def _assert_same(a: Any, b: Any) -> None:
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def jax_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A JAX ``Mesh`` of ``shape`` from the conftest's virtual devices."""
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axis_names=names)


def make_plans(build_plan, n_traj, n, n_knots=21, t_end=0.4, seed=0):
    """Random per-trajectory plans sharing one grid (like noise), from
    either package's ``build_plan``."""
    rng = np.random.default_rng(seed)
    knots = np.linspace(0.0, t_end, n_knots)
    eval_times = np.array([0.0, t_end / 2, t_end])
    plans, diags = [], []
    for _ in range(n_traj):
        phase = np.exp(1j * rng.uniform(0, 2 * np.pi, size=(1, n, 1)))
        amp = rng.uniform(1, 6, size=(1, n, n_knots)) * phase
        det = rng.normal(0, 3, size=(1, n, n_knots))
        plans.append(
            build_plan(
                knots, {"amp": amp, "det": det}, eval_times, max_step=1e-3
            )
        )
        diags.append(rng.uniform(0, 20, size=2**n))
    return plans, np.stack(diags)


def ip_occ(n, d=2, k=0):
    """Detuning-projector occupancies, as the JAX emulator builds them."""
    idx = np.arange(d**n)
    occ = np.zeros((1, n, d**n))
    for q in range(n):
        occ[0, q] = ((idx // (d ** (n - 1 - q))) % d == k).astype(float)
    return occ


def mod_device(P):
    """The Rydberg-global channel and the two DMMs of the JAX tests'
    ``mod_device`` fixture (modulated, with an EOM), in package ``P``."""
    ch = P.channels
    return P.devices.Device(
        name="ModDevice",
        dimensions=3,
        rydberg_level=70,
        max_atom_num=2000,
        max_radial_distance=1000,
        min_atom_distance=1,
        supports_slm_mask=True,
        channel_objects=(
            ch.Rydberg.Global(
                1000,
                200,
                clock_period=1,
                min_duration=1,
                mod_bandwidth=4.0,
                eom_config=ch.eom.RydbergEOM(
                    mod_bandwidth=30.0,
                    limiting_beam=ch.eom.RydbergBeam.RED,
                    max_limiting_amp=50 * 2 * np.pi,
                    intermediate_detuning=800 * 2 * np.pi,
                    controlled_beams=(ch.eom.RydbergBeam.BLUE,),
                ),
            ),
        ),
        dmm_objects=(
            ch.DMM(bottom_detuning=-100, total_bottom_detuning=-10000),
            ch.DMM(
                clock_period=4,
                mod_bandwidth=4.0,
                bottom_detuning=-50,
                total_bottom_detuning=-5000,
            ),
        ),
    )


def noisy_sequence(P):
    reg = P.Register.square(2, spacing=7.0, prefix="q")
    seq = P.Sequence(reg, mod_device(P))
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(400, 2 * np.pi, 1.0, 0.0), "ryd")
    return seq


OBS = np.diag([1, 0] * 8).astype(complex)


def emulate(P, Emulator, seed, nm_kw, extra=None, **kw):
    """``(⟨OBS⟩ per time, counts per time)`` of a seeded emulation."""
    np.random.seed(seed)
    sim = Emulator.from_sequence(
        noisy_sequence(P), noise_model=P.NoiseModel(**nm_kw), **kw
    )
    if extra is not None:
        extra(sim)
    res = sim.run()
    exp = np.asarray(res.expect([OBS])[0], float)
    return exp, [dict(r) for r in res.results]


def _port_emulate(seed, nm_kw, solver=None):
    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.emulator.simulation import Solver

    kw = {"torch_device": "cpu"}
    if solver is not None:
        kw["solver"] = getattr(Solver, solver)
    tsolver.last_solve_info.clear()
    exp, counts = emulate(ptt, TorchEmulator, seed, nm_kw, **kw)
    # The ranks the trajectories were split over
    return exp, counts, tsolver.last_solve_info.get("ranks")


def _jax_emulate(seed, nm_kw, solver=None):
    import pulser_tpu as tpu
    from pulser_tpu.emulator import TpuEmulator
    from pulser_tpu.emulator.simulation import Solver

    kw = {} if solver is None else {"solver": getattr(Solver, solver)}
    return emulate(tpu, TpuEmulator, seed, nm_kw, **kw)


# -- the rank-side scenarios ----------------------------------------------


def _default_mesh_layout():
    mesh = default_mesh()
    return None if mesh is None else (mesh.size(), mesh.mesh_dim_names)


def _sesolve_batched(n, n_traj, sharded):
    plans, diags = make_plans(tsolver.build_plan, n_traj, n)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    return tsolver.sesolve_rk4_batched(
        psi0, plans, diags, PAIRS, 2, n, True, dtype=np.complex128,
        mesh=default_mesh() if sharded else None, device="cpu",
    )


def _mcsolve(sharded):
    n = 3
    plans, diags = make_plans(tsolver.build_plan, 1, n, seed=4)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    c_op = np.sqrt(0.4) * np.array([[0, 0], [1, 0]], complex)
    return tsolver.mcsolve_rk4(
        psi0, plans[0], diags[0], PAIRS, 2, n, [c_op], ntraj=16, seed=11,
        dtype=np.complex128, mesh=default_mesh() if sharded else None,
        device="cpu",
    )


def _histogram_case():
    n, n_steps, n_traj = 4, 40, 16
    dim = 2**n
    rng = np.random.default_rng(9)
    psi0 = np.zeros(dim, complex)
    psi0[-1] = 1.0
    base = 0.5 * 2 * np.pi * np.ones((n_steps, 3, 1, n))
    fluct = 1.0 + 0.05 * rng.normal(size=(n_traj, 1, 1, 1, 1))
    amp_stages = (base[None] * fluct).astype(complex)
    det_stages = np.zeros((n_traj, n_steps, 3, 1, n))
    dts = np.full(n_steps, 1e-3)
    diag = rng.uniform(0, 30, size=dim)
    return psi0, amp_stages, det_stages, dts, diag, PAIRS, 2, n


def _histogram():
    from pulser_tpu_torch.parallel import run_trajectories_sharded

    hist = run_trajectories_sharded(
        default_mesh(), *_histogram_case(), device="cpu"
    )
    return hist.numpy()


def _lindblad_batched(kind, sharded):
    n = 3
    if kind == "mesolve":
        plans, diags = make_plans(tsolver.build_plan, 6, n, seed=7)
        psi0 = np.zeros(2**n, complex)
        psi0[0] = 1.0
        c_op = np.sqrt(0.25) * np.array([[1, 0], [0, -1]], complex)
        return tsolver.mesolve_rk4_batched(
            np.outer(psi0, psi0.conj()), plans, diags, PAIRS, 2, n, [c_op],
            dtype=np.complex128, mesh=default_mesh() if sharded else None,
            device="cpu",
        )
    plans, diags = make_plans(tsolver.build_plan, 5, n, seed=9)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    c_op = np.sqrt(0.5) * np.array([[0, 0], [1, 0]], complex)
    return tsolver.mcsolve_rk4_batched(
        psi0, plans, diags, PAIRS, 2, n, [c_op], [101, 202, 303, 404, 505],
        dtype=np.complex128, mesh=default_mesh() if sharded else None,
        device="cpu",
    )


def _error_text(fn, *args):
    """``fn(*args)``'s RuntimeError text, or None when it returns."""
    try:
        fn(*args)
    except RuntimeError as exc:
        return str(exc)
    return None


def _mcsolve_seeded_by_rank():
    """``mcsolve_rk4`` on the world's mesh, each rank with its own seed."""
    import torch.distributed as dist

    n = 3
    plans, diags = make_plans(tsolver.build_plan, 1, n, seed=4)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    c_op = np.sqrt(0.4) * np.array([[0, 0], [1, 0]], complex)
    return _error_text(
        lambda: tsolver.mcsolve_rk4(
            psi0, plans[0], diags[0], PAIRS, 2, n, [c_op], ntraj=8,
            seed=dist.get_rank(), dtype=np.complex128, mesh=default_mesh(),
            device="cpu",
        )
    )


def _emulate_seeded_by_rank(nm_kw):
    """A noisy emulation with numpy seeded by the rank (a parameter sweep
    that calls the emulator independently on every rank)."""
    import torch.distributed as dist

    return _error_text(_port_emulate, 100 + dist.get_rank(), nm_kw)


def _resolve_under_group(local_rank, n_cards, available):
    """``_resolve_device(None)`` with the card count and availability
    patched (this host has no card): the device, or the error text."""
    saved = (
        torch.cuda.is_available, torch.cuda.device_count,
        torch.cuda.current_device, os.environ.get("LOCAL_RANK"),
    )
    torch.cuda.is_available = lambda: available
    torch.cuda.device_count = lambda: n_cards
    torch.cuda.current_device = lambda: 0
    os.environ["LOCAL_RANK"] = str(local_rank)
    try:
        return str(tsolver._resolve_device(None))
    except RuntimeError as exc:
        return f"RuntimeError: {exc}"
    finally:
        (torch.cuda.is_available, torch.cuda.device_count,
         torch.cuda.current_device) = saved[:3]
        os.environ["LOCAL_RANK"] = saved[3]


# -- the tests -------------------------------------------------------------


def test_default_mesh_spans_the_world(pool):
    """The counterpart of ``test_conftest_provides_virtual_mesh``: the
    JAX side sees the conftest's 8 devices and a mesh over all of them;
    every rank of the port's world sees a mesh over every rank, and the
    test process, with no process group, none."""
    import jax
    from pulser_tpu.parallel import default_mesh as jax_default_mesh

    assert len(jax.devices()) == 8
    assert jax_default_mesh().shape["traj"] == 8
    assert on_ranks(pool, _default_mesh_layout) == (WORLD, ("traj",))
    assert not comm.world_ready() and default_mesh() is None


def test_default_mesh_disabled_by_env(pool, monkeypatch):
    from pulser_tpu.parallel import default_mesh as jax_default_mesh

    env = {"PULSER_TPU_DISABLE_SHARDING": "1"}
    assert on_ranks(pool, _default_mesh_layout, env=env) is None
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")
    assert jax_default_mesh() is None


def test_sesolve_batched_sharded_matches_serial(pool):
    """6 trajectories over 4 ranks: the padding path too."""
    from pulser_tpu.ops.solver import build_plan, sesolve_rk4_batched

    n = 4
    sharded = on_ranks(pool, _sesolve_batched, n, 6, True)
    serial = on_ranks(pool, _sesolve_batched, n, 6, False)
    assert sharded.shape == serial.shape == (6, 3, 2**n)
    np.testing.assert_allclose(sharded, serial, atol=1e-12, rtol=0)
    plans, diags = make_plans(build_plan, 6, n)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    ref = sesolve_rk4_batched(
        psi0, plans, diags, PAIRS, 2, n, ip_occ(n), dtype=np.complex128,
        mesh=jax_mesh((WORLD,), ("traj",)),
    )
    np.testing.assert_allclose(sharded, ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(
        np.linalg.norm(sharded[:, -1], axis=-1), 1.0, atol=1e-6
    )


def test_mcsolve_sharded_matches_serial(pool):
    """16 quantum-jump trajectories of one Hamiltonian over 4 ranks: the
    key stream is shared, so only the reduction order differs."""
    from pulser_tpu.ops.solver import build_plan, mcsolve_rk4

    sharded = on_ranks(pool, _mcsolve, True)
    serial = on_ranks(pool, _mcsolve, False)
    np.testing.assert_allclose(sharded, serial, atol=1e-12, rtol=0)
    n = 3
    plans, diags = make_plans(build_plan, 1, n, seed=4)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    c_op = np.sqrt(0.4) * np.array([[0, 0], [1, 0]], complex)
    ref = mcsolve_rk4(
        psi0, plans[0], diags[0], PAIRS, 2, n, [c_op], ntraj=16, seed=11,
        dtype=np.complex128, mesh=jax_mesh((WORLD,), ("traj",)),
    )
    np.testing.assert_allclose(sharded, ref, atol=1e-10, rtol=0)
    for rho in sharded:
        np.testing.assert_allclose(np.trace(rho).real, 1.0, atol=1e-9)
        np.testing.assert_allclose(rho, rho.conj().T, atol=1e-12)


def test_emulator_noisy_sesolve_sharded_matches_serial(pool):
    """End-to-end noisy emulation on the pure-state batch: the world's
    default mesh against ``PULSER_TPU_DISABLE_SHARDING``, and against the
    JAX package sharded over its 8 devices."""
    nm_kw = dict(amp_sigma=0.05, laser_waist=120.0, runs=12, samples_per_run=2)
    e_sh, c_sh, r_sh = on_ranks(pool, _port_emulate, 31, nm_kw, x64=True)
    e_se, c_se, r_se = on_ranks(
        pool, _port_emulate, 31, nm_kw,
        env={"PULSER_TPU_DISABLE_SHARDING": "1"}, x64=True,
    )
    assert (r_sh, r_se) == (WORLD, 1)
    np.testing.assert_allclose(e_sh, e_se, atol=1e-12, rtol=0)
    assert c_sh == c_se
    e_jax, c_jax = _jax_emulate(31, nm_kw)
    np.testing.assert_allclose(e_sh, e_jax, atol=1e-10, rtol=0)
    assert c_sh == c_jax


def test_emulator_mcsolve_sharded_matches_serial(pool):
    """Stochastic noise with a collapse operator: the quantum-jump batch,
    sharded over the ranks, against serial and the JAX package."""
    nm_kw = dict(
        amp_sigma=0.05, laser_waist=120.0, dephasing_rate=0.3, runs=2,
        samples_per_run=2,
    )
    e_sh, c_sh, r_sh = on_ranks(pool, _port_emulate, 47, nm_kw, x64=True)
    e_se, c_se, r_se = on_ranks(
        pool, _port_emulate, 47, nm_kw,
        env={"PULSER_TPU_DISABLE_SHARDING": "1"}, x64=True,
    )
    assert (r_sh, r_se) == (WORLD, 1)
    np.testing.assert_allclose(e_sh, e_se, atol=1e-12, rtol=0)
    assert c_sh == c_se
    e_jax, c_jax = _jax_emulate(47, nm_kw)
    np.testing.assert_allclose(e_sh, e_jax, atol=1e-10, rtol=0)
    assert c_sh == c_jax


def test_run_trajectories_sharded_histogram(pool):
    """The histogram ``all_reduce`` sums to the trajectory count and
    equals the JAX package's ``psum`` on a mesh of the same size."""
    from pulser_tpu.parallel import run_trajectories_sharded as jax_run

    hist = on_ranks(pool, _histogram)
    assert hist.shape == (16,)
    assert abs(hist.sum() - 16) < 1e-6 and (hist >= 0).all()
    ref = np.asarray(jax_run(jax_mesh((WORLD,), ("traj",)), *_histogram_case()))
    np.testing.assert_allclose(hist, ref, atol=1e-10, rtol=0)


def test_mesolve_batched_sharded_matches_serial(pool):
    """The density-matrix batch (6 trajectories, padded over 4 ranks)."""
    from pulser_tpu.ops.solver import build_plan, mesolve_rk4_batched

    sharded = on_ranks(pool, _lindblad_batched, "mesolve", True)
    serial = on_ranks(pool, _lindblad_batched, "mesolve", False)
    assert sharded.shape == serial.shape == (6, 3, 8, 8)
    np.testing.assert_allclose(sharded, serial, atol=1e-12, rtol=0)
    n = 3
    plans, diags = make_plans(build_plan, 6, n, seed=7)
    psi0 = np.zeros(2**n, complex)
    psi0[0] = 1.0
    c_op = np.sqrt(0.25) * np.array([[1, 0], [0, -1]], complex)
    ref = mesolve_rk4_batched(
        np.outer(psi0, psi0.conj()), plans, diags, PAIRS, 2, n, [c_op],
        dtype=np.complex128, mesh=jax_mesh((WORLD,), ("traj",)),
    )
    np.testing.assert_allclose(sharded, ref, atol=1e-10, rtol=0)
    tr = np.trace(sharded, axis1=-2, axis2=-1)
    np.testing.assert_allclose(tr.real, 1.0, atol=1e-8)
    np.testing.assert_allclose(
        sharded, np.conj(np.swapaxes(sharded, -1, -2)), atol=1e-10
    )


def test_mcsolve_batched_sharded_matches_serial(pool):
    """The quantum-jump batch, one seed per trajectory (5 over 4 ranks)."""
    from pulser_tpu.ops.solver import build_plan, mcsolve_rk4_batched

    sharded = on_ranks(pool, _lindblad_batched, "mcsolve", True)
    serial = on_ranks(pool, _lindblad_batched, "mcsolve", False)
    assert sharded.shape == serial.shape == (5, 3, 8)
    np.testing.assert_allclose(sharded, serial, atol=1e-12, rtol=0)
    n = 3
    plans, diags = make_plans(build_plan, 5, n, seed=9)
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    c_op = np.sqrt(0.5) * np.array([[0, 0], [1, 0]], complex)
    ref = mcsolve_rk4_batched(
        psi0, plans, diags, PAIRS, 2, n, [c_op], [101, 202, 303, 404, 505],
        dtype=np.complex128, mesh=jax_mesh((WORLD,), ("traj",)),
    )
    np.testing.assert_allclose(sharded, ref, atol=1e-10, rtol=0)
    np.testing.assert_allclose(
        np.linalg.norm(sharded[:, -1], axis=-1), 1.0, atol=1e-9
    )


def test_emulator_mesolve_batched_sharded_matches_serial(pool):
    """Forced MESOLVER with stochastic noise: the dissipative batch."""
    nm_kw = dict(
        amp_sigma=0.05, laser_waist=120.0, dephasing_rate=0.3, runs=6,
        samples_per_run=2,
    )
    e_sh, c_sh, r_sh = on_ranks(
        pool, _port_emulate, 53, nm_kw, "MESOLVER", x64=True
    )
    e_se, c_se, r_se = on_ranks(
        pool, _port_emulate, 53, nm_kw, "MESOLVER",
        env={"PULSER_TPU_DISABLE_SHARDING": "1"}, x64=True,
    )
    assert (r_sh, r_se) == (WORLD, 1)
    np.testing.assert_allclose(e_sh, e_se, atol=1e-12, rtol=0)
    assert c_sh == c_se
    e_jax, c_jax = _jax_emulate(53, nm_kw, "MESOLVER")
    np.testing.assert_allclose(e_sh, e_jax, atol=1e-10, rtol=0)
    assert c_sh == c_jax


def test_resolve_device_under_a_process_group(pool):
    """Under an initialized group, ``None`` is the rank's card
    (``cuda:{LOCAL_RANK}``), or the current card when ranks outnumber the
    cards; without a card it still raises."""
    assert on_ranks(pool, _resolve_under_group, 1, 2, True) == "cuda:1"
    assert on_ranks(pool, _resolve_under_group, 1, 1, True) == "cuda:0"
    out = on_ranks(pool, _resolve_under_group, 0, 0, False)
    assert out.startswith("RuntimeError") and "device='cpu'" in out


def test_ranks_with_different_seeds_refuse_to_shard(pool):
    """A sharded solve whose ranks were given different inputs raises on
    every rank alike (no rank waits in a collective): the quantum-jump
    solve with a seed of each rank's own, and a noisy emulation whose
    ranks seed numpy differently."""
    msg = on_ranks(pool, _mcsolve_seeded_by_rank)
    assert msg is not None and "different inputs" in msg
    assert f"among {WORLD} ranks" in msg
    nm_kw = dict(amp_sigma=0.05, laser_waist=120.0, runs=4, samples_per_run=2)
    msg = on_ranks(pool, _emulate_seeded_by_rank, nm_kw)
    assert msg is not None and "PULSER_TPU_DISABLE_SHARDING=1" in msg
    # The same sweep with sharding turned off runs on every rank
    results = pool.run(
        _task, _emulate_seeded_by_rank, (nm_kw,),
        {"PULSER_TPU_DISABLE_SHARDING": "1"}, False,
    )
    assert results == [None] * WORLD
