"""The CUDA kernels against their plain PyTorch twins, on the card.

Needs an NVIDIA GPU and nvcc; skips without a card. This file imports
neither JAX nor ``pulser_tpu``, so it also runs on a machine that has
only the port's dependencies::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

from __future__ import annotations

import pytest
import torch

import chip_smoke
import pulser_tpu_torch.ops.kernels as K

torch.set_num_threads(1)

#: Both run in float32 with different summation orders and libm.
TOL = 1e-5
#: The trajectory-batched K1 (as K1, over up to three times the steps).
BATCHED_TOL = 2e-5
#: K2 and K3 (float32, block reductions; K2's phases reach ~100 rad).
MCWF_TOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 13, 16, 17])
def test_cuda_kernel_matches_plain_twin(cuda, n):
    args, kw = chip_smoke.random_kernel_inputs(n, n, cuda)
    before = K.IP_SESOLVE_LAUNCHES
    got = K.ip_sesolve(*args, **kw)
    torch.cuda.synchronize()
    assert K.IP_SESOLVE_LAUNCHES == before + 1
    want = K.ip_sesolve_reference(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_cuda_kernel_solve_is_one_device_launch(cuda):
    """A whole K1 solve (2 segments, padding steps, carried and
    recomputed rotors) is one cooperative kernel launch."""
    args, kw = chip_smoke.random_kernel_inputs(16, 16, cuda)
    K.ip_sesolve(*args, **kw)  # build and load first
    counted, launched = chip_smoke.launches_per_call(
        K, "ip_sesolve", lambda: K.ip_sesolve(*args, **kw)
    )
    assert counted == 1
    assert not launched or (
        len(launched) == 1 and "ip_sesolve_kernel" in launched[0]
    )
    blocks, threads, amps = K.ip_sesolve_grid(16)
    assert blocks * threads * amps == 1 << 16


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda):
    args, kw = chip_smoke.random_kernel_inputs(10, 0, cuda)
    args[0] = args[0].double()
    with pytest.raises(TypeError, match="float32"):
        K.ip_sesolve(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n_traj", [1, 3])
@pytest.mark.parametrize("n", list(range(10, 18)))
def test_cuda_batched_kernel_matches_plain_twin(cuda, n, n_traj):
    """The trajectory-batched mode: one block per trajectory up to n = 13,
    the cooperative kernel above; every trajectory with its own drives,
    phase integrals and diagonal, reset from psi0."""
    args, kw = chip_smoke.random_batched_kernel_inputs(
        n, n, cuda, n_traj=n_traj
    )
    before = K.IP_SESOLVE_BATCHED_LAUNCHES, K.IP_SESOLVE_LAUNCHES
    got = K.ip_sesolve(*args, **kw)
    torch.cuda.synchronize()
    assert K.IP_SESOLVE_BATCHED_LAUNCHES == before[0] + 1
    assert K.IP_SESOLVE_LAUNCHES == before[1]
    want = K.ip_sesolve_reference(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= BATCHED_TOL
    if n_traj > 1:
        # The trajectories really differ
        assert float((want[:2] - want[2:4]).abs().max()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 12, 14])
def test_cuda_batched_kernel_equals_single_solves(cuda, n):
    """Each trajectory of a batch equals the single-trajectory kernel on
    its own rows and diagonal (same arithmetic, other grid)."""
    args, kw = chip_smoke.random_batched_kernel_inputs(n, 50 + n, cuda)
    got = K.ip_sesolve(*args, **kw)
    spt = kw.pop("segs_per_traj")
    for t in range(3):
        rows = slice(t * spt, (t + 1) * spt)
        one = [a[rows].contiguous() for a in args[:7]]
        one += [args[7][t : t + 1].contiguous(), args[8], args[9]]
        single = K.ip_sesolve(*one, **kw)
        assert float((got[rows] - single).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 13, 15])
def test_cuda_batched_kernel_padding_steps(cuda, n):
    """Leading all-padding segments (an evaluation at t = 0), a first
    real step beyond the 32 a warp looks at in one go, and per-trajectory
    padding that differs."""
    args, kw = chip_smoke.random_batched_kernel_inputs(
        n, 70 + n, cuda, n_traj=3, seg_len=40, n_seg=3
    )
    dts = args[4].reshape(3, 3, 40)
    dts[:, 0] = 0.0  # segment 0 emits psi0 in the lab frame
    dts[:, 1, :35] = 0.0
    dts[1, 2, :5] = 0.0  # trajectory 1 alone pads 5 steps here
    got = K.ip_sesolve(*args, **kw)
    torch.cuda.synchronize()
    want = K.ip_sesolve_reference(*args, **kw)
    assert float((got - want).abs().max()) <= BATCHED_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 13, 14, 17])
def test_cuda_batched_kernel_is_one_device_launch(cuda, n):
    args, kw = chip_smoke.random_batched_kernel_inputs(n, n, cuda)

    def call():
        return K.ip_sesolve(*args, **kw)

    call()  # build and load first
    counted, launched = chip_smoke.launches_per_call(
        K, K.ip_sesolve_batched_library(n), call
    )
    assert counted == 1
    assert not launched or (
        len(launched) == 1 and "ip_sesolve" in launched[0]
    )


@pytest.mark.cuda
def test_cuda_batched_wrapper_rejects_bad_inputs(cuda):
    args, kw = chip_smoke.random_batched_kernel_inputs(10, 0, cuda)
    with pytest.raises(ValueError, match="whole number"):
        K.ip_sesolve(*args, **{**kw, "segs_per_traj": 4})
    with pytest.raises(ValueError, match="shape"):
        K.ip_sesolve(*args[:7], args[7][:1].contiguous(), *args[8:], **kw)


def _check_k2(args):
    """One K2 launch against the plain version: states, jump counts and
    the kernel's count of carried rotors. Returns the jump counts."""
    cops = chip_smoke.RANDOM_COPS
    before = K.MCWF_ROWS_LAUNCHES
    got, jumps = K.mcwf_rows(*args, cops=cops)
    torch.cuda.synchronize()
    assert K.MCWF_ROWS_LAUNCHES == before + 1
    want, jumps_p = K.mcwf_rows_reference(*args, cops=cops)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(jumps, jumps_p)
    assert float((got - want).abs().max()) <= MCWF_TOL
    rows_agree, _ = K.mcwf_rows_carried_steps(*args[2:5])
    assert torch.equal(K.MCWF_ROWS_CARRIED.long(), rows_agree)
    return jumps


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(1, 14)))
def test_cuda_mcwf_rows_matches_plain_twin(cuda, n):
    """Sub-warp states (n < 5), one amplitude per thread (n <= 10), then
    2, 4 and 8; rotors carried in segment 0, recomputed in segment 1."""
    args = chip_smoke.random_mcwf_inputs(n, n, cuda)
    jumps = _check_k2(args)
    assert int(jumps.min()) >= 1
    assert int(K.MCWF_ROWS_CARRIED.min()) == 7  # steps 1..7 of segment 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 10, 12])
def test_cuda_mcwf_rows_jumps_every_step(cuda, n):
    """Thresholds of 1: every trajectory jumps after every step, so the
    jump branch runs 22 times per trajectory."""
    args = chip_smoke.random_mcwf_inputs(
        n, 100 + n, cuda, seg_len=12, threshold=1.0
    )
    assert int(_check_k2(args).min()) == 22


@pytest.mark.cuda
@pytest.mark.parametrize("plan_like", [True, False])
def test_cuda_mcwf_rows_start_padding(cuda, plan_like):
    """Both segments start with padding, the first with more steps than a
    warp looks at in one go; with and without rows that agree."""
    args = chip_smoke.random_mcwf_inputs(
        6, 60, cuda, seg_len=40, plan_like=plan_like
    )
    args[4][0, :35] = 0.0
    _check_k2(args)
    assert bool(K.MCWF_ROWS_CARRIED.any()) == plan_like


@pytest.mark.cuda
def test_cuda_mcwf_rows_solve_is_one_device_launch(cuda):
    args = chip_smoke.random_mcwf_inputs(10, 10, cuda)

    def call():
        return K.mcwf_rows(*args, cops=chip_smoke.RANDOM_COPS)

    call()  # build and load first
    counted, launched = chip_smoke.launches_per_call(K, "mcwf_rows", call)
    assert counted == 1
    assert not launched or (
        len(launched) == 1 and "mcwf_rows_kernel" in launched[0]
    )


@pytest.mark.cuda
def test_cuda_mcwf_rows_rejects_bad_inputs(cuda):
    args = chip_smoke.random_mcwf_inputs(5, 0, cuda)
    with pytest.raises(ValueError, match="shape"):
        K.mcwf_rows(*args[:5], args[5][:, :1].contiguous(), *args[6:],
                    cops=chip_smoke.RANDOM_COPS)
    args[9] = args[9].cpu()
    with pytest.raises(ValueError, match="cpu"):
        K.mcwf_rows(*args, cops=chip_smoke.RANDOM_COPS)


@pytest.mark.cuda
@pytest.mark.parametrize("n", list(range(1, 14)))
def test_cuda_mcwf_matches_plain_twin(cuda, n):
    args, kw = chip_smoke.random_k3_inputs(n, n, cuda)
    before = K.MCWF_LAUNCHES
    got, jumps = K.mcwf(*args, **kw)
    torch.cuda.synchronize()
    assert K.MCWF_LAUNCHES == before + 1
    want, jumps_p = K.mcwf_reference(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert int(jumps.min()) >= 1 and torch.equal(jumps, jumps_p)
    assert float((got - want).abs().max()) <= MCWF_TOL


@pytest.mark.cuda
def test_cuda_mcwf_rejects_bad_inputs(cuda):
    args, kw = chip_smoke.random_k3_inputs(5, 0, cuda)
    with pytest.raises(ValueError, match="shape"):
        K.mcwf(*args[:4], args[4][:, :1].contiguous(), *args[5:], **kw)
    args[6] = args[6].cpu()
    with pytest.raises(ValueError, match="cpu"):
        K.mcwf(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 10, 12])
def test_cuda_mcwf_jumps_every_step(cuda, n):
    """Thresholds of 1: every trajectory jumps after every step, so the
    jump branch runs 22 times per trajectory."""
    args, kw = chip_smoke.random_k3_inputs(
        n, 100 + n, cuda, seg_len=12, threshold=1.0
    )
    got, jumps = K.mcwf(*args, **kw)
    torch.cuda.synchronize()
    want, jumps_p = K.mcwf_reference(*args, **kw)
    assert bool(torch.isfinite(got).all())
    assert int(jumps.min()) == 22 and torch.equal(jumps, jumps_p)
    assert float((got - want).abs().max()) <= MCWF_TOL


@pytest.mark.cuda
def test_cuda_mcwf_rows_on_regnoise10_distinct_diagonals(cuda):
    """K2 on REGNOISE10's own inputs: 100 trajectories whose jittered
    registers give 100 distinct interaction diagonals, against the plain
    version (all but at most one trajectory, whose jump record may
    differ, within 5e-5)."""
    from pulser_tpu_torch.ops import solver as S

    captured = chip_smoke._run_noisy(
        K, chip_smoke.regnoise10_sequence(), 1234, "mcsolve_rows_codes", S
    )[-1]
    psi0, plans, diags, _, _, _, cops, seeds, _ = captured["args"]
    margs = S.rows_kernel_inputs(psi0, plans, diags, seeds, cuda)
    assert torch.unique(margs[9], dim=0).shape[0] == plans.n_traj == 100
    spec = S._diag_cops_spec(cops)
    got, jumps = K.mcwf_rows(*margs, cops=spec)
    want, jumps_p = K.mcwf_rows_reference(*margs, cops=spec)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    per_traj = (got - want).abs().amax(dim=(1, 2, 3))
    odd = chip_smoke._odd_trajectories(per_traj, jumps, jumps_p, MCWF_TOL)
    assert len(odd) <= 1
    keep = torch.ones_like(per_traj, dtype=torch.bool)
    keep[odd] = False
    assert float(per_traj[keep].max()) <= MCWF_TOL


@pytest.mark.cuda
def test_cuda_kernel_on_tri16_plan(cuda):
    """K1 on TRI16's plan (AFM16's sweep on AnalogDevice's calibrated
    triangular layout, reached with ``with_new_device``) against its
    plain version, at the sweep tolerance."""
    import numpy as np

    from pulser_tpu_torch.emulator import TorchEmulator
    from pulser_tpu_torch.ops import solver as S

    seq = chip_smoke.tri16_sequence()
    emu = TorchEmulator.from_sequence(
        seq, evaluation_times=np.linspace(0, seq.get_duration() * 1e-3, 101)
    )
    emu.run()
    args, kw = S.ip_kernel_inputs(
        emu._initial_ket().astype(np.complex64),
        emu._plan_cache[1],
        emu._current_hamiltonian.int_diag,
        16,
        cuda,
    )
    got = K.ip_sesolve(*args, **kw)
    want = K.ip_sesolve_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= chip_smoke.SWEEP_TOL


@pytest.mark.cuda
@pytest.mark.parametrize(
    "path,kernel",
    [("afm16", "ip_sesolve"), ("noisy10", "mcwf_rows"), ("tri16", "ip_sesolve")],
)
def test_cuda_wire_path_one_launch(cuda, path, kernel):
    """The wire paths of ``chip_smoke.py``: a sequence (and NOISY10's
    config) written as abstract-repr JSON and loaded back runs its kernel
    in one launch, and its final state (AFM16), its occupations and
    counts (NOISY10) or its QPU job's counts (TRI16, through
    ``QPUBackend``) equal the direct build's; each check raises."""
    from pulser_tpu_torch.ops import solver as S

    entry = getattr(chip_smoke, f"_wire_{path}_path")(
        K, S, torch.cuda.get_device_name(0)
    )
    assert entry["launches"] == {kernel: 1}


@pytest.fixture
def card_daemon(cuda, tmp_path):
    """The port's solve daemon on the card, in a thread of this process."""
    import threading

    from pulser_tpu_torch import serving

    path = str(tmp_path / "daemon.sock")
    ready = threading.Event()
    thread = threading.Thread(
        target=serving.serve,
        args=(path,),
        kwargs={"device": "cuda", "ready_event": ready},
        daemon=True,
    )
    thread.start()
    assert ready.wait(120), "the daemon did not come up"
    client = serving.SolveClient(path)
    yield client
    client.shutdown()
    thread.join(timeout=60)
    assert not thread.is_alive()


@pytest.mark.cuda
def test_cuda_daemon_answers_afm16(card_daemon):
    """``chip_smoke.py``'s SERVE_AFM16: the daemon answers AFM16's final
    state (and all 101 states) with one K1 launch per request, equal to
    the direct run's and within the golden's tolerance; each check
    raises."""
    from pulser_tpu_torch.ops import solver as S

    entries = chip_smoke._serve_afm16(
        K, S, card_daemon, chip_smoke.serve_requests(),
        torch.cuda.get_device_name(0),
    )
    assert [e["launches"] for e in entries] == [{"ip_sesolve": 1}] * 2


@pytest.mark.cuda
def test_cuda_daemon_answers_noisy10_backend(card_daemon):
    """``chip_smoke.py``'s SERVE_NOISY10: NOISY10's backend run, shipped
    as JSON with seed 1234, in one K2 launch per request, its occupations
    and counts equal to the direct backend run's."""
    from pulser_tpu_torch.ops import solver as S

    entry = chip_smoke._serve_noisy10(
        K, S, card_daemon, chip_smoke.serve_requests(),
        torch.cuda.get_device_name(0),
    )
    assert entry["launches"] == {"mcwf_rows": 1}
    assert entry["occupation_max_abs_diff"] == 0.0
    assert entry["counts_tv"] == 0.0


# -- the sharded solves on the card (ranks sharing it over gloo) ----------


def _sharded_case(
    n: int, n_traj: int, seed: int = 3, t_end: float = 0.2, n_eval: int = 2
):
    """Plans of ``n_traj`` random trajectories on one grid of ``t_end``
    µs with ``n_eval`` evaluation times, their diagonals and the initial
    state."""
    import numpy as np

    from pulser_tpu_torch.ops import solver as S

    rng = np.random.default_rng(seed)
    knots = np.linspace(0.0, t_end, 11)
    evals = np.linspace(t_end / n_eval, t_end, n_eval)
    plans = []
    for _ in range(n_traj):
        amp = rng.uniform(1, 5, size=(1, n, 11)) * np.exp(
            1j * rng.uniform(0, 2 * np.pi, size=(1, n, 1))
        )
        det = rng.normal(0, 3, size=(1, n, 11))
        plans.append(
            S.build_plan(knots, {"amp": amp, "det": det}, evals, max_step=2e-3)
        )
    diags = rng.uniform(0, 20, size=(n_traj, 2**n))
    psi0 = np.zeros(2**n, complex)
    psi0[-1] = 1.0
    return plans, diags, psi0


def _card_state_solve(n: int, sharded: bool, **case):
    """The state of ``n`` qubits solved on this rank's card, its ``2^n``
    axis sharded over the world or not."""
    from pulser_tpu_torch.ops import solver as S
    from pulser_tpu_torch.parallel import default_state_mesh

    plans, diags, psi0 = _sharded_case(n, 1, **case)
    return S.sesolve_rk4(
        psi0, plans[0], diags[0], ((1, 0, 0),), 2, n, ip_occ=True,
        dtype="complex64",
        state_mesh=default_state_mesh(n) if sharded else None,
    ), dict(S.last_solve_info)


def _card_state_peak(n: int, sharded: bool, **case) -> int:
    """The device memory :func:`_card_state_solve` takes at its peak on
    this rank's card, beyond what the rank held before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _card_state_solve(n, sharded, **case)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def _card_batch_solve(n: int, n_traj: int, sharded: bool):
    """A trajectory batch (a list of plans: the torch loop) solved on this
    rank's card, split over the world or not."""
    from pulser_tpu_torch.ops import solver as S
    from pulser_tpu_torch.parallel import default_mesh

    plans, diags, psi0 = _sharded_case(n, n_traj)
    return S.sesolve_rk4_batched(
        psi0, plans, diags, ((1, 0, 0),), 2, n, True, dtype="complex64",
        mesh=default_mesh() if sharded else None,
    ), dict(S.last_solve_info)


@pytest.fixture(scope="module")
def card_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the ranks put their tensors on it)")
    from pulser_tpu_torch.parallel import RankPool

    with RankPool(2, str(tmp_path_factory.mktemp("w") / "store")) as pool:
        yield pool


@pytest.mark.cuda
def test_cuda_state_sharded_solve_equals_direct(card_world):
    """14 qubits over 2 ranks sharing the card (gloo, host-staged): every
    rank's state equals the direct solve's on the card."""
    want, _ = _card_state_solve(14, False)
    for got, info in card_world.run(_card_state_solve, 14, True):
        assert info["kind"] == "sesolve_state_sharded_torch"
        assert info["ranks"] == 2
        assert float(abs(got - want).max()) <= TOL


@pytest.mark.cuda
def test_cuda_state_sharded_solve_holds_less_device_memory(card_world):
    """24 qubits over 2 ranks sharing the card, 8 evaluation times (10
    steps): each rank's peak device memory stays below the unsharded
    solve's, since a rank's share of the states leaves the card before
    the ranks assemble them on the host."""
    case = {"t_end": 0.02, "n_eval": 8}
    want = _card_state_peak(24, False, **case)
    for got in card_world.run(_card_state_peak, 24, True, **case):
        assert got < want, (got, want)


@pytest.mark.cuda
def test_cuda_trajectory_sharded_batch_equals_direct(card_world):
    """5 trajectories of 10 qubits over 2 ranks (padded to 6): every
    rank's batch equals the direct torch loop's on the card."""
    want, _ = _card_batch_solve(10, 5, False)
    for got, info in card_world.run(_card_batch_solve, 10, 5, True):
        assert info["kind"] == "sesolve_batched_torch"
        assert info["ranks"] == 2
        assert got.shape == want.shape == (5, 2, 1024)
        assert float(abs(got - want).max()) <= TOL


@pytest.mark.cuda
def test_cuda_tutorial02_quantum_jumps_one_k2_launch(cuda):
    """Tutorial 02 on the card: its quantum-jump cell (dephasing with
    amplitude and Doppler noise, 60 trajectories of 4 atoms) takes K2 in
    one launch, and its counts are within TV 0.02 of the JAX package's
    (``tests/goldens/tutorials_reference.json``)."""
    import json

    import numpy as np

    from pulser_tpu_torch.ops import solver as S
    from tools import build_tutorials_torch as B

    with open(chip_smoke._TUTORIALS_GOLDEN) as f:
        golden = json.load(f)
    seen = []

    def on_cell(_, code, seconds):
        torch.cuda.synchronize()
        seen.append((code, K.MCWF_ROWS_LAUNCHES, K.device_launches("mcwf_rows"),
                     dict(S.last_solve_info)))

    name = "02_noisy_simulation"
    np.random.seed(golden["seed"])
    B.execute(name, "cuda", on_cell=on_cell)  # builds the kernels first
    np.random.seed(golden["seed"])
    seen.clear()
    before = (K.MCWF_ROWS_LAUNCHES, K.device_launches("mcwf_rows"))
    ns = B.execute(name, "cuda", on_cell=on_cell)
    for code, wrapper, lib, info in seen:
        if "nm_both = ptt.NoiseModel(" in code:
            assert (wrapper - before[0], lib - before[1]) == (1, 1)
            assert info["kind"] == "mcwf_rows_cuda"
            break
        before = (wrapper, lib)
    else:
        raise AssertionError("no nm_both cell")
    kind, want = B.decode(golden["tutorials"][name])["counts_jumps"]
    got = B.KEY_VALUES[name](ns)["counts_jumps"][1]
    assert B.difference(kind, want, got) <= chip_smoke.COUNTS_TV_TOL


@pytest.mark.cuda
def test_cuda_scale_ladder_20_atoms_within_solve_bytes(cuda):
    """The ladder's sequence at 20 atoms on one card: the unsharded
    torch loop, the norm held, the peak device memory within the
    capacity contract's ``solve_bytes``."""
    from pulser_tpu_torch.parallel import capacity
    from tools import scale_ladder_torch as L

    rec = L.run_size(20, "cuda", warm_runs=1)
    assert rec["solver_kind"] == L.LADDER_KIND
    assert abs(rec["norm"] - 1) <= L.NORM_TOL
    assert 0 < rec["peak_bytes"] <= capacity.solve_bytes(2, 20)
    assert rec["peak_bytes"] <= rec["solve_bytes"]
