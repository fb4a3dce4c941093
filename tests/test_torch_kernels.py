"""The interaction-picture sesolve kernel's plain twin against Pallas.

``ip_sesolve_reference`` (the plain PyTorch version of the CUDA kernel
``pulser_tpu_torch/csrc/ip_sesolve.cu``) must match the TPU kernel
``_ip_sesolve_jit`` run in the Pallas interpreter on the same random
inputs, made with numpy from a seed, to max |Δ| ≤ 1e-5: both run in
float32 with different summation orders and libm. The CUDA kernel itself
is compared with the plain twin on the card by
``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.

The same holds for the trajectory-batched mode (``segs_per_traj``, a
``(T, R, C)`` diagonal): the plain twin carries the trajectories on a
leading tensor axis, the Pallas kernel flattens them on its grid; max
|Δ| ≤ 2e-5 (the tolerance of the JAX package's own batched-kernel test),
on that test's inputs staged by the port and on random inputs.
"""

from __future__ import annotations

import re
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pulser_tpu.ops.pallas_kernels import _ip_sesolve_jit

import chip_smoke
import pulser_tpu_torch.ops.kernels as K

torch.set_num_threads(1)

TOL = 1e-5
BATCHED_TOL = 2e-5


def _pallas(args, kw):
    """The TPU kernel in the Pallas interpreter on the same inputs."""
    kw = {k: v for k, v in kw.items() if k != "seg_dts_host"}
    return np.asarray(
        _ip_sesolve_jit(
            *(jnp.asarray(a.numpy()) for a in args), **kw, interpret=True
        )
    )


@pytest.mark.parametrize("n, seed", [(10, 0), (10, 1), (11, 2)])
def test_plain_twin_matches_pallas_interpret(n, seed):
    """n=10 is (n_row=3, n_col=7); 2 segments x 4 steps."""
    args, kw = chip_smoke.random_kernel_inputs(n, seed, "cpu", seg_len=4)
    plain = K.ip_sesolve_reference(*args, **kw).numpy()
    pallas = np.asarray(
        _ip_sesolve_jit(
            *(jnp.asarray(a.numpy()) for a in args), **kw, interpret=True
        )
    )
    assert plain.shape == pallas.shape == (2, 2, 1 << (n - 7), 1 << 7)
    assert np.max(np.abs(plain - pallas)) <= TOL


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    args, kw = chip_smoke.random_kernel_inputs(10, 3, "cpu", seg_len=4)
    before = K.launches("ip_sesolve")
    got = K.ip_sesolve(*args, **kw)
    assert K.launches("ip_sesolve") == before
    assert torch.equal(got, K.ip_sesolve_reference(*args, **kw))


def test_device_launch_count_only_for_counting_libraries():
    """Every kernel's library counts its device launches; asking for a
    name that is no kernel raises before anything is built or loaded."""
    assert set(K.SOURCES) == {
        "ip_sesolve", "ip_sesolve_batched", "mcwf_rows", "mcwf",
        "sample_states",
    }
    with pytest.raises(ValueError, match="no kernel"):
        K.device_launches("mcwf_cols")
    for name, path in K.SOURCES.items():
        with open(path) as f:
            assert f'extern "C" unsigned long long {name}_device_launches' in (
                f.read()
            )


def test_padding_steps_are_no_ops():
    """A segment whose steps all have h = 0 leaves the state alone."""
    args, kw = chip_smoke.random_kernel_inputs(10, 4, "cpu", seg_len=4)
    args[4][1] = 0.0  # every step of segment 1 is padding
    out = K.ip_sesolve_reference(*args, **kw)
    # Segment 1 emits the same interaction-picture state at another
    # phase: equal moduli
    assert torch.allclose(
        out[0, 0] ** 2 + out[0, 1] ** 2, out[1, 0] ** 2 + out[1, 1] ** 2,
        atol=1e-7,
    )


def _jax_batched_test_inputs(n=10, n_traj=3):
    """The inputs of the JAX package's own batched-kernel test
    (``test_sesolve_batched_pallas_matches_xla``): three 10-atom
    trajectories on six knots, staged by the port."""
    from pulser_tpu_torch.ops import solver as S

    rng = np.random.default_rng(12)
    knots = np.linspace(0.0, 0.1, 6)
    amp_b = rng.uniform(1, 5, size=(n_traj, 1, n, 6)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, size=(n_traj, 1, n, 1))
    )
    det_b = rng.normal(0, 2, size=(n_traj, 1, n, 6))
    plans = S.build_plan_batched(
        knots, {"amp": amp_b, "det": det_b}, np.array([0.0, 0.1]),
        max_step=2e-3,
    )
    diags = rng.uniform(0, 20, size=(n_traj, 2**n))
    psi0 = np.zeros(2**n, np.complex64)
    psi0[-1] = 1.0
    return S.ip_batched_kernel_inputs(psi0, plans, diags, n, "cpu")


def test_batched_plain_twin_matches_pallas_on_the_jax_tests_inputs():
    args, kw = _jax_batched_test_inputs()
    assert kw["segs_per_traj"] == 2 and args[0].shape[0] == 6
    assert tuple(args[7].shape) == (3, 8, 128)
    plain = K.ip_sesolve_reference(*args, **kw).numpy()
    pallas = _pallas(args, kw)
    assert plain.shape == pallas.shape == (6, 2, 8, 128)
    assert np.max(np.abs(plain - pallas)) <= BATCHED_TOL
    # Each trajectory's first segment (t = 0) emits psi0: the reset
    assert np.allclose(plain[0::2, 0, -1, -1], 1.0, atol=1e-6)
    # ... and the trajectories end in different states
    assert np.max(np.abs(plain[1] - plain[3])) > 1e-2


@pytest.mark.parametrize(
    "n, n_traj, seed", [(10, 3, 0), (10, 1, 1), (11, 2, 2), (14, 2, 3)]
)
def test_batched_plain_twin_matches_pallas_interpret(n, n_traj, seed):
    """Random drives, phase integrals and diagonals, all different per
    trajectory; 2 segments x 4 steps, the second starting with padding."""
    args, kw = chip_smoke.random_batched_kernel_inputs(
        n, seed, "cpu", n_traj=n_traj, seg_len=4
    )
    plain = K.ip_sesolve_reference(*args, **kw).numpy()
    assert np.max(np.abs(plain - _pallas(args, kw))) <= BATCHED_TOL


def test_batched_plain_twin_equals_one_solve_per_trajectory():
    """A batch is the single-trajectory solves side by side: a wrong
    diagonal or a state carried over a boundary would show."""
    args, kw = chip_smoke.random_batched_kernel_inputs(10, 5, "cpu", seg_len=4)
    got = K.ip_sesolve_reference(*args, **kw)
    spt = kw.pop("segs_per_traj")
    for t in range(3):
        rows = slice(t * spt, (t + 1) * spt)
        one = [a[rows].contiguous() for a in args[:7]]
        one += [args[7][t : t + 1], args[8], args[9]]
        single = K.ip_sesolve_reference(*one, **kw)
        assert float((got[rows] - single).abs().max()) <= 1e-6


def test_batched_wrapper_on_cpu_runs_the_plain_version_uncounted():
    args, kw = chip_smoke.random_batched_kernel_inputs(10, 3, "cpu", seg_len=4)
    before = K.launches("ip_sesolve_batched"), K.launches("ip_sesolve")
    got = K.ip_sesolve(*args, **kw)
    after = K.launches("ip_sesolve_batched"), K.launches("ip_sesolve")
    assert after == before
    assert torch.equal(got, K.ip_sesolve_reference(*args, **kw))
    with pytest.raises(ValueError, match="whole number"):
        K.ip_sesolve(*args, **{**kw, "segs_per_traj": 4})


def test_batched_padding_differs_per_trajectory():
    """A step that is padding for one trajectory only leaves that
    trajectory's state alone and advances the others."""
    args, kw = chip_smoke.random_batched_kernel_inputs(10, 6, "cpu", seg_len=4)
    args[4].reshape(3, 2, 4)[1, 1] = 0.0  # trajectory 1 skips segment 1
    out = K.ip_sesolve_reference(*args, **kw)
    assert np.max(np.abs(out.numpy() - _pallas(args, kw))) <= BATCHED_TOL
    mod = (out[:, 0] ** 2 + out[:, 1] ** 2).reshape(3, 2, -1)
    assert torch.allclose(mod[1, 0], mod[1, 1], atol=1e-7)
    assert float((mod[0, 0] - mod[0, 1]).abs().max()) > 1e-5


@pytest.mark.parametrize("n", [10, 13, 14, 17])
def test_batched_mode_library_by_size(n):
    """Every batched size runs in the one batched library: one block per
    trajectory while the state fits a block, one thread-block cluster per
    trajectory above; its source holds the C entry."""
    assert K.ip_sesolve_batched_library(n) == "ip_sesolve_batched"
    shape = K.ip_sesolve_batched_shape(n)
    assert shape["blocks"] == (1 if n <= K.IP_BLOCK_MAX_QUBITS else 1 << (n - 13))
    with open(K.SOURCES["ip_sesolve_batched"]) as f:
        assert 'extern "C" int ip_sesolve_batched_run(' in f.read()


@pytest.mark.parametrize("n", sorted(K.IP_BATCHED_SHAPES))
def test_batched_shape_table(n):
    """The wrapper's table of the batched mode's block shapes: a
    trajectory's blocks hold its 2^n amplitudes, a cluster has at most 16
    blocks, a block fits the card's shared memory, and the source
    instantiates each n in that shape and no other."""
    shape = K.ip_sesolve_batched_shape(n)
    assert shape["blocks"] * shape["threads"] * shape["amps"] == 1 << n
    assert shape["blocks"] <= 16 and shape["threads"] <= 1024
    assert shape["smem_bytes"] <= 232_448  # a block's shared memory on an H100
    threads = "kThreads" if shape["threads"] == 1024 else "kThreads / 2"
    with open(K.SOURCES["ip_sesolve_batched"]) as f:
        cases = re.findall(rf"CASE\({n}, (\d+), ([^)]*)\)", f.read())
    assert cases == [(str(shape["block_qubits"]), threads)]
