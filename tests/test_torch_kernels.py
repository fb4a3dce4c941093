"""The interaction-picture sesolve kernel's plain twin against Pallas.

``ip_sesolve_reference`` (the plain PyTorch version of the CUDA kernel
``pulser_tpu_torch/csrc/ip_sesolve.cu``) must match the TPU kernel
``_ip_sesolve_jit`` run in the Pallas interpreter on the same random
inputs, made with numpy from a seed, to max |Δ| ≤ 1e-5: both run in
float32 with different summation orders and libm. The CUDA kernel itself
is compared with the plain twin on the card by
``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pulser_tpu.ops.pallas_kernels import _ip_sesolve_jit

import chip_smoke
import pulser_tpu_torch.ops.kernels as K

torch.set_num_threads(1)

TOL = 1e-5


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
    before = K.IP_SESOLVE_LAUNCHES
    got = K.ip_sesolve(*args, **kw)
    assert K.IP_SESOLVE_LAUNCHES == before
    assert torch.equal(got, K.ip_sesolve_reference(*args, **kw))


def test_device_launch_count_only_for_counting_libraries():
    """Every kernel's library counts its device launches; asking for a
    name that is no kernel raises before anything is built or loaded."""
    assert set(K.SOURCES) == {"ip_sesolve", "mcwf_rows", "mcwf"}
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
