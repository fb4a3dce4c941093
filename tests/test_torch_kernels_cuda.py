"""The CUDA kernel against its plain PyTorch twin, on the card.

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10, 13, 16])
def test_cuda_kernel_matches_plain_twin(cuda, n):
    args, kw = chip_smoke.random_kernel_inputs(n, n, cuda)
    before = K.IP_SESOLVE_LAUNCHES
    got = K.ip_sesolve(*args, **kw)
    torch.cuda.synchronize()
    assert K.IP_SESOLVE_LAUNCHES == before + 1
    want = K.ip_sesolve_reference(*args, **kw)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda):
    args, kw = chip_smoke.random_kernel_inputs(10, 0, cuda)
    args[0] = args[0].double()
    with pytest.raises(TypeError, match="float32"):
        K.ip_sesolve(*args, **kw)
