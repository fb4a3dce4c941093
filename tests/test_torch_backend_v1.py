"""The deprecated TorchBackend against TpuBackend.

The four scenarios of ``tests/test_tpu_backend_v1.py`` (deprecation and
config typing with a coherent run, the QPU-mimicking validations, the
device's default noise model, the collapse-operator forms), defined in
``tests/test_torch_backend.py``, through both packages on the same
inputs and numpy seed (the port in complex128 on the CPU): the same
results within 1e-6, equal seeded counts, the same errors and warnings.
The QPU-mimicking scenario moves its sequence to ``DigitalAnalogDevice``
with ``Sequence.with_new_device`` and onto a ``SquareLatticeLayout``
register, as the JAX test does. The emulator methods the backend slice
brought back run here too.
"""

from __future__ import annotations

import pytest
import torch

import test_torch_backend as B
from torch_parity import assert_parity

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """The JAX package on one device (no trajectory sharding), as the
    port runs."""
    monkeypatch.setenv("PULSER_TPU_DISABLE_SHARDING", "1")


@pytest.mark.parametrize("name", list(B.V1_SCENARIOS))
def test_backend_v1_parity(name):
    """The scenarios of tests/test_tpu_backend_v1.py, in both packages."""
    assert_parity(B.V1_SCENARIOS[name], tol=B.TOL)


@pytest.mark.parametrize("name", list(B.FACADE_CASES))
def test_emulator_facade_parity(name):
    """The emulator methods the backend slice brought back (``config``,
    ``set_config``, ``add_config``, ``show_config``, ``reset_config``,
    ``get_hamiltonian``, ``build_operator``), in both packages (the JAX
    package's tests/test_emulator_behavior*.py), to 1e-12."""
    assert_parity(B.FACADE_CASES[name], tol=1e-12)
