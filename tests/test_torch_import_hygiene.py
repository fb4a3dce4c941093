"""The PyTorch port never imports JAX or the JAX package.

Checked in a fresh interpreter, since this test process has both loaded.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FOREIGN = "[m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pulser_tpu')]"


def _foreign_modules(statements: str) -> list[str]:
    code = f"import sys\n{statements}\nprint({_FOREIGN})"
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize(
    "statements",
    [
        "import pulser_tpu_torch.emulator",
        "import pulser_tpu_torch.ops.kernels, pulser_tpu_torch.interop",
        "import chip_smoke; chip_smoke.afm16_inputs()",
        "import pulser_tpu_torch.ops.random, pulser_tpu_torch.ops.solver",
        "import chip_smoke; chip_smoke.noisy10_inputs()",
        "import chip_smoke; chip_smoke.pauli10_inputs()",
        "import chip_smoke; chip_smoke.spd10_inputs()",
        "import chip_smoke;"
        " chip_smoke.random_batched_kernel_inputs(10, 0, 'cpu')",
        "import pulser_tpu_torch.emulator.simulation,"
        " pulser_tpu_torch.emulator.simresults, pulser_tpu_torch.ops.apply",
    ],
)
def test_port_imports_neither_jax_nor_pulser_tpu(statements):
    assert _foreign_modules(statements) == []
