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


#: Builds, samples (with modulation) and differentiates an EOM sequence.
_EOM_SEQUENCE = """
import torch
import pulser_tpu_torch as P
import pulser_tpu_torch.emulator
amp = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
reg = P.Register.rectangle(1, 2, spacing=7.0, prefix="q")
seq = P.Sequence(reg, P.AnalogDevice)
seq.declare_channel("ryd", "rydberg_global")
seq.enable_eom_mode("ryd", amp, 0.5, -10.0)
seq.add_eom_pulse("ryd", 100, 0.3)
seq.disable_eom_mode("ryd", correct_phase_drift=True)
seq.add(P.Pulse.ConstantDetuning(P.BlackmanWaveform(200, 1.0), 0, 0), "ryd")
samples = P.sample(seq, modulation=True)
samples.channel_samples["ryd"].amp.as_tensor().sum().backward()
assert amp.grad is not None
P.emulator.TorchEmulator.from_sequence
"""


#: A backend run on the CPU with every default observable, through the
#: package root's exports.
_BACKEND_RUN = """
import numpy as np
import pulser_tpu_torch as P
reg = P.Register.square(2, spacing=7.0, prefix="q")
seq = P.Sequence(reg, P.MockDevice)
seq.declare_channel("ryd", "rydberg_global")
seq.add(P.Pulse.ConstantPulse(200, np.pi, 0.0, 0.0), "ryd")
ref = P.TorchState.from_state_amplitudes(
    eigenstates=("r", "g"), amplitudes={"gggg": 1.0}
)
z = P.TorchOperator.from_operator_repr(
    eigenstates=("r", "g"), n_qudits=4, operations=[(1.0, [({"rr": 1.0}, {0})])]
)
obs = [
    P.StateResult(), P.BitStrings(num_shots=10), P.Fidelity(ref),
    P.Expectation(z), P.CorrelationMatrix(), P.Occupation(), P.Energy(),
    P.EnergyVariance(), P.EnergySecondMoment(),
]
res = P.TorchBackendV2(
    seq, config=P.TorchConfig(observables=obs, torch_device="cpu")
).run()
assert len(res.get_result_tags()) == 9
P.Results, P.ResultsSequence, P.EmulationConfig, P.EmulatorConfig
P.BackendConfig, P.Callback, P.Observable, P.AggregationMethod
P.TorchBackend, P.QutipBackend, P.QutipBackendV2, P.QutipConfig
P.QutipState, P.QutipOperator
"""


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
        "import pulser_tpu_torch as P;"
        " P.Sequence, P.Pulse, P.RampWaveform, P.sample, P.Variable,"
        " P.MappableRegister, P.RegisterLayout",
        "import pulser_tpu_torch.parametrized.paramabc,"
        " pulser_tpu_torch.parametrized.variable,"
        " pulser_tpu_torch.parametrized.paramobj,"
        " pulser_tpu_torch.parametrized.decorators,"
        " pulser_tpu_torch.waveforms, pulser_tpu_torch.pulse,"
        " pulser_tpu_torch.register.register_layout,"
        " pulser_tpu_torch.register.mappable_reg",
        "import pulser_tpu_torch.sequence._basis_ref,"
        " pulser_tpu_torch.sequence._call,"
        " pulser_tpu_torch.sequence._decorators,"
        " pulser_tpu_torch.sequence.helpers._seq_str,"
        " pulser_tpu_torch.sequence._schedule,"
        " pulser_tpu_torch.sequence._eom_mode,"
        " pulser_tpu_torch.sequence.sequence,"
        " pulser_tpu_torch.sampler.sampler",
        "import chip_smoke; chip_smoke.afm16_sequence();"
        " chip_smoke.noisy10_sequence(); chip_smoke.pauli10_sequence();"
        " chip_smoke.spd10_sequence()",
        "import chip_smoke; chip_smoke.deph10_sequence();"
        " chip_smoke.mesolve10_sequence(); chip_smoke.eff8_sequence()",
        "import pulser_tpu_torch.parallel.capacity as C, numpy as np;"
        " from pulser_tpu_torch.ops import solver as S;"
        " C.capacity_report('cpu');"
        " S.mesolve_rk4(np.eye(4) / 4, S.build_plan(np.linspace(0, 0.01,"
        " 11), {'amp': np.ones((1, 2, 11), complex), 'det': np.zeros((1,"
        " 2, 11))}, np.array([0.01]), max_step=1e-3), np.zeros(4),"
        " ((1, 0, 0),), 2, 2, [np.diag([1.0, 0.0])], device='cpu')",
        "import chip_smoke; chip_smoke.xy16_sequence();"
        " chip_smoke.relax10_sequence(); chip_smoke.mcdepol10_sequence()",
        "import numpy as np, torch;"
        " from pulser_tpu_torch.ops import solver as S, apply as A;"
        " u = torch.ones(3, 3) - torch.eye(3);"
        " A.apply_flip_flop_r(u, torch.ones(8, dtype=torch.complex64), 2, 3,"
        " 0, 1);"
        " plan = S.build_plan(np.linspace(0, 0.01, 11), {'amp': np.ones((1,"
        " 3, 11), complex), 'det': np.zeros((1, 3, 11))}, np.array([0.01]),"
        " max_step=1e-3);"
        " S.sesolve_rk4(np.eye(8)[0], plan, np.zeros(8), ((0, 1, 1),), 2, 3,"
        " xy_static=u.numpy()[None], xy_indices=(0, 1), device='cpu');"
        " S.mcsolve_rk4(np.eye(8)[0], plan, np.zeros(8), ((0, 1, 1),), 2, 3,"
        " [np.diag([1.0, 0.0])], ntraj=2, seed=1, device='cpu')",
        _EOM_SEQUENCE,
        "import pulser_tpu_torch.backend, pulser_tpu_torch.backend.abc,"
        " pulser_tpu_torch.backend.aggregators,"
        " pulser_tpu_torch.backend.config,"
        " pulser_tpu_torch.backend.default_observables,"
        " pulser_tpu_torch.backend.observable,"
        " pulser_tpu_torch.backend.operator,"
        " pulser_tpu_torch.backend.results, pulser_tpu_torch.backend.state,"
        " pulser_tpu_torch.backend._classproperty,"
        " pulser_tpu_torch.exceptions.serialization,"
        " pulser_tpu_torch.math.multinomial, pulser_tpu_torch.result",
        "import pulser_tpu_torch.emulator.torch_backend,"
        " pulser_tpu_torch.emulator.torch_config,"
        " pulser_tpu_torch.emulator.torch_state,"
        " pulser_tpu_torch.emulator.torch_op,"
        " pulser_tpu_torch.emulator.aggregators",
        _BACKEND_RUN,
        "import pulser_tpu_torch.register.register3d,"
        " pulser_tpu_torch.register.special_layouts,"
        " pulser_tpu_torch.register._layout_gen,"
        " pulser_tpu_torch.register._reg_drawer,"
        " pulser_tpu_torch.sequence._seq_drawer,"
        " pulser_tpu_torch.sequence.helpers._switch_device",
        "import chip_smoke; chip_smoke.regnoise10_sequence();"
        " chip_smoke.tri16_sequence(); chip_smoke.tri16_direct_sequence()",
        "import pulser_tpu_torch.json.coders,"
        " pulser_tpu_torch.json.supported, pulser_tpu_torch.json.utils,"
        " pulser_tpu_torch.json.abstract_repr.serializer,"
        " pulser_tpu_torch.json.abstract_repr.deserializer,"
        " pulser_tpu_torch.json.abstract_repr.validation,"
        " pulser_tpu_torch.json.abstract_repr.signatures,"
        " pulser_tpu_torch.json.abstract_repr.backend,"
        " pulser_tpu_torch.abstract_repr, pulser_tpu_torch.sequence.metadata,"
        " pulser_tpu_torch.backend.remote, pulser_tpu_torch.backend.qpu,"
        " pulser_tpu_torch.backends",
        "import pulser_tpu_torch as P; P.QPUBackend;"
        " P.backends.QPUBackend, P.backends.TorchBackendV2,"
        " P.backends.QutipBackendV2",
        "import chip_smoke; chip_smoke.wire_payloads();"
        " chip_smoke.wire_noisy10_config("
        "chip_smoke.noisy10_sequence()[1]).to_abstract_repr()",
    ],
)
def test_port_imports_neither_jax_nor_pulser_tpu(statements):
    assert _foreign_modules(statements) == []


#: Blocks matplotlib: an import of it then raises ImportError.
_NO_MATPLOTLIB = "sys.modules['matplotlib'] = None\n"


@pytest.mark.parametrize(
    "statements",
    [
        "import pulser_tpu_torch, pulser_tpu_torch.emulator,"
        " pulser_tpu_torch.register, pulser_tpu_torch.sequence._seq_drawer",
        # TRI16's switch onto AnalogDevice's calibrated layout, and a
        # register-noise run on the CPU, draw nothing
        "import chip_smoke; chip_smoke.tri16_sequence()",
        "import numpy as np, pulser_tpu_torch as P;"
        " from pulser_tpu_torch.emulator import TorchEmulator;"
        " seq = P.Sequence(P.Register.square(2, prefix='q'), P.MockDevice);"
        " seq.declare_channel('r', 'rydberg_global');"
        " seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), 'r');"
        " noise = P.NoiseModel(trap_waist=1.0, trap_depth=150.0,"
        " temperature=50.0, runs=2, samples_per_run=1);"
        " TorchEmulator.from_sequence(seq, noise_model=noise,"
        " torch_device='cpu').run()",
    ],
)
def test_port_imports_and_runs_without_matplotlib(statements):
    """The card's machine has no matplotlib: the package imports and
    runs without it (the drawers import it only when they draw)."""
    assert _foreign_modules(_NO_MATPLOTLIB + statements) == []


def test_decoding_foreign_json_imports_neither(tmp_path):
    """Legacy JSON that names ``pulser_tpu.*`` modules (the JAX
    package's) or ``pulser.*`` modules (the reference's), and abstract
    reprs the JAX package wrote, decode into the port's classes without
    importing ``jax`` or ``pulser_tpu``."""
    import warnings

    import pulser_tpu as tpu
    from test_torch_sequence import SCENARIOS, _rng

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # phase shifts on all qubits
        seq = SCENARIOS["global_local"](tpu, _rng(3))
        legacy = seq._serialize()
        files = {
            "jax.json": legacy,
            "ref.json": legacy.replace('"pulser_tpu.', '"pulser.'),
            "sequence.json": seq.to_abstract_repr(),
            "device.json": tpu.AnalogDevice.to_abstract_repr(),
            "noise.json": tpu.NoiseModel(
                dephasing_rate=0.1
            ).to_abstract_repr(),
        }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    code = f"""
import pathlib, warnings
warnings.simplefilter("ignore")
import pulser_tpu_torch as P
d = pathlib.Path({str(tmp_path)!r})
for name in ("jax.json", "ref.json"):
    seq = P.Sequence._deserialize((d / name).read_text())
    assert type(seq) is P.Sequence and '"pulser_tpu_torch.' in seq._serialize()
seq = P.Sequence.from_abstract_repr((d / "sequence.json").read_text())
assert seq.to_abstract_repr() == (d / "sequence.json").read_text()
assert P.devices.Device.from_abstract_repr((d / "device.json").read_text())
assert P.NoiseModel.from_abstract_repr((d / "noise.json").read_text())
"""
    assert _foreign_modules(code) == []


#: Blocks both JSON-schema validators.
_NO_VALIDATOR = (
    "sys.modules['fastjsonschema'] = None\n"
    "sys.modules['jsonschema'] = None\n"
)


def test_port_imports_without_a_schema_validator():
    """``import pulser_tpu_torch`` needs no validator; asking for a
    validation without one raises the ``ImportError`` that names both
    packages (nothing is skipped), and ``skip_validation`` still writes."""
    code = _NO_VALIDATOR + """
import pulser_tpu_torch as P
seq = P.Sequence(P.Register.square(1, prefix="q"), P.MockDevice)
seq.declare_channel("ryd", "rydberg_global")
assert seq.to_abstract_repr(skip_validation=True)
try:
    seq.to_abstract_repr()
except ImportError as e:
    assert "'fastjsonschema'" in str(e) and "'jsonschema'" in str(e), e
else:
    raise AssertionError("validated without a validator")
"""
    assert _foreign_modules(code) == []
