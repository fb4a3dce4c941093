"""The port's drawers against pulser_tpu's, on the Agg backend.

After ``tests/test_drawers.py``: each scenario draws with one package
namespace; both packages' figures must then have the same number of
figures and axes, and in each axes the same titles and labels, the same
texts, the same numbers of patches and collections, and the same line
data (within 1e-12). ``plt.show`` is replaced by a no-op and every
figure is closed after each scenario.
"""

from __future__ import annotations

import warnings

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pulser_tpu as tpu  # noqa: E402

import pulser_tpu_torch as ptt  # noqa: E402

torch.set_num_threads(1)

LINE_TOL = 1e-12


def _axes_facts(ax) -> dict:
    return {
        "title": ax.get_title(),
        "labels": (ax.get_xlabel(), ax.get_ylabel()),
        "texts": [t.get_text() for t in ax.texts],
        "patches": len(ax.patches),
        "collections": len(ax.collections),
        "legend": (
            None
            if ax.get_legend() is None
            else [t.get_text() for t in ax.get_legend().get_texts()]
        ),
        "lines": [
            (
                ln.get_label(),
                ln.get_linestyle(),
                np.asarray(ln.get_xdata(), dtype=float),
                np.asarray(ln.get_ydata(), dtype=float),
            )
            for ln in ax.lines
        ],
    }


def figure_facts() -> list:
    """Every open figure, axes by axes, in creation order."""
    return [
        {
            "axes": [_axes_facts(ax) for ax in plt.figure(num).axes],
            "legends": [
                [t.get_text() for t in leg.get_texts()]
                for leg in plt.figure(num).legends
            ],
        }
        for num in plt.get_fignums()
    ]


def assert_same_figures(a, b, where="figures") -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            assert_same_figures(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_figures(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape, where
        assert np.allclose(a, b, rtol=0, atol=LINE_TOL, equal_nan=True), (
            where
        )
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _basic_sequence(P):
    reg = P.Register({"q0": (0, 0), "q1": (0, 8)})
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.declare_channel("ram", "raman_local", initial_target="q0")
    seq.add(
        P.Pulse.ConstantDetuning(
            P.InterpolatedWaveform(300, [0.0, 2.0, 0.0]), -1.0, 0.5
        ),
        "ryd",
    )
    seq.add(P.Pulse.ConstantPulse(200, 1.0, 0.0, 0.0), "ram")
    seq.phase_shift(0.4, "q0", basis="digital")
    seq.target("q1", "ram")
    seq.phase_shift(0.6, "q1", basis="digital")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ram")
    return seq


def _eom_sequence(P):
    reg = P.Register({"q0": (0, 0), "q1": (0, 10)})
    seq = P.Sequence(reg, P.AnalogDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.enable_eom_mode("ryd", amp_on=2.0, detuning_on=0.0)
    seq.add_eom_pulse("ryd", duration=100, phase=0.0)
    seq.disable_eom_mode("ryd")
    seq.add(P.Pulse.ConstantPulse(120, 2.0, 0.0, 0.0), "ryd")
    return seq


def _dmm_sequence(P):
    reg = P.Register.square(2, spacing=6, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    dmap = reg.define_detuning_map({"q0": 1.0, "q3": 0.5})
    seq.config_detuning_map(dmap, "dmm_0")
    seq.add_dmm_detuning(P.ConstantWaveform(100, -2.0), "dmm_0")
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.0, 0.0), "ryd")
    seq.config_slm_mask(["q1"])
    seq.add(P.Pulse.ConstantPulse(100, 1.0, 0.5, 0.0), "ryd")
    return seq


def _emulator(P, seq, **kw):
    from importlib import import_module

    emulator = import_module(f"{P.__name__}.emulator")
    if P is ptt:
        return emulator.TorchEmulator.from_sequence(
            seq, torch_device="cpu", **kw
        )
    return emulator.TpuEmulator.from_sequence(seq, **kw)


def _results_plot(P, noisy):
    from importlib import import_module

    qobj = import_module(f"{P.__name__}.emulator.qobj")
    reg = P.Register.square(1, prefix="q")
    seq = P.Sequence(reg, P.MockDevice)
    seq.declare_channel("ryd", "rydberg_global")
    seq.add(P.Pulse.ConstantPulse(200, 2 * np.pi, 0.0, 0.0), "ryd")
    kw = {}
    if noisy:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)  # runs=
            kw["noise_model"] = P.NoiseModel(
                state_prep_error=0.2, p_false_pos=0.1, p_false_neg=0.05,
                runs=4, samples_per_run=5,
            )
    np.random.seed(3)
    times = np.linspace(0, 0.2, 5)
    res = _emulator(P, seq, evaluation_times=times, **kw).run()
    op = qobj.basis(2, 0).proj()
    res.plot(op, label="r")
    if noisy:
        res.plot(op, fmt="x", error_bars=False)


def _histogram(P):
    from importlib import import_module

    result = import_module(f"{P.__name__}.result")
    counts = {"000": 50, "011": 30, "110": 15, "111": 1}
    atoms = ("q0", "q1", "q2")
    sampled = result.SampledResult(atoms, "ground-rydberg", counts)
    sampled.plot_histogram(min_rate=0.02, max_n_bitstrings=3, show=False)


SCENARIOS = {
    "sequence_default": lambda P: _basic_sequence(P).draw(show=False),
    "sequence_phase_decorations": lambda P: _basic_sequence(P).draw(
        draw_phase_area=True,
        draw_phase_shifts=True,
        draw_phase_curve=True,
        draw_interp_pts=True,
        show=False,
    ),
    "sequence_register_and_per_qubit": lambda P: _basic_sequence(P).draw(
        draw_register=True, draw_qubit_amp=True, draw_qubit_det=True,
        show=False,
    ),
    "sequence_as_phase_modulated": lambda P: _basic_sequence(P).draw(
        as_phase_modulated=True, show=False
    ),
    "sequence_eom_input_output": lambda P: _eom_sequence(P).draw(
        mode="input+output", show=False
    ),
    "sequence_eom_output": lambda P: _eom_sequence(P).draw(
        mode="output", draw_phase_area=False, draw_interp_pts=False,
        show=False,
    ),
    "sequence_detuning_maps_and_slm": lambda P: _dmm_sequence(P).draw(
        draw_register=True, draw_detuning_maps=True, show=False
    ),
    "emulator_samples": lambda P: _emulator(P, _basic_sequence(P)).draw(
        draw_phase_area=True, draw_phase_shifts=True, draw_phase_curve=True
    ),
    "register_blockade": lambda P: P.Register.square(
        2, spacing=6, prefix="q"
    ).draw(
        blockade_radius=8.0, draw_graph=True, draw_half_radius=True,
        qubit_colors={"q1": "red"}, show=False,
    ),
    "register_empty_sites": lambda P: P.AnalogDevice.pre_calibrated_layouts[0]
    .hexagonal_register(16)
    .draw(draw_empty_sites=True, show=False),
    "register3d_perspective": lambda P: P.Register3D.cubic(
        2, spacing=6.0, prefix="q"
    ).draw(blockade_radius=7.0, with_labels=True),
    "register3d_projection": lambda P: P.Register3D.cuboid(
        2, 2, 3, spacing=6.0, prefix="q"
    ).draw(projection=True, blockade_radius=7.0, draw_half_radius=True),
    "layout_2d": lambda P: P.register.TriangularLatticeLayout(20, 6.0).draw(
        blockade_radius=8.0, draw_half_radius=True, show=False
    ),
    "layout_3d": lambda P: P.register.RegisterLayout(
        [[0, 0, 0], [6, 0, 0], [0, 6, 1], [3, 2, 7]]
    ).draw(blockade_radius=7.0, draw_graph=True, show=False),
    "detuning_map": lambda P: P.Register.square(
        2, spacing=6, prefix="q"
    ).define_detuning_map({"q0": 1.0, "q3": 0.5}).draw(
        labels=["a", "b", "c", "d"], show=False
    ),
    "waveform_with_output": lambda P: P.BlackmanWaveform(500, np.pi).draw(
        output_channel=P.AnalogDevice.channels["rydberg_global"],
        ylabel="Ω",
    ),
    "interpolated_waveform": lambda P: P.InterpolatedWaveform(
        300, [0.0, 2.0, 1.0, 0.0]
    ).draw(),
    "pulse": lambda P: P.Pulse.ConstantDetuning(
        P.BlackmanWaveform(500, np.pi), -1.0, 0.2
    ).draw(),
    "sampled_result_histogram": lambda P: _histogram(P),
    "coherent_results_plot": lambda P: _results_plot(P, noisy=False),
    "noisy_results_plot": lambda P: _results_plot(P, noisy=True),
}


@pytest.fixture
def double():
    """The port in complex128, as the JAX side (the results plots)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_drawing_matches_pulser_tpu(name, monkeypatch, double):
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    facts = []
    for P in (tpu, ptt):
        plt.close("all")
        with warnings.catch_warnings():
            # The switch of the 'output' mode's defaults warns
            warnings.simplefilter("ignore", UserWarning)
            SCENARIOS[name](P)
        facts.append(figure_facts())
        plt.close("all")
    assert facts[0], "nothing was drawn"
    assert_same_figures(*facts)


def test_sequence_draw_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="'mode' must be one of"):
        _basic_sequence(ptt).draw(mode="sideways", show=False)


def test_sequence_draw_saves_every_figure(tmp_path):
    """With ``fig_name``, the pulse, register and per-qubit figures are
    saved under suffixed names, as in pulser_tpu."""
    saved = []
    for P, sub in ((tpu, "jax"), (ptt, "torch")):
        out = tmp_path / sub
        out.mkdir()
        _basic_sequence(P).draw(
            show=False,
            fig_name=str(out / "drawing.png"),
            draw_qubit_amp=True,
            draw_register=True,
        )
        plt.close("all")
        saved.append(sorted(p.name for p in out.iterdir()))
    assert saved[0] == saved[1]
    assert "drawing_register.png" in saved[1]
