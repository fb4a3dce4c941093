"""Drawing of sequences and samples with matplotlib.

Functional counterpart of reference
``pulser-core/pulser/sequence/_seq_drawer.py:203-1463``: input vs
modulated-output curves, phase curves (or the equivalent phase
modulation), pulse phase/area annotations, EOM-interval shading, target
bars on local channels, phase-shift markers, interpolation points,
detuning-map panels and per-qubit amp/det figures with a color legend.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Optional

import numpy as np

if TYPE_CHECKING:
    from matplotlib.axes import Axes
    from matplotlib.figure import Figure

    from pulser_tpu_torch.register.base_register import BaseRegister
    from pulser_tpu_torch.sampler.samples import SequenceSamples
    from pulser_tpu_torch.sequence.sequence import Sequence

# One fixed color per curve kind, shared by every panel
CURVE_COLORS = {"amp": "darkgreen", "det": "indigo", "phase": "crimson"}
EOM_SHADE = dict(color="steelblue", alpha=0.14, zorder=0)
TARGET_SHADE = dict(color="grey", alpha=0.18, zorder=0)


def _np(arr: Any) -> np.ndarray:
    return arr.as_array(detach=True)


def _phase_of(cs: Any, phase_modulated: bool) -> np.ndarray:
    if phase_modulated:
        return _np(cs.phase_modulation)
    return _np(cs.centered_phase)


def _curve(
    ax: Axes,
    t: np.ndarray,
    values: np.ndarray,
    kind: str,
    label: str,
    dashed: bool = False,
) -> None:
    color = CURVE_COLORS[kind]
    style = "--" if dashed else "-"
    alpha = 0.7 if dashed else 1.0
    ax.plot(t, values, style, color=color, alpha=alpha, label=label)
    if kind != "phase":
        ax.fill_between(t, 0, values, color=color, alpha=0.2 * alpha)


class _ChannelPanels:
    """The (amp, det[, phase]) axes stack of one channel."""

    def __init__(self, axes_rows: list, draw_phase_curve: bool):
        self.amp: Axes = axes_rows[0]
        self.det: Axes = axes_rows[1]
        self.phase: Axes | None = (
            axes_rows[2] if draw_phase_curve else None
        )

    def all_axes(self) -> list[Axes]:
        out = [self.amp, self.det]
        if self.phase is not None:
            out.append(self.phase)
        return out

    def plot_samples(
        self, cs: Any, label: str, phase_modulated: bool, dashed: bool
    ) -> None:
        t = np.arange(cs.duration)
        _curve(self.amp, t, _np(cs.amp), "amp", label, dashed)
        _curve(self.det, t, _np(cs.det), "det", label, dashed)
        if self.phase is not None:
            phase = _phase_of(cs, phase_modulated)
            scale = 1.0 if phase_modulated else np.pi
            _curve(
                self.phase, t, phase / scale, "phase", label, dashed
            )

    def label(self, ch: str, phase_modulated: bool) -> None:
        self.amp.set_ylabel(r"$\Omega$ (rad/µs)", fontsize=10)
        self.det.set_ylabel(r"$\delta$ (rad/µs)", fontsize=10)
        if self.phase is not None:
            self.phase.set_ylabel(
                r"$\phi$ (rad)"
                if phase_modulated
                else r"$\phi$ ($\pi$ rad)",
                fontsize=10,
            )
        self.amp.set_title(f"Channel: {ch}", loc="left", fontsize=10)


def _annotate_phase_area(
    panels: _ChannelPanels, cs: Any, draw_phase: bool
) -> None:
    """Writes each pulse's area (and phase) over the amplitude curve."""
    amp = _np(cs.amp)
    phase = _np(cs.phase)
    top = float(amp.max()) if len(amp) else 0.0
    for slot in cs.slots:
        area = float(np.sum(amp[slot.ti : slot.tf])) * 1e-3 / np.pi
        if not area:
            continue
        mid = (slot.ti + slot.tf) / 2
        txt = f"A: {area:.3g}π"
        if draw_phase:
            ph = float(phase[slot.ti]) / np.pi
            txt = f"{txt}\nφ: {ph:.3g}π"
        panels.amp.annotate(
            txt,
            (mid, top * 0.95),
            ha="center",
            va="top",
            fontsize=8,
        )


def _shade_eom_intervals(
    panels: _ChannelPanels, seq: Sequence, ch: str, t_max: int
) -> None:
    """Marks EOM-mode blocks on every panel of the channel."""
    for block in seq._schedule[ch].eom_blocks:
        tf = block.tf if block.tf is not None else t_max
        for ax in panels.all_axes():
            ax.axvspan(block.ti, tf, **EOM_SHADE)
        panels.amp.annotate(
            "EOM",
            ((block.ti + tf) / 2, 0),
            ha="center",
            va="bottom",
            fontsize=8,
            color="steelblue",
        )


def _draw_target_bars(
    panels: _ChannelPanels, seq: Sequence, ch: str
) -> None:
    """Greys out retarget intervals and names the current targets."""
    schedule = seq._schedule[ch]
    if schedule.channel_obj.addressing != "Local":
        return
    for slot in schedule:
        if slot.type != "target":
            continue
        names = ", ".join(map(str, sorted(slot.targets, key=str)))
        if slot.ti >= 0 and slot.tf > slot.ti:
            panels.amp.axvspan(slot.ti, slot.tf, **TARGET_SHADE)
        panels.amp.annotate(
            names,
            (max(slot.tf, 0), 0),
            ha="left",
            va="bottom",
            fontsize=7,
            color="dimgrey",
        )


def _draw_phase_shift_marks(
    panels: _ChannelPanels, seq: Sequence, ch: str, t_max: int
) -> None:
    """Dotted verticals wherever a target's phase reference jumps."""
    basis = seq.declared_channels[ch].basis
    if basis not in seq._basis_ref:
        return
    marks: set[float] = set()
    for ref in seq._basis_ref[basis].values():
        for t, change in ref.phase.changes(0, t_max):
            if change:
                marks.add(float(t))
    for t in sorted(marks):
        for ax in panels.all_axes():
            ax.axvline(
                t, linestyle=":", color="black", linewidth=0.7, alpha=0.6
            )


def _draw_interp_points(
    panels: _ChannelPanels, seq: Sequence, ch: str
) -> None:
    """Marks InterpolatedWaveform control points on their curves."""
    from pulser_tpu_torch.pulse import Pulse
    from pulser_tpu_torch.waveforms import InterpolatedWaveform

    for slot in seq._schedule[ch]:
        if not isinstance(slot.type, Pulse):
            continue
        for wf, ax in (
            (slot.type.amplitude, panels.amp),
            (slot.type.detuning, panels.det),
        ):
            if isinstance(wf, InterpolatedWaveform):
                pts = wf.data_points
                ax.scatter(
                    pts[:, 0] + slot.ti,
                    pts[:, 1],
                    color=CURVE_COLORS[
                        "amp" if ax is panels.amp else "det"
                    ],
                    zorder=5,
                    s=12,
                )


def _qubit_colors(qubits: list) -> dict:
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("tab20" if len(qubits) > 10 else "tab10")
    return {q: cmap(i % cmap.N) for i, q in enumerate(qubits)}


def _draw_per_qubit_content(
    seq: Sequence,
    draw_qubit_amp: bool,
    draw_qubit_det: bool,
) -> tuple[Figure | None, Figure | None]:
    """Per-qubit amp/det curves (one panel per basis and quantity)."""
    import matplotlib.pyplot as plt

    from pulser_tpu_torch.sampler import sample

    nested = sample(seq).to_nested_dict(all_local=True)["Local"]
    wanted = []
    if draw_qubit_amp:
        wanted.append(("amp", r"$\Omega$ (rad/µs)"))
    if draw_qubit_det:
        wanted.append(("det", r"$\delta$ (rad/µs)"))
    rows = [
        (basis, key, ylab)
        for basis in nested
        for key, ylab in wanted
    ]
    if not rows:
        return None, None

    fig, axes = plt.subplots(
        nrows=len(rows),
        ncols=1,
        sharex=True,
        figsize=(12, 2.4 * len(rows)),
        squeeze=False,
    )
    all_qubits = sorted(
        {q for basis in nested for q in nested[basis]}, key=str
    )
    colors = _qubit_colors(all_qubits)
    for row, (basis, key, ylab) in enumerate(rows):
        ax = axes[row][0]
        for q, data in nested[basis].items():
            values = np.asarray(data[key], dtype=float)
            ax.plot(
                np.arange(len(values)),
                values,
                color=colors[q],
                label=str(q),
            )
        ax.set_ylabel(ylab, fontsize=10)
        ax.set_title(
            f"Basis: {basis} — per-qubit {key}", loc="left", fontsize=10
        )
    axes[-1][0].set_xlabel("t (ns)")
    fig.tight_layout()

    # A standalone legend figure mapping colors to qubit ids
    fig_legend = plt.figure(figsize=(2.2, 0.3 * len(all_qubits) + 0.6))
    handles = [
        plt.Line2D([0], [0], color=colors[q], label=str(q))
        for q in all_qubits
    ]
    fig_legend.legend(handles=handles, loc="center", title="Qubits")
    return fig, fig_legend


def _declared_detuning_maps(seq: Sequence) -> dict[str, Any]:
    from pulser_tpu_torch.sequence._schedule import _DMMSchedule

    return {
        ch: sched.detuning_map
        for ch, sched in seq._schedule.items()
        if isinstance(sched, _DMMSchedule)
    }


def _draw_register_area(
    seq: Sequence, draw_register: bool, draw_detuning_maps: bool
) -> Figure | None:
    """The register and/or detuning-map figure, when requested."""
    import matplotlib.pyplot as plt

    det_maps = (
        _declared_detuning_maps(seq) if draw_detuning_maps else {}
    )
    n_panels = int(draw_register) + len(det_maps)
    if n_panels == 0:
        return None
    fig, axes = plt.subplots(
        ncols=n_panels,
        nrows=1,
        figsize=(5.5 * n_panels, 5),
        squeeze=False,
    )
    col = 0
    if draw_register:
        reg = seq.register
        reg._draw_2D(
            axes[0][col],
            reg._coords_arr.as_array(detach=True),
            list(reg.qubit_ids),
            masked_qubits=seq._slm_mask_targets,
        )
        axes[0][col].set_title("Register")
        col += 1
    for name, dmap in det_maps.items():
        dmap.draw(custom_ax=axes[0][col], show=False)
        axes[0][col].set_title(f"Detuning map: {name}")
        col += 1
    return fig


def draw_samples(
    sampled_seq: SequenceSamples,
    register: Optional[BaseRegister] = None,
    sampling_rate: float = 1.0,
    draw_phase_area: bool = False,
    draw_phase_shifts: bool = False,
    draw_phase_curve: bool = False,
) -> Figure:
    """Draws a SequenceSamples object, one panel row per channel."""
    import matplotlib.pyplot as plt

    n_channels = len(sampled_seq.channels)
    rows_per_ch = 3 if draw_phase_curve else 2
    fig, axes = plt.subplots(
        nrows=n_channels * rows_per_ch,
        ncols=1,
        sharex=True,
        figsize=(12, 2.2 * n_channels * rows_per_ch),
        squeeze=False,
    )
    for i, (ch, cs) in enumerate(
        zip(sampled_seq.channels, sampled_seq.samples_list)
    ):
        rows = [axes[i * rows_per_ch + r][0] for r in range(rows_per_ch)]
        panels = _ChannelPanels(rows, draw_phase_curve)
        panels.plot_samples(
            cs, label=ch, phase_modulated=False, dashed=False
        )
        panels.label(ch, phase_modulated=False)
        if draw_phase_area:
            _annotate_phase_area(panels, cs, draw_phase=True)
    axes[-1][0].set_xlabel("t (ns)")
    fig.tight_layout()
    return fig


def draw_sequence(
    seq: Sequence,
    sampling_rate: Optional[float] = None,
    draw_phase_area: bool = False,
    draw_interp_pts: bool = True,
    draw_phase_shifts: bool = False,
    draw_register: bool = False,
    draw_input: bool = True,
    draw_modulation: bool = False,
    draw_phase_curve: bool = False,
    draw_detuning_maps: bool = False,
    draw_qubit_amp: bool = False,
    draw_qubit_det: bool = False,
    phase_modulated: bool = False,
) -> tuple[Figure | None, Figure, Figure | None, Figure | None]:
    """Draws a sequence: input and/or expected-output curves per channel.

    Returns:
        (register/detuning-map figure or None, pulses figure, per-qubit
        figure or None, per-qubit legend figure or None)
    """
    import matplotlib.pyplot as plt

    from pulser_tpu_torch.sampler import sample

    fig_reg = _draw_register_area(
        seq,
        draw_register and not seq.is_register_mappable(),
        draw_detuning_maps,
    )
    fig_qubit, fig_legend = (
        _draw_per_qubit_content(seq, draw_qubit_amp, draw_qubit_det)
        if (draw_qubit_amp or draw_qubit_det)
        and seq.get_duration() > 0
        else (None, None)
    )

    channels = list(seq.declared_channels.keys())
    n_channels = max(len(channels), 1)
    rows_per_ch = 3 if draw_phase_curve else 2
    fig, axes = plt.subplots(
        nrows=n_channels * rows_per_ch,
        ncols=1,
        sharex=True,
        figsize=(12, 2.2 * n_channels * rows_per_ch),
        squeeze=False,
    )

    if channels and seq.get_duration() > 0:
        input_samples = sample(seq)
        t_max = seq.get_duration(include_fall_time=draw_modulation)
        mod_samples = None
        if draw_modulation:
            import warnings

            with warnings.catch_warnings():
                # Channels without a modulation bandwidth pass their
                # input through unchanged; no need to warn when the
                # overlay is only drawn for modulated channels
                warnings.filterwarnings(
                    "ignore", message="No modulation bandwidth"
                )
                mod_samples = sample(
                    seq, modulation=True, extended_duration=t_max
                )
        for i, ch in enumerate(channels):
            rows = [
                axes[i * rows_per_ch + r][0] for r in range(rows_per_ch)
            ]
            panels = _ChannelPanels(rows, draw_phase_curve)
            if draw_input:
                panels.plot_samples(
                    input_samples.channel_samples[ch],
                    label="input",
                    phase_modulated=phase_modulated,
                    dashed=False,
                )
            if (
                mod_samples is not None
                and seq.declared_channels[ch].mod_bandwidth
            ):
                panels.plot_samples(
                    mod_samples.channel_samples[ch],
                    label="output",
                    phase_modulated=phase_modulated,
                    dashed=True,
                )
            panels.label(ch, phase_modulated)
            if draw_phase_area:
                _annotate_phase_area(
                    panels,
                    input_samples.channel_samples[ch],
                    draw_phase=not phase_modulated,
                )
            _shade_eom_intervals(panels, seq, ch, t_max)
            _draw_target_bars(panels, seq, ch)
            if draw_phase_shifts:
                _draw_phase_shift_marks(panels, seq, ch, t_max)
            if draw_interp_pts:
                _draw_interp_points(panels, seq, ch)
    axes[-1][0].set_xlabel("t (ns)")
    fig.tight_layout()

    return fig_reg, fig, fig_qubit, fig_legend
