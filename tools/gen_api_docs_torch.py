"""Generates ``docs/API_torch.md`` from the PyTorch port's public surface.

The port's counterpart of ``tools/gen_api_docs.py``, whose helpers
(``_sig``, ``_summary``, ``_public_names``, ``_emit_class``) it reuses:
that module imports only the standard library. Walks the section list
below, pulls each public class's and function's signature and docstring
summary, and writes one markdown page. Run from the repo root:

    python tools/gen_api_docs_torch.py

The page is committed; ``tests/test_torch_api_docs.py`` checks that it
regenerates unchanged, so re-run this script after changing the port's
public API.
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tools.gen_api_docs import (  # noqa: E402
    _emit_class,
    _public_names,
    _sig,
    _summary,
)

OUT = os.path.join(REPO, "docs", "API_torch.md")

#: (module, heading, blurb) in presentation order.
SECTIONS = [
    (
        "pulser_tpu_torch",
        "Top level",
        "Everything a typical pulse-level program needs, re-exported.",
    ),
    (
        "pulser_tpu_torch.waveforms",
        "Waveforms",
        "Time-dependent pulse envelopes (host-side numpy; a torch tensor"
        " that requires grad flows through `pulser_tpu_torch.math`).",
    ),
    (
        "pulser_tpu_torch.pulse",
        "Pulse",
        "Amplitude + detuning + phase triple.",
    ),
    (
        "pulser_tpu_torch.parametrized",
        "Parametrized objects",
        "Deferred-evaluation DAG for variable-bearing sequences.",
    ),
    (
        "pulser_tpu_torch.register",
        "Registers & layouts",
        "Atom coordinates, trap layouts, mappable registers, weight maps.",
    ),
    (
        "pulser_tpu_torch.devices",
        "Devices",
        "Hardware specification dataclasses and the concrete devices.",
    ),
    (
        "pulser_tpu_torch.channels",
        "Channels",
        "Addressing channels, EOM configs and the DMM.",
    ),
    (
        "pulser_tpu_torch.sequence",
        "Sequence",
        "The timeline builder: pulses, targets, EOM mode, SLM masks.",
    ),
    (
        "pulser_tpu_torch.sampler",
        "Sampler",
        "Dense per-channel time series extracted from a sequence.",
    ),
    (
        "pulser_tpu_torch.noise_model",
        "Noise model",
        "The 12-type physical noise specification.",
    ),
    (
        "pulser_tpu_torch.hamiltonian_data",
        "Physics IR",
        "Samples, register and noise model turned into noise trajectories"
        " and their Hamiltonian data.",
    ),
    (
        "pulser_tpu_torch.backend",
        "Backend API",
        "Backend ABCs, emulation configs, observables, results.",
    ),
    (
        "pulser_tpu_torch.emulator",
        "Emulator",
        "The statevector/density-matrix emulator on a CUDA card (or the"
        " CPU, when asked for) and its states/operators/results.",
    ),
    (
        "pulser_tpu_torch.ops",
        "Solvers and Hamiltonian application",
        "The structured H·ψ and the RK4 solvers in torch; the CUDA"
        " kernels load on their first launch.",
    ),
    (
        "pulser_tpu_torch.parallel",
        "Multi-card parallelism",
        "Trajectory and state sharding on `torch.distributed`, and the"
        " device-memory capacity contract.",
    ),
    (
        "pulser_tpu_torch.serving",
        "Serving",
        "The resident solve daemon and its thin client (warm emulation"
        " on the card for fresh processes).",
    ),
    (
        "pulser_tpu_torch.math",
        "Math layer",
        "The numpy/torch-dispatching array abstraction.",
    ),
    (
        "pulser_tpu_torch.json.abstract_repr",
        "Serialization",
        "The abstract-repr JSON wire format (reference-schema"
        " compatible).",
    ),
    (
        "pulser_tpu_torch.exceptions",
        "Exceptions",
        "The error hierarchy.",
    ),
]


def render() -> str:
    """The page's text."""
    seen: set[int] = set()
    lines = [
        "# API reference — the PyTorch port",
        "",
        "Generated by `tools/gen_api_docs_torch.py` — do not edit by hand.",
        "Signatures and summaries come straight from the docstrings of",
        "`pulser_tpu_torch`; `docs/API.md` is the JAX package's page.",
        "",
    ]
    for mod_name, heading, blurb in SECTIONS:
        mod = importlib.import_module(mod_name)
        lines.append(f"## {heading} — `{mod_name}`\n")
        lines.append(blurb + "\n")
        for nm in _public_names(mod):
            obj = getattr(mod, nm, None)
            if obj is None or id(obj) in seen:
                continue
            seen.add(id(obj))
            if inspect.isclass(obj):
                _emit_class(obj, lines)
            elif inspect.isfunction(obj):
                lines.append(f"### `{nm}{_sig(obj)}`\n")
                lines.append(_summary(obj) + "\n")
            else:  # constants / instances (e.g. concrete devices)
                kind = type(obj).__name__
                lines.append(f"### `{nm}` *(instance of `{kind}`)*\n")
                summ = _summary(obj)
                if summ:
                    lines.append(summ + "\n")
    return "\n".join(lines) + "\n"


def main() -> None:
    text = render()
    with open(OUT, "w") as f:
        f.write(text)
    print(f"wrote {OUT}: {text.count(chr(10))} lines")


if __name__ == "__main__":
    main()
