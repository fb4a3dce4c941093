"""Executes the port's literate tutorials into narrated markdown.

The sources in ``docs/tutorials_torch/src/*.py`` are the JAX package's
tutorials (``docs/tutorials/src``) on ``pulser_tpu_torch``: the same
py-percent cells (``parse_cells`` of ``tools/build_tutorials.py``), the
same registers, pulses, noise models, seeds and asserts, every emulator
built with ``torch_device=DEVICE``. This script runs each code cell in
one namespace that holds ``DEVICE``, captures its stdout and its
matplotlib figures, and writes ``<out>/<name>.md`` with the figures in
``<out>/figs/``.

Usage:
    python tools/build_tutorials_torch.py [--device cuda|cpu] [--out DIR]
        [name ...]   # default: all, on the card, into docs/tutorials_torch

There is no fallback: without a card and without ``--device cpu`` the
first emulator raises the port's "No CUDA device is visible" error. The
committed pages are built with ``--device cpu`` (they print physics
values, no times). A host without matplotlib (the card's machine) runs
every cell and every assert with an inert stand-in for
``matplotlib.pyplot``, and the page then has no figures.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time
import types
from typing import Any, Callable

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools.build_tutorials import parse_cells  # noqa: E402

SRC = os.path.join(ROOT, "docs", "tutorials_torch", "src")
OUT = os.path.join(ROOT, "docs", "tutorials_torch")

#: ``on_cell(index, code, seconds)``, called after each code cell ran.
CellHook = Callable[[int, str, float], None]


def names() -> list[str]:
    """Every tutorial source, in order."""
    return sorted(
        os.path.splitext(f)[0] for f in os.listdir(SRC) if f.endswith(".py")
    )


class _Inert:
    """Stands for any matplotlib object on a host without matplotlib:
    every attribute, call and item gives another one, and it unpacks
    into two (``fig, ax = plt.subplots()``)."""

    def __getattr__(self, name: str) -> "_Inert":
        if name.startswith("__"):
            raise AttributeError(name)
        return _Inert()

    def __call__(self, *args, **kwargs) -> "_Inert":
        return _Inert()

    def __getitem__(self, key) -> "_Inert":
        return _Inert()

    def __iter__(self):
        return iter((_Inert(), _Inert()))


def _inert_attr(name: str) -> _Inert:
    if name.startswith("__"):
        raise AttributeError(name)
    return _Inert()


def _inert_matplotlib() -> dict:
    """``sys.modules`` entries that make ``matplotlib`` and the
    submodules the tutorials and the port's drawers import inert."""
    mods = {}
    for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.patches"):
        mod = types.ModuleType(name)
        mod.__getattr__ = _inert_attr  # type: ignore[attr-defined]
        mod.__path__ = []  # type: ignore[attr-defined]
        mods[name] = mod
    return mods


@contextlib.contextmanager
def _pyplot():
    """matplotlib's pyplot on the Agg backend; without matplotlib, None,
    with the inert stand-in in ``sys.modules`` until the block ends."""
    try:
        import matplotlib
    except ImportError:
        stand_in = _inert_matplotlib()
        saved = {k: sys.modules[k] for k in stand_in if k in sys.modules}
        sys.modules.update(stand_in)
        try:
            yield None
        finally:
            for name in stand_in:
                sys.modules.pop(name, None)
            sys.modules.update(saved)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    yield plt


def execute(
    name: str,
    device: str,
    out_dir: str | None = None,
    on_cell: CellHook | None = None,
) -> dict:
    """Runs tutorial ``name`` with ``DEVICE = device`` and returns the
    cells' namespace. With ``out_dir``, writes ``<out_dir>/<name>.md``
    and the figures under ``<out_dir>/figs``. A failing cell raises."""
    with _pyplot() as plt:
        cells = parse_cells(os.path.join(SRC, name + ".py"))
        ns: dict = {"__name__": f"tutorial_{name}", "DEVICE": device}
        parts: list[str] = []
        fig_idx = 0
        figs = None if out_dir is None else os.path.join(out_dir, "figs")
        if figs is not None:
            os.makedirs(figs, exist_ok=True)
        for index, (kind, text) in enumerate(cells):
            if kind == "markdown":
                parts.append(text)
                continue
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    exec(compile(text, f"{name}.py", "exec"), ns)  # noqa: S102
            except Exception as exc:
                exc.add_note(f"in tutorial {name}, cell:\n{text}")
                raise
            if on_cell is not None:
                on_cell(index, text, time.perf_counter() - t0)
            parts.append(f"```python\n{text}\n```")
            out = buf.getvalue().rstrip()
            if out:
                parts.append(f"```\n{out}\n```")
            if plt is None:
                continue
            for num in plt.get_fignums():
                fig_idx += 1
                fname = f"{name}_{fig_idx:02d}.png"
                if figs is not None:
                    plt.figure(num).savefig(
                        os.path.join(figs, fname), dpi=110, bbox_inches="tight"
                    )
                    parts.append(f"![{name} figure {fig_idx}](figs/{fname})")
            plt.close("all")
    if out_dir is not None:
        with open(os.path.join(out_dir, name + ".md"), "w") as f:
            f.write("\n\n".join(parts) + "\n")
    return ns


def _state(result: Any) -> np.ndarray:
    state = np.asarray(result.get_final_state().full())[:, 0]
    return state.astype(np.complex128)


def _probabilities(counts: Any) -> dict[str, float]:
    total = sum(counts.values())
    return {k: v / total for k, v in sorted(counts.items())}


#: The values each tutorial is checked on, read off its namespace (the
#: JAX tutorial's or the port's: the two run the same code), as
#: ``{key: (kind, value)}``. Kinds: ``state`` (a ket, compared by
#: 1 − F), ``rho`` (a density matrix), ``populations`` (real arrays
#: or numbers), ``counts`` (bitstring frequencies, compared by total
#: variation distance) and ``exact``.
KEY_VALUES: dict[str, Callable[[dict], dict[str, tuple[str, Any]]]] = {
    "01_afm_state_prep": lambda ns: {
        "final_state": ("state", _state(ns["results"])),
        "staggered_magnetization": ("populations", np.asarray(ns["order"])),
        "counts": ("counts", _probabilities(ns["counts"])),
    },
    "02_noisy_simulation": lambda ns: {
        "rho_deph": ("rho", np.asarray(ns["rho"], np.complex128)),
        "occupation_deph": ("populations", np.asarray(ns["occ_noisy"])),
        "occupation_clean": ("populations", np.asarray(ns["occ_clean"])),
        "counts_traj": ("counts", _probabilities(ns["counts"])),
        "counts_jumps": ("counts", _probabilities(ns["counts3"])),
        "counts_spam": ("counts", _probabilities(ns["counts4"])),
        "counts_seeded": ("counts", _probabilities(ns["a"])),
    },
    "03_slm_mask_dmm": lambda ns: {
        "final_state": ("state", _state(ns["res"])),
        "dmm_ratio": ("populations", float(ns["ratio"])),
        "counts": ("counts", _probabilities(ns["counts"])),
    },
    "04_eom_mode": lambda ns: {
        "final_state": ("state", _state(ns["res"])),
        "detuning_off": ("exact", float(ns["det_off"])),
    },
    "05_xy_spin_exchange": lambda ns: {
        "occupation": ("populations", np.asarray(ns["occ"])),
        "occupation_along": ("populations", np.asarray(ns["along"])),
        "occupation_magic": ("populations", np.asarray(ns["magic"])),
    },
    "06_qaoa_qubo": lambda ns: {
        "best_params": ("exact", [float(x) for x in ns["best_params"]]),
        "probabilities": ("populations", np.asarray(ns["probs"])),
        "top": ("exact", ns["top"]),
    },
}


def difference(kind: str, want: Any, got: Any) -> float:
    """How far ``got`` is from ``want`` for a key of ``kind``: 1 − F for
    a state, max |Δ| for a density matrix or populations, the total
    variation distance for counts, 0 or inf for an exact value."""
    if kind == "state":
        want, got = np.asarray(want), np.asarray(got)
        overlap = abs(np.vdot(want, got)) ** 2
        norms = np.vdot(want, want).real * np.vdot(got, got).real
        return float(1 - overlap / norms)
    if kind in ("rho", "populations"):
        return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    if kind == "counts":
        keys = set(want) | set(got)
        return 0.5 * sum(abs(want.get(k, 0.0) - got.get(k, 0.0)) for k in keys)
    return 0.0 if want == got else float("inf")


def encode(values: dict[str, tuple[str, Any]]) -> dict:
    """Key values as JSON (complex arrays as their real and imaginary
    parts)."""
    out = {}
    for key, (kind, value) in values.items():
        if isinstance(value, np.ndarray):
            value = (
                [value.real.tolist(), value.imag.tolist()]
                if np.iscomplexobj(value)
                else value.tolist()
            )
        out[key] = {"kind": kind, "value": value}
    return out


def decode(encoded: dict) -> dict[str, tuple[str, Any]]:
    """The inverse of :func:`encode`."""
    out = {}
    for key, entry in encoded.items():
        kind, value = entry["kind"], entry["value"]
        if kind in ("state", "rho"):
            value = np.asarray(value[0]) + 1j * np.asarray(value[1])
        elif kind == "populations":
            value = np.asarray(value)
        out[key] = (kind, value)
    return out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    for name in args.names or names():
        print(f"building {name} on {args.device} ...", flush=True)
        execute(name, args.device, args.out)
        print("  ->", os.path.join(args.out, name + ".md"), flush=True)


if __name__ == "__main__":
    main()
