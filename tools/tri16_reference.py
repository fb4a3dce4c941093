"""Reference state of the TRI16 run, computed by ``pulser_tpu``.

TRI16 is the usual way to submit a sequence to a real device: it is
designed on ``MockDevice`` and moved with
``seq.with_new_device(AnalogDevice)`` (``chip_smoke.tri16_build``, built
here with ``pulser_tpu``). The register is ``hexagonal_register(16)`` on
``AnalogDevice``'s calibrated ``TriangularLatticeLayout(61, 5)``, the
pulses are AFM16's (Ω = 2π·2, δ from −2π·6 to 2π·2, 252/2700/252 ns),
with 101 evaluation times. The JAX package runs its interaction-picture
sesolve in double precision on the CPU.

Writes ``tests/goldens/tri16_final.npz``: the mid-sweep (index 50) and
final states (complex128), the RK4 step count, the CPU seconds of the
run and the repository commit it ran at. ``chip_smoke.py`` holds the
PyTorch port's TRI16 run on the card against it.

Run from the repository root::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/tri16_reference.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

os.environ.setdefault("PULSER_TPU_DISABLE_SHARDING", "1")

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
import pulser_tpu as tpu  # noqa: E402
from pulser_tpu.emulator import TpuEmulator  # noqa: E402
from pulser_tpu.ops import solver as jax_solver  # noqa: E402

OUT = os.path.join(_ROOT, "tests", "goldens", "tri16_final.npz")


def main() -> None:
    commit = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"], cwd=_ROOT,
        capture_output=True, text=True,
    ).stdout.strip()
    seq = chip_smoke.tri16_build(tpu)
    assert seq.device is tpu.AnalogDevice
    eval_times = np.linspace(0, seq.get_duration() * 1e-3, 101)
    emu = TpuEmulator.from_sequence(seq, evaluation_times=eval_times)
    t0 = time.process_time()
    w0 = time.perf_counter()
    res = emu.run()
    mid = np.asarray(res.states[50].full()).ravel()
    final = np.asarray(res.states[-1].full()).ravel()
    cpu_s = time.process_time() - t0
    wall_s = time.perf_counter() - w0
    info = dict(jax_solver.last_solve_info)
    assert info["ip"] is True, info
    np.savez_compressed(
        OUT,
        mid_state=mid.astype(np.complex128),
        final_state=final.astype(np.complex128),
        n_steps=info["n_steps"],
        cpu_seconds=cpu_s,
        wall_seconds=wall_s,
        commit=commit,
    )
    print(
        f"TRI16: {info['n_steps']} steps, norm {np.linalg.norm(final):.12f},"
        f" {cpu_s:.1f} CPU s ({wall_s:.1f} s wall) at {commit} -> {OUT}"
    )


if __name__ == "__main__":
    main()
