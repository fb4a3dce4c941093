"""Times K1 and K3 at several thread-block sizes on their main paths'
own inputs, in turns, on one CUDA card.

K1 (``csrc/ip_sesolve.cu``, ``kMaxThreads``) runs the AFM16 sweep, K3
(``csrc/mcwf.cu``, ``kMaxThreads``) the PAULI10 quantum-jump batch. Each
variant is the kernel's source with that constant changed, built with
nvcc for ``sm_90a`` into ``pulser_tpu_torch/build/`` and called through
the package's wrapper; every result is checked against the shipped
kernel's. Run from the repository root on a machine with the card::

    python3 tools/block_sizes.py
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
import pulser_tpu_torch.ops.kernels as K  # noqa: E402
from pulser_tpu_torch.emulator import TorchEmulator  # noqa: E402
from pulser_tpu_torch.ops import solver as S  # noqa: E402

#: Threads per block to try, per kernel (the first is the shipped value).
VARIANTS = {"ip_sesolve": (512, 256, 1024), "mcwf": (1024, 512, 256)}
_SHIPPED = {"ip_sesolve": 512, "mcwf": 1024}


def _build(name: str) -> dict[int, ctypes.CDLL]:
    """The shipped library and one library per other block size."""
    src_path = K.SOURCES[name]
    src = open(src_path).read()
    common = os.path.join(os.path.dirname(src_path), "common.cuh")
    build_dir = os.path.join(_ROOT, "pulser_tpu_torch", "build")
    os.makedirs(build_dir, exist_ok=True)
    shipped = K._load(name)
    libs = {_SHIPPED[name]: shipped}
    procs = []
    for t in VARIANTS[name][1:]:
        v = src.replace(
            f"kMaxThreads = {_SHIPPED[name]};", f"kMaxThreads = {t};"
        ).replace('#include "common.cuh"', f'#include "{common}"')
        if name == "mcwf":  # only PAULI10's n: 8-32 amplitudes per thread
            big = " PT_MCWF_CASE(11) PT_MCWF_CASE(12)\n    PT_MCWF_CASE(13)"
            assert big in v
            v = v.replace(big, "")
        cu = os.path.join(build_dir, f"{name}_t{t}.cu")
        with open(cu, "w") as f:
            f.write(v)
        so = os.path.join(build_dir, f"lib{name}_t{t}.so")
        cmd = [
            K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", so, cu,
        ]
        procs.append((t, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    for t, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} at {t}:\n{log}")
        keep = "<16,1>" if name == "ip_sesolve" else "<10>"
        print(name, t, [x for x in chip_smoke.ptxas_summary(log) if keep in x])
        lib = ctypes.CDLL(so)
        run = getattr(lib, f"{name}_run")
        shipped_run = getattr(shipped, f"{name}_run")
        run.restype, run.argtypes = shipped_run.restype, shipped_run.argtypes
        libs[t] = lib
    return libs


def _afm16_call():
    samples, register, mock = chip_smoke.afm16_inputs()
    emu = TorchEmulator(
        samples, register, mock,
        evaluation_times=np.linspace(0, samples.max_duration * 1e-3, 101),
    )
    emu.run()
    psi0 = emu._initial_ket().astype(np.complex64)
    args, kw = S.ip_kernel_inputs(
        psi0, emu._plan_cache[1], emu._current_hamiltonian.int_diag, 16,
        "cuda",
    )
    return lambda: K.ip_sesolve(*args, **kw)


def _pauli10_call():
    with open(chip_smoke._PAULI10_GOLDEN) as f:
        seed = json.load(f)["seed"]
    *_, captured = chip_smoke._run_noisy(
        K, chip_smoke.pauli10_inputs(), seed, "mcsolve_rk4_batched", S
    )
    psi0, plans, diags, _, _, _, cops, seeds = captured["args"]
    args, kw = S.mcwf_kernel_inputs(psi0, plans, diags, cops, seeds, "cuda")
    return lambda: K.mcwf(*args, **kw)[0]


def _time(name: str, call) -> None:
    libs = _build(name)
    want = call()
    torch.cuda.synchronize()

    def solve_ms(t: int) -> float:
        K._libs[name] = libs[t]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = call()
        end.record()
        torch.cuda.synchronize()
        K._libs[name] = libs[_SHIPPED[name]]
        # Per trajectory for K3: another block size sums |psi|^2 in
        # another order, which may move one threshold crossing by a step
        diff = (got - want).abs().reshape(got.shape[0], -1).amax(1)
        if int((diff > chip_smoke.MCWF_TOL).sum()) > (name == "mcwf"):
            raise RuntimeError(f"{name} at {t} threads disagrees")
        return start.elapsed_time(end)

    for t in libs:
        solve_ms(t)  # warm-up
    times: dict[int, list[float]] = {t: [] for t in libs}
    for _ in range(3):
        for t in list(libs) + list(libs)[::-1]:
            times[t].append(solve_ms(t))
    card = torch.cuda.get_device_name(0)
    for t, v in times.items():
        print(
            f"{name} at {t} threads per block: median"
            f" {statistics.median(v):.3f} ms of {len(v)} solves on {card}"
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("block_sizes: no CUDA device", file=sys.stderr)
        return 1
    _time("ip_sesolve", _afm16_call())
    _time("mcwf", _pauli10_call())
    return 0


if __name__ == "__main__":
    sys.exit(main())
