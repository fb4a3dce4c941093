"""Hand-written CUDA kernels and their plain PyTorch versions.

``ip_sesolve`` replaces the TPU kernel ``_ip_sesolve_kernel`` of
``pulser_tpu/ops/pallas_kernels.py``: a fused interaction-picture RK4
sesolve over the evaluation segments of a plan (d=2, one ground-rydberg
basis). Its CUDA source is ``pulser_tpu_torch/csrc/ip_sesolve.cu``, which
says what bounds it on the card and how the design answers that.

The kernel is compiled with ``nvcc`` for ``sm_90a`` on first use into
the package's ``build/`` directory (keyed by a hash of the source) and
loaded with ctypes. A wrapper given CPU tensors runs the plain PyTorch
version of the same function; given CUDA tensors it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "ip_sesolve.cu")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")

#: Calls of the CUDA entry point ``ip_sesolve_run`` (each call launches
#: the stage and emit kernels of one whole solve).
IP_SESOLVE_LAUNCHES = 0

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or PATH.")
    return found


def build_ip_sesolve(verbose: bool = False) -> tuple[str, str]:
    """Compiles ``csrc/ip_sesolve.cu`` unless its library exists.

    Args:
        verbose: Ask ``ptxas`` for each kernel's registers and spills.

    Returns:
        ``(library path, compiler output)``; the output is empty when
        the library was already built.
    """
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD_DIR, f"libip_sesolve_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(),
        "-gencode",
        "arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-o",
        tmp,
        _SRC,
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


def _load() -> ctypes.CDLL:
    """Builds (on first use) and loads the kernel library."""
    global _lib
    if _lib is None:
        path, _ = build_ip_sesolve()
        lib = ctypes.CDLL(path)
        p = ctypes.c_void_p
        lib.ip_sesolve_run.restype = ctypes.c_int
        lib.ip_sesolve_run.argtypes = [p] * 14 + [ctypes.c_int] * 3 + [p]
        _lib = lib
    return _lib


def _check_inputs(
    tensors: dict[str, torch.Tensor],
    shapes: dict[str, tuple[int, ...]],
) -> None:
    """Raises unless every tensor is f32, contiguous, of the given shape
    and on the same device."""
    device = tensors["a_re"].device
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}.")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}.")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous.")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected"
                f" {shapes[name]}."
            )


def _host_steps(
    seg_dts: torch.Tensor, seg_dts_host: np.ndarray | None
) -> np.ndarray:
    """The ``(n_seg, L)`` f32 step sizes on the host."""
    host = seg_dts.cpu().numpy() if seg_dts_host is None else seg_dts_host
    return np.ascontiguousarray(host, dtype=np.float32).reshape(
        seg_dts.shape[0], -1
    )


def ip_sesolve(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    seg_dts: torch.Tensor,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    diag2d: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    n_row: int,
    n_col: int,
    seg_len: int,
    seg_dts_host: np.ndarray | None = None,
) -> torch.Tensor:
    """Fused interaction-picture RK4 sesolve (d=2, one basis, f32).

    Inputs and output follow the JAX package's ``_ip_sesolve_jit``.

    Args:
        a_re/a_im: ``(n_seg, L, 3, n)`` drive coefficient stages.
        cum_mod: ``(n_seg, L, 3, n)`` range-reduced ``−∫det`` stages.
        t_stage: ``(n_seg, L, 3)`` stage times (relative to the grid
            start).
        seg_dts: ``(n_seg, L, 1)`` step sizes (0 = padding).
        eval_t: ``(n_seg, 1, 1)`` evaluation times.
        eval_cum_mod: ``(n_seg, 1, n)`` range-reduced ``−∫det`` at the
            evaluation times.
        diag2d: ``(1, R, C)`` or ``(R, C)`` static interaction diagonal.
        psi0_re/psi0_im: ``(R, C)`` initial state.
        n_row/n_col: Qubits on the row/column axis (``R = 2^n_row``).
        seg_len: Steps per segment (``L``).
        seg_dts_host: Host copy of ``seg_dts``. The kernel's host loop
            reads the step sizes from it; without it they are copied
            back from the device once.

    Returns:
        ``(n_seg, 2, R, C)`` float32 lab-frame states after each
        segment (real and imaginary planes).
    """
    if a_re.device.type == "cpu":
        return ip_sesolve_reference(
            a_re, a_im, cum_mod, t_stage, seg_dts, eval_t, eval_cum_mod,
            diag2d, psi0_re, psi0_im,
            n_row=n_row, n_col=n_col, seg_len=seg_len,
            seg_dts_host=seg_dts_host,
        )
    if a_re.device.type != "cuda":
        raise ValueError(f"Unsupported device {a_re.device}.")
    n = n_row + n_col
    n_seg = a_re.shape[0]
    rows, cols = 1 << n_row, 1 << n_col
    if diag2d.ndim == 2:
        diag2d = diag2d[None]
    stage = (n_seg, seg_len, 3, n)
    _check_inputs(
        dict(
            a_re=a_re, a_im=a_im, cum_mod=cum_mod, t_stage=t_stage,
            seg_dts=seg_dts, eval_t=eval_t, eval_cum_mod=eval_cum_mod,
            diag2d=diag2d, psi0_re=psi0_re, psi0_im=psi0_im,
        ),
        dict(
            a_re=stage, a_im=stage, cum_mod=stage,
            t_stage=(n_seg, seg_len, 3), seg_dts=(n_seg, seg_len, 1),
            eval_t=(n_seg, 1, 1), eval_cum_mod=(n_seg, 1, n),
            diag2d=(1, rows, cols), psi0_re=(rows, cols),
            psi0_im=(rows, cols),
        ),
    )
    h_host = _host_steps(seg_dts, seg_dts_host)
    lib = _load()
    dim = rows * cols
    dev = a_re.device
    out = torch.empty((n_seg, 2, rows, cols), dtype=torch.float32, device=dev)
    # Scratch as interleaved (re, im) float2: double-buffered state and
    # stage input, and the RK4 accumulator
    phi = torch.empty((2, dim, 2), dtype=torch.float32, device=dev)
    k = torch.empty((2, dim, 2), dtype=torch.float32, device=dev)
    acc = torch.empty((dim, 2), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ip_sesolve_run(
        a_re.data_ptr(), a_im.data_ptr(), cum_mod.data_ptr(),
        t_stage.data_ptr(), eval_t.data_ptr(), eval_cum_mod.data_ptr(),
        diag2d.data_ptr(), psi0_re.data_ptr(), psi0_im.data_ptr(),
        out.data_ptr(), phi.data_ptr(), k.data_ptr(), acc.data_ptr(),
        h_host.ctypes.data, n_seg, seg_len, n, stream,
    )
    global IP_SESOLVE_LAUNCHES
    IP_SESOLVE_LAUNCHES += 1
    if err != 0:
        raise RuntimeError(f"ip_sesolve_run failed: CUDA error {err}.")
    return out


def ip_sesolve_reference(
    a_re: torch.Tensor,
    a_im: torch.Tensor,
    cum_mod: torch.Tensor,
    t_stage: torch.Tensor,
    seg_dts: torch.Tensor,
    eval_t: torch.Tensor,
    eval_cum_mod: torch.Tensor,
    diag2d: torch.Tensor,
    psi0_re: torch.Tensor,
    psi0_im: torch.Tensor,
    *,
    n_row: int,
    n_col: int,
    seg_len: int,
    seg_dts_host: np.ndarray | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`ip_sesolve` (same arguments).

    Runs on the inputs' device in complex64. Each RK4 stage gathers the
    ``n`` single-flip partners of every amplitude at once.
    """
    n = n_row + n_col
    dim = 1 << n
    n_seg = a_re.shape[0]
    dev = a_re.device
    a = torch.complex(a_re, a_im).reshape(n_seg, seg_len * 3, n)
    cum = cum_mod.reshape(n_seg, seg_len * 3, n)
    t_st = t_stage.reshape(n_seg, seg_len * 3)
    h_host = _host_steps(seg_dts, seg_dts_host)
    diag = diag2d.reshape(-1)
    idx = torch.arange(dim, device=dev)
    shifts = torch.arange(n - 1, -1, -1, device=dev)  # qubit q: bit n-1-q
    bits = (idx[None, :] >> shifts[:, None]) & 1  # (n, dim)
    partners = idx[None, :] ^ (1 << shifts)[:, None]  # (n, dim)
    bits_f = bits.to(torch.float32)
    # +a_im where the output index has the qubit's bit set, -a_im else
    im_sign = 2.0 * bits_f - 1.0

    def rotor(t: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """``e^{-iΦ}`` with Φ = (diag·t mod 2π) + Σc − Σ_q c_q bit_q."""
        ph = torch.remainder(diag * t, 2 * math.pi) + c.sum()
        ph = ph - c @ bits_f
        return torch.complex(torch.cos(ph), -torch.sin(ph))

    phi = torch.complex(psi0_re, psi0_im).reshape(dim)
    out = torch.empty((n_seg, 2, dim), dtype=torch.float32, device=dev)
    for s in range(n_seg):
        for i in range(seg_len):
            h = float(h_host[s, i])
            if h == 0.0:
                continue
            k = torch.zeros_like(phi)
            acc = torch.zeros_like(phi)
            for j in range(4):
                sidx = (j + 1) >> 1
                row = i * 3 + sidx
                rot = rotor(t_st[s, row], cum[s, row])
                w = rot * (phi + (h * 0.5 * sidx) * k)
                coef = a[s, row].real[:, None] + 1j * (
                    a[s, row].imag[:, None] * im_sign
                )
                y = (coef * w[partners]).sum(0)
                k = -1j * (rot.conj() * y)
                acc = acc + (1 / 3 if j in (1, 2) else 1 / 6) * k
            phi = phi + h * acc
        lab = rotor(eval_t.reshape(-1)[s], eval_cum_mod.reshape(n_seg, n)[s])
        lab = lab * phi
        out[s, 0] = lab.real
        out[s, 1] = lab.imag
    return out.reshape(n_seg, 2, 1 << n_row, 1 << n_col)

