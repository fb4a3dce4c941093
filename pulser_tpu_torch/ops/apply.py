"""Application of structured neutral-atom Hamiltonians, in PyTorch.

Port of ``pulser_tpu/ops/apply.py`` (ket side only) with native complex
tensors in place of the ``(2, d^N)`` real pairs the TPU needed:

- every drive/detuning term is **1-local** → per-qudit ``d×d``
  time-dependent matrices, kron-summed per qudit group and applied as
  one matmul per group;
- the Ising interaction is **diagonal** in the computational basis →
  one precomputed length-``d^N`` diagonal vector.

Single-axis application (:func:`apply_axis_c`, the quantum-jump
candidates) and :func:`neg_i` serve the lab-frame quantum-jump solve;
:func:`apply_row_c` and :func:`apply_col_c` apply a one-qudit operator
to the row and column multi-index of a density matrix (the master
equation). The XY flip-flop term is not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def apply_axis_c(
    op: torch.Tensor, psi: torch.Tensor, axis: int, d: int, n: int
) -> torch.Tensor:
    """Applies a complex ``d×d`` operator to one qudit axis.

    Args:
        op: The ``(d, d)`` complex operator.
        psi: ``(..., d**n)`` complex states (any leading batch axes).
        axis: The qudit the operator acts on (qudit 0 is the most
            significant digit of the flat index).
        d, n: The qudit dimension and count.
    """
    lead = psi.shape[:-1]
    v = psi.reshape(*lead, d**axis, d, d ** (n - axis - 1))
    return torch.einsum("ij,...ajb->...aib", op, v).reshape(*lead, d**n)


def neg_i(psi: torch.Tensor) -> torch.Tensor:
    """Multiplies a complex tensor by ``-i``: x + iy -> y − ix."""
    return torch.complex(psi.imag, -psi.real)


def build_drive_matrices(
    amp: torch.Tensor,
    det: torch.Tensor,
    pairs: Sequence[tuple[int, int, int]],
    d: int,
    n: int,
) -> torch.Tensor:
    """Builds the per-qudit drive matrices at one time.

    The Hamiltonian term per basis ``b`` and qudit ``q`` is
    ``a σ_ij + a* σ_ji − δ σ_kk`` with ``a = 0.5 Ω e^{-iφ}`` (this
    already includes the reference's ``H + H†`` doubling).

    Args:
        amp: ``(..., n_bases, n)`` complex drive coefficients (any
            leading batch axes).
        det: ``(..., n_bases, n)`` real detuning coefficients.
        pairs: Per basis, the static ``(i, j, k)`` index triple.
        d: The qudit dimension.
        n: The number of qudits.

    Returns:
        The ``(..., n, d, d)`` complex matrices.
    """
    mats = torch.zeros(
        amp.shape[:-2] + (n, d, d), dtype=amp.dtype, device=amp.device
    )
    for b, (i, j, k) in enumerate(pairs):
        mats[..., i, j] += amp[..., b, :]
        mats[..., j, i] += amp[..., b, :].conj()
        mats[..., k, k] -= det[..., b, :]
    return mats


def group_sizes(d: int, n: int, target: int = 256) -> tuple[int, ...]:
    """Partitions ``n`` qudits into contiguous groups of dim ~``target``.

    The drive term ``Σ_q M_q^{(q)}`` is applied per *group* of qudits:
    the group's kron-summed matrix (``d^g × d^g``) is built once and
    applied as a single matmul.

    Args:
        d: The qudit dimension.
        n: The number of qudits.
        target: The desired group dimension (``d**g ≈ target``).
    """
    g = max(1, round(math.log(target) / math.log(d)))
    n_groups = max(1, math.ceil(n / g))
    # Balance the group sizes (e.g. 10 qubits -> (5, 5), not (8, 2))
    base = n // n_groups
    rem = n % n_groups
    return tuple(
        base + (1 if i < rem else 0) for i in range(n_groups)
    )


def _group_matrix(
    mats: torch.Tensor, lo: int, hi: int, d: int
) -> torch.Tensor:
    """Kron-sum ``Σ_{q∈[lo,hi)} I ⊗ M_q ⊗ I`` over a qudit group.

    Built as a balanced tree so the dominant cost is a handful of
    materializations at the final group dimension.

    Args:
        mats: ``(..., n, d, d)`` per-qudit drive matrices (any leading
            batch axes).
        lo, hi: The group's qudit range.
        d: The qudit dimension.

    Returns:
        The group's ``(..., d**(hi-lo), d**(hi-lo))`` matrix.
    """
    if hi - lo == 1:
        return mats[..., lo, :, :]
    mid = (lo + hi) // 2
    a = _group_matrix(mats, lo, mid, d)
    b = _group_matrix(mats, mid, hi, d)
    p, q = a.shape[-1], b.shape[-1]
    eye_a = torch.eye(p, dtype=mats.dtype, device=mats.device)
    eye_b = torch.eye(q, dtype=mats.dtype, device=mats.device)
    # a ⊗ I + I ⊗ b, as broadcasts so that batch axes ride along
    out = (
        a[..., :, None, :, None] * eye_b[:, None, :]
        + eye_a[:, None, :, None] * b[..., None, :, None, :]
    )
    return out.reshape(a.shape[:-2] + (p * q, p * q))


def apply_block_c(
    op: torch.Tensor,
    psi: torch.Tensor,
    left: int,
    block: int,
    right: int,
) -> torch.Tensor:
    """Applies a ``block×block`` operator to the middle reshape axis.

    Args:
        op: The ``(..., block, block)`` complex operator.
        psi: ``(..., left*block*right)`` complex state (the same leading
            batch axes as ``op``, or none).
        left/block/right: The reshape factorization.
    """
    lead = psi.shape[:-1]
    out = torch.matmul(
        op.unsqueeze(-3), psi.reshape(lead + (left, block, right))
    )
    return out.reshape(out.shape[:-3] + (-1,))


def _hpsi(
    psi: torch.Tensor,
    diag: torch.Tensor,
    amp: torch.Tensor,
    det: torch.Tensor,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    groups: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """``H(t) @ psi`` for the 1-local drive plus the static diagonal.

    Args:
        psi: ``(d**n,)`` complex state.
        diag: ``(d**n,)`` real diagonal (interaction).
        amp/det: ``(n_bases, n)`` coefficient slices.
        pairs, d, n: Static structure.
        groups: Optional qudit-group sizes (defaults to
            :func:`group_sizes`) for the blocked drive application.
    """
    out = diag.to(psi.dtype) * psi
    mats = build_drive_matrices(amp, det, pairs, d, n)
    if groups is None:
        groups = group_sizes(d, n)
    q0 = 0
    for g in groups:
        out = out + apply_block_c(
            _group_matrix(mats, q0, q0 + g, d),
            psi,
            d**q0,
            d**g,
            d ** (n - q0 - g),
        )
        q0 += g
    return out


def hamiltonian_matvec(
    psi: torch.Tensor,
    diag: torch.Tensor,
    amp: torch.Tensor,
    det: torch.Tensor,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
) -> torch.Tensor:
    """One full ``H(t) @ psi`` (exposed for tests)."""
    return _hpsi(psi, diag, amp, det, pairs, d, n)


def apply_row_c(
    op: torch.Tensor, rho: torch.Tensor, q: int, d: int, n: int
) -> torch.Tensor:
    """``(op at qudit q) @ rho`` on the row multi-index.

    Args:
        op: The ``(d, d)`` complex operator.
        rho: ``(..., d**n, d**n)`` complex density matrices (any leading
            batch axes).
        q, d, n: Axis and structure.
    """
    lead, dim = rho.shape[:-2], d**n
    v = rho.reshape(*lead, d**q, d, d ** (n - q - 1) * dim)
    return torch.matmul(op, v).reshape(rho.shape)


def apply_col_c(
    op: torch.Tensor, rho: torch.Tensor, q: int, d: int, n: int
) -> torch.Tensor:
    """``rho @ (op at qudit q)`` on the column multi-index.

    Contracts ``out[..b..] = Σ_a rho[..a..] op[a, b]`` directly on a
    ``(dim, left, d, right)`` view of each density matrix.
    """
    lead, dim = rho.shape[:-2], d**n
    v = rho.reshape(*lead, dim * d**q, d, d ** (n - q - 1))
    return torch.matmul(op.transpose(-1, -2), v).reshape(rho.shape)
