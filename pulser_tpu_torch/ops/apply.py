"""Application of structured neutral-atom Hamiltonians, in PyTorch.

Port of ``pulser_tpu/ops/apply.py`` (ket side only) with native complex
tensors in place of the ``(2, d^N)`` real pairs the TPU needed:

- every drive/detuning term is **1-local** → per-qudit ``d×d``
  time-dependent matrices, kron-summed per qudit group and applied as
  one matmul per group;
- the Ising interaction is **diagonal** in the computational basis →
  one precomputed length-``d^N`` diagonal vector.

Single-axis application (:func:`apply_axis_c`) and :func:`neg_i` serve
the lab-frame quantum-jump solve, :func:`jump_candidates` its jump
branch; :func:`apply_row_c` and :func:`apply_col_c` apply a one-qudit
operator to the row and column multi-index of a density matrix (the
master equation). The XY flip-flop term (:func:`apply_flip_flop_r`) is
two index gathers around one coupling matmul, on a state or on the row
index of a density matrix.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

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


_GATHER_TABLES: dict = {}


def _digit_swap(
    d: int, n: int, src: int, dst: int, device: Any
) -> torch.Tensor:
    """``(n * d**n,)`` int64 gather indices: entry ``q * dim + i`` is ``i``
    with its qudit-``q`` digit set to ``src`` where that digit is ``dst``,
    else ``dim`` (the zero slot appended to the gathered axis)."""
    dim = d**n
    idx = torch.arange(dim, device=device)
    place = d ** torch.arange(n - 1, -1, -1, device=device)[:, None]
    digit = _digits_of(d, n, device)
    moved = idx + (src - digit) * place
    return torch.where(digit == dst, moved, dim).reshape(-1)


def _flip_flop_tables(
    d: int, n: int, up_idx: int, down_idx: int, device: Any
) -> tuple[torch.Tensor, torch.Tensor]:
    """The lowering and raising gathers of :func:`apply_flip_flop_r`,
    cached per structure and device: lowering qudit ``q`` reads the
    ``u`` partner of each ``d`` entry, raising reads the ``d`` partner of
    each ``u`` entry in block ``q`` of the mixed stack."""
    key = (d, n, up_idx, down_idx, str(device))
    hit = _GATHER_TABLES.get(key)
    if hit is None:
        dim = d**n
        lower = _digit_swap(d, n, up_idx, down_idx, device)
        raise_ = _digit_swap(d, n, down_idx, up_idx, device)
        block = torch.arange(n, device=device).repeat_interleave(dim) * dim
        # The zero slot of the stacked (n * dim) axis is n * dim
        raise_ = torch.where(raise_ == dim, n * dim, raise_ + block)
        hit = _GATHER_TABLES[key] = (lower, raise_)
    return hit


def apply_flip_flop_r(
    u_mat: torch.Tensor,
    x: torch.Tensor,
    d: int,
    n: int,
    up_idx: int,
    down_idx: int,
    rows: bool = False,
) -> torch.Tensor:
    """Applies the XY flip-flop term ``Σ_{i≠j} U_ij σ_ud^i σ_du^j``.

    Every qudit is lowered at once (one gather from the state with a zero
    slot appended), the stack is mixed with the couplings (one matmul),
    and every qudit is raised and summed (one gather and one sum).

    Args:
        u_mat: ``(..., n, n)`` couplings with a zero diagonal (any leading
            batch axes of ``x``, or none). Real couplings are cast to
            ``x``'s dtype; a complex ``U`` (``−iU``, say) is taken as is.
        x: ``(..., d**n)`` states, or with ``rows`` ``(..., d**n, m)``
            (the operator acts on the row index of a density matrix).
        d, n: Qudit dimension and count.
        up_idx / down_idx: Eigenbasis indices of "u" and "d".
        rows: Apply to axis -2 instead of the last axis.
    """
    if not rows:
        return apply_flip_flop_r(
            u_mat, x[..., None], d, n, up_idx, down_idx, rows=True
        )[..., 0]
    lower, raise_ = _flip_flop_tables(d, n, up_idx, down_idx, x.device)
    dim, m = d**n, x.shape[-1]
    lead = x.shape[:-2]

    def padded(v: torch.Tensor) -> torch.Tensor:
        return torch.cat([v, torch.zeros_like(v[..., :1, :])], dim=-2)

    low = padded(x).index_select(-2, lower).reshape(*lead, n, dim * m)
    mixed = torch.matmul(u_mat.to(x.dtype), low).reshape(*lead, n * dim, m)
    out = padded(mixed).index_select(-2, raise_)
    return out.reshape(*lead, n, dim, m).sum(-3)


def candidate_coefs(ops: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """The ``(K, n, d, d**n)`` coefficients of :func:`jump_candidates`:
    ``coef[k, q, j, i] = L_k[digit_q(i), j]`` for ``(K, d, d)`` operators
    ``L``."""
    return ops[:, _digits_of(d, n, ops.device)].permute(0, 1, 3, 2)


def _digits_of(d: int, n: int, device: Any) -> torch.Tensor:
    """``(n, d**n)`` int64: the base-``d`` digits of every basis index,
    qudit 0 the most significant."""
    idx = torch.arange(d**n, device=device)
    place = d ** torch.arange(n - 1, -1, -1, device=device)
    return (idx[None, :] // place[:, None]) % d


def jump_candidates(
    coef: torch.Tensor, psi: torch.Tensor, d: int, n: int
) -> torch.Tensor:
    """Every local operator on every qudit applied to ``psi``.

    Args:
        coef: The operators' :func:`candidate_coefs`, ``(K, n, d, d**n)``.
        psi: ``(..., d**n)`` complex states.
        d, n: Qudit dimension and count.

    Returns:
        ``(..., K * n, d**n)``: entry ``k * n + q`` is operator ``k`` on
        qudit ``q`` (the JAX package's candidate order), from one gather of
        ``psi`` (the digit-``q`` partners of every entry) and one
        contraction.
    """
    key = ("partners", d, n, str(psi.device))
    flat = _GATHER_TABLES.get(key)
    dim = d**n
    if flat is None:
        # flat[q, j, i]: i with its qudit-q digit set to j
        idx = torch.arange(dim, device=psi.device)
        place = d ** torch.arange(n - 1, -1, -1, device=psi.device)
        digit = _digits_of(d, n, psi.device)
        j = torch.arange(d, device=psi.device)[None, :, None]
        part = idx + (j - digit[:, None, :]) * place[:, None, None]
        flat = _GATHER_TABLES[key] = part.reshape(-1)
    gathered = psi[..., flat].reshape(*psi.shape[:-1], 1, n, d, dim)
    out = (coef * gathered).sum(-2)
    return out.reshape(*psi.shape[:-1], coef.shape[0] * n, dim)


def _hpsi(
    psi: torch.Tensor,
    diag: torch.Tensor,
    amp: torch.Tensor,
    det: torch.Tensor,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    xy_mat: torch.Tensor | None = None,
    xy_indices: tuple[int, int] | None = None,
    groups: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """``H(t) @ psi``: the 1-local drive, the diagonal and the XY term.

    Args:
        psi: ``(d**n,)`` complex state.
        diag: ``(d**n,)`` real diagonal (interaction).
        amp/det: ``(n_bases, n)`` coefficient slices.
        pairs, d, n: Static structure.
        xy_mat: Optional ``(n, n)`` real XY couplings.
        xy_indices: ``(up_idx, down_idx)`` of the flip-flop term.
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
    if xy_mat is not None:
        assert xy_indices is not None
        out = out + apply_flip_flop_r(xy_mat, psi, d, n, *xy_indices)
    return out


def hamiltonian_matvec(
    psi: torch.Tensor,
    diag: torch.Tensor,
    amp: torch.Tensor,
    det: torch.Tensor,
    pairs: tuple[tuple[int, int, int], ...],
    d: int,
    n: int,
    xy_mat: torch.Tensor | None = None,
    xy_indices: tuple[int, int] | None = None,
) -> torch.Tensor:
    """One full ``H(t) @ psi`` (exposed for tests)."""
    return _hpsi(psi, diag, amp, det, pairs, d, n, xy_mat, xy_indices)


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
