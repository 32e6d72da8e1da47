"""Batched small-block dense linear algebra.

Gauss-Jordan elimination with partial pivoting on batches of (f x f)
field-coupling blocks (f <= ~16).  The algorithm and its guards are the
reference's (``gmpnp_tpu/solve/smallblock.py``): the pivot is the first
maximum of the column, pivots are floored at RANGE_FLOOR and every
factorization magnitude is clamped to +-RANGE_LIM.  The reference's one-hot
permutation multiply becomes a direct indexed row swap, which moves the same
values.  Keeping the algorithm (rather than ``torch.linalg.inv``) keeps the
block-row equilibration of the slab solver digit-for-digit with the
reference.
"""

from __future__ import annotations

import torch

# Exponent-range guard, kept at the reference's values for parity: both
# bounds sit ~1e6+ beyond any legitimate quantity in this framework's scaled
# systems, so healthy solves are numerically unchanged; where a clamp does
# engage, Newton certifies the direction on the true f64 residual.
RANGE_LIM = 1.0e16
RANGE_FLOOR = 1.0e-16


def range_clamp(x: torch.Tensor, lim: float = RANGE_LIM) -> torch.Tensor:
    """Clamp magnitudes into [-lim, lim]."""
    return torch.clamp(x, -lim, lim)


def _floor_pivot(pivval: torch.Tensor) -> torch.Tensor:
    """Push a ~zero pivot to +-RANGE_FLOOR, keeping its sign (sign(0)
    counts as +)."""
    floored = torch.where(pivval < 0, -RANGE_FLOOR, RANGE_FLOOR).to(
        pivval.dtype)
    return torch.where(pivval.abs() < RANGE_FLOOR, floored, pivval)


def block_inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., f, f) via Gauss-Jordan with partial
    pivoting.  f is small (<= ~16)."""
    f = A.shape[-1]
    batch = A.shape[:-2]
    eye = torch.eye(f, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([range_clamp(A), eye], dim=-1).reshape(-1, f, 2 * f)
    b = torch.arange(aug.shape[0], device=A.device)

    for k in range(f):
        # partial pivot: first largest |entry| in column k among rows >= k
        p = k + torch.argmax(aug[:, k:, k].abs(), dim=1)
        row_k = aug[b, k]
        row_p = aug[b, p]
        aug = aug.clone()
        aug[b, p] = row_k
        aug[b, k] = row_p
        # normalize pivot row, eliminate everywhere else (floored pivot,
        # clamped row and update — the reference's range guard)
        pivval = _floor_pivot(aug[:, k, k])[:, None, None]
        rowk = range_clamp(aug[:, k:k + 1, :] / pivval)
        factors = aug[:, :, k:k + 1]
        aug = range_clamp(aug - factors * rowk)
        # restore the (zeroed) pivot row as the normalized row
        aug[:, k, :] = rowk[:, 0, :]

    return aug[:, :, f:].reshape(*batch, f, f)


def block_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve A x = b for (..., f, f) blocks; b: (..., f) or
    (..., f, k).  Uses the explicit Gauss-Jordan inverse."""
    Ainv = block_inv(A)
    if b.dim() == A.dim() - 1:
        return torch.einsum("...ij,...j->...i", Ainv, b)
    return Ainv @ b


def triangular_solve_upper(R, g):
    """Back-substitution for a single upper-triangular system (m, m).

    Takes torch tensors or numpy arrays (GMRES solves its small Hessenberg
    system on the host) and returns the same kind."""
    m = R.shape[-1]
    x = g * 0
    for i in range(m - 1, -1, -1):
        resid = g[i] - R[i, :] @ x
        x[i] = resid / R[i, i]
    return x
