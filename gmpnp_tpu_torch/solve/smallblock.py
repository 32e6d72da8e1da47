"""Batched small-block dense linear algebra.

Gauss-Jordan elimination with partial pivoting on batches of (f x f)
field-coupling blocks (f <= 16).  The algorithm and its guards are the
reference's (``gmpnp_tpu/solve/smallblock.py``): the pivot is the first
maximum of the column, pivots are floored at RANGE_FLOOR and every
factorization magnitude is clamped to +-RANGE_LIM.  Keeping the algorithm
(rather than ``torch.linalg.inv``) keeps the block-row equilibration of the
slab solver digit-for-digit with the reference.  ``block_inv`` is the
hand-written kernel of ``ops.block_inv`` on CUDA tensors (one launch per
call) and its plain version on CPU tensors.

Also the helpers the solvers share for an optional leading lane axis:
``block_mv``, ``eye_row`` and ``lane_by_lane``.
"""

from __future__ import annotations

import torch

from gmpnp_tpu_torch.ops.block_inv import (  # noqa: F401
    RANGE_LIM, range_clamp)
from gmpnp_tpu_torch.ops.block_inv import block_inv as _block_inv


def block_inv(A: torch.Tensor) -> torch.Tensor:
    """Batched inverse of (..., f, f) via Gauss-Jordan with partial
    pivoting, 1 <= f <= 16 (``ops.block_inv``; a strided A is copied
    contiguous first)."""
    return _block_inv(A.contiguous())


def block_mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched (..., f, f) @ (..., f)."""
    return torch.einsum("...ij,...j->...i", A, x)


def eye_row(f: int, lead: tuple, like: torch.Tensor) -> torch.Tensor:
    """An identity block (1, f, f), or one per lane (*lead, 1, f, f), in
    ``like``'s dtype and device: views of one eye."""
    eye = torch.eye(f, dtype=like.dtype, device=like.device)
    return eye.expand(*lead, 1, f, f) if lead else eye[None]


def lane_by_lane(fn, lanes: bool, *xs):
    """``fn(*xs)``; or, where ``lanes`` is true, ``fn`` of each lane's slices
    of ``xs`` (tensors with a leading lane axis, or sequences of per-lane
    values), lane after lane: tensor results stacked on a new lane axis,
    any other result as a tuple of the lanes'.

    For the lane forms of the solvers, where one batched call over the
    lanes would round otherwise, on the card too, than the single-lane
    call does for each lane alone: each lane then keeps its single-lane
    bits."""
    if not lanes:
        return fn(*xs)
    out = [fn(*x) for x in zip(*xs)]
    return torch.stack(out) if isinstance(out[0], torch.Tensor) else tuple(out)


def block_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched solve A x = b for (..., f, f) blocks; b: (..., f) or
    (..., f, k).  Uses the explicit Gauss-Jordan inverse."""
    Ainv = block_inv(A)
    if b.dim() == A.dim() - 1:
        return block_mv(Ainv, b)
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
