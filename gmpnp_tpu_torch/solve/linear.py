"""Linear solvers over block structures.

- 1D coupled P1 systems are block-tridiagonal (f x f blocks): solved
  exactly by block cyclic reduction (log2 N batched levels) or by a
  sequential block-Thomas loop (the oracle), and by ``tridiag_mp_solve``
  (an f32 CR factorization preconditioning f64 GMRES).
- Restarted GMRES (CGS2 Arnoldi, Givens residual tracking) is the Krylov
  iteration of the z-slab direct solver (solve.slab), of
  ``tridiag_mp_solve`` and of the ``kind='gmres'`` fallback; BiCGStab is
  the ``kind='bicgstab'`` fallback.  Their matvec is the block-ELL kernel
  on CUDA tensors.
- Preconditioners for the Krylov kinds: block-Jacobi, multicolor block
  SSOR (colors from ``greedy_vertex_coloring``) and aggregation AMG
  (solve.amg).
- ``dense_solve`` for tests and small systems.

Spans (``utils.profiling``): factorizations and preconditioner builds run
in ``linear.factor``, the direct solves and applies in ``linear.solve``,
GMRES and BiCGStab in ``linear.krylov``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL
from gmpnp_tpu_torch.solve.smallblock import (
    block_inv, block_solve, range_clamp, triangular_solve_upper)
from gmpnp_tpu_torch.sync import to_host
from gmpnp_tpu_torch.utils.profiling import span


# ---------------------------------------------------------------------------
# Block tridiagonal (1D direct)
# ---------------------------------------------------------------------------

def block_tridiag_from_ell(ell: BlockELL):
    """(lower, diag, upper) block bands, each (N, f, f), of a BlockELL
    matrix whose mesh vertices are sorted along the line (adjacency
    {n-1, n, n+1}); lower[0] and upper[N-1] are zero."""
    N, K, f, _ = ell.shape4
    assert K <= 3, "not a tridiagonal pattern"
    dev = ell.flat.device
    cols = torch.arange(f, device=dev)

    def slot_block(slot):
        # block `slot[n]` of the flat (N, f, K*f) layout
        idx = slot[:, None, None] * f + cols[None, None, :]
        return torch.gather(ell.flat, 2, idx.expand(N, f, f))

    rows = torch.arange(N, device=dev)
    zero = torch.zeros((), dtype=ell.flat.dtype, device=dev)
    diag = slot_block(ell.diag_slot)
    lower = slot_block(torch.clamp(ell.diag_slot - 1, 0, K - 1))
    upper = slot_block(torch.clamp(ell.diag_slot + 1, 0, K - 1))
    lower = torch.where((rows > 0)[:, None, None], lower, zero)
    upper = torch.where((rows < N - 1)[:, None, None], upper, zero)
    return lower, diag, upper


def _mv(A, x):
    """Batched (n, f, f) @ (n, f)."""
    return torch.einsum("nij,nj->ni", A, x)


@span("linear.solve")
def block_tridiag_solve_thomas(lower, diag, upper, rhs):
    """Sequential block-Thomas algorithm (exact; the oracle path): the
    reference's forward and reverse ``lax.scan`` as Python loops.

    lower/diag/upper: (N, f, f); rhs: (N, f).  Returns x: (N, f)."""
    N, f, _ = diag.shape
    Cp = torch.zeros((f, f), dtype=diag.dtype, device=diag.device)
    dp = torch.zeros((f,), dtype=diag.dtype, device=diag.device)
    Cps, dps = [], []
    for A, B, C, d in zip(lower, diag, upper, rhs):
        dinv = block_inv(B - A @ Cp)
        Cp, dp = dinv @ C, dinv @ (d - A @ dp)
        Cps.append(Cp)
        dps.append(dp)
    x = torch.zeros((f,), dtype=diag.dtype, device=diag.device)
    xs = [None] * N
    for n in range(N - 1, -1, -1):
        x = dps[n] - Cps[n] @ x
        xs[n] = x
    return torch.stack(xs)


def _pow2(N: int) -> int:
    M = 1
    while M < N:
        M *= 2
    return M


def _identity_pad(A, B, C, n_pad):
    """Append n_pad identity rows (zero off-diagonal blocks)."""
    if n_pad == 0:
        return A, B, C
    f = B.shape[-1]
    eye = torch.eye(f, dtype=B.dtype, device=B.device).expand(n_pad, f, f)
    zed = torch.zeros((n_pad, f, f), dtype=B.dtype, device=B.device)
    return (torch.cat([A, zed]), torch.cat([B, eye]), torch.cat([C, zed]))


@span("linear.solve")
def block_tridiag_solve_cr(lower, diag, upper, rhs):
    """Block cyclic reduction: exact direct solve in log2(N) batched
    levels.  Every level product is range-clamped (the reference's guard,
    kept for parity: near-singular odd blocks during a Newton excursion
    otherwise cascade magnitudes across levels)."""
    dtype, dev = diag.dtype, diag.device
    N, f, _ = diag.shape
    M = _pow2(N)
    A, B, C = _identity_pad(lower, diag, upper, M - N)
    D = torch.cat([rhs, torch.zeros((M - N, f), dtype=dtype, device=dev)])

    eye1 = torch.eye(f, dtype=dtype, device=dev)[None]
    zed1 = torch.zeros((1, f, f), dtype=dtype, device=dev)
    zv1 = torch.zeros((1, f), dtype=dtype, device=dev)
    stack = []
    while A.shape[0] > 1:
        m = A.shape[0]
        # ghost rows (identity) at both ends for the odd-neighbor accesses
        Ap = torch.cat([zed1, A, zed1])
        Bp = torch.cat([eye1, B, eye1])
        Cp = torch.cat([zed1, C, zed1])
        Dp = torch.cat([zv1, D, zv1])
        # even rows 1, 3, .., m-1 in padded indexing; their left odd
        # neighbors 0, 2, .., m-2 and right ones 2, 4, .., m
        ev, lo, hi = slice(1, m, 2), slice(0, m - 1, 2), slice(2, m + 1, 2)
        alpha = range_clamp(Ap[ev] @ block_inv(Bp[lo]))
        gamma = range_clamp(Cp[ev] @ block_inv(Bp[hi]))

        A_new = range_clamp(-alpha @ Ap[lo])
        B_new = range_clamp(Bp[ev] - alpha @ Cp[lo] - gamma @ Ap[hi])
        C_new = range_clamp(-gamma @ Cp[hi])
        D_new = range_clamp(Dp[ev] - _mv(alpha, Dp[lo]) - _mv(gamma, Dp[hi]))

        stack.append((A, B, C, D))
        A, B, C, D = A_new, B_new, C_new, D_new

    x = block_solve(B, D)                           # (1, f)

    # back substitution: interleave odd solutions level by level
    for A_l, B_l, C_l, D_l in reversed(stack):
        m = A_l.shape[0]
        x_even = x                                   # (m/2, f)
        # odd row 2j+1 sits between even x_j and x_{j+1}
        x_right = torch.cat([x_even[1:], zv1])
        rhs_od = range_clamp(D_l[1::2] - _mv(A_l[1::2], x_even)
                             - _mv(C_l[1::2], x_right))
        x_odd = range_clamp(block_solve(B_l[1::2], rhs_od))
        x = torch.stack([x_even, x_odd], dim=1).reshape(m, f)

    return x[:N]


class _CRLevel(NamedTuple):
    """Per-level factors of a block-cyclic-reduction factorization.

    h = m/2 rows at this level; alpha/gamma reduce the rhs downward,
    A_od/C_od/Binv_od back-substitute the odd rows upward.  Binv_od serves
    both the reduction and the back-substitution, so each odd block is
    inverted once."""
    alpha: torch.Tensor    # (h, f, f)  A_even @ inv(B_leftodd)
    gamma: torch.Tensor    # (h, f, f)  C_even @ inv(B_rightodd)
    A_od: torch.Tensor     # (h, f, f)  odd rows' lower band
    C_od: torch.Tensor     # (h, f, f)  odd rows' upper band
    Binv_od: torch.Tensor  # (h, f, f)  inverse of odd rows' diagonal


class CRFactors(NamedTuple):
    levels: Tuple[_CRLevel, ...]
    Binv_top: torch.Tensor   # (f, f) inverse of the final 1x1-block system


@span("linear.factor")
def block_tridiag_factor_cr(lower, diag, upper) -> CRFactors:
    """Factorization half of block cyclic reduction: everything that
    depends only on the matrix, so one factorization serves many
    right-hand sides (the carried 1D chord step; the f32 factorization of
    ``tridiag_mp_solve``)."""
    dtype, dev = diag.dtype, diag.device
    N, f, _ = diag.shape
    A, B, C = _identity_pad(lower, diag, upper, _pow2(N) - N)

    eye1 = torch.eye(f, dtype=dtype, device=dev)[None]
    zed1 = torch.zeros((1, f, f), dtype=dtype, device=dev)
    levels = []
    while A.shape[0] > 1:
        A_od, B_od, C_od = A[1::2], B[1::2], C[1::2]
        Binv_od = block_inv(B_od)
        # even row 2j's left odd neighbor is 2j-1 (ghost identity at j=0),
        # its right odd neighbor is 2j+1; level products range-clamped
        Binv_left = torch.cat([eye1, Binv_od[:-1]])
        alpha = range_clamp(A[0::2] @ Binv_left)
        gamma = range_clamp(C[0::2] @ Binv_od)
        levels.append(_CRLevel(alpha, gamma, A_od, C_od, Binv_od))
        A_left = torch.cat([zed1, A_od[:-1]])
        C_left = torch.cat([zed1, C_od[:-1]])
        A, B, C = (range_clamp(-alpha @ A_left),
                   range_clamp(B[0::2] - alpha @ C_left - gamma @ A_od),
                   range_clamp(-gamma @ C_od))
    return CRFactors(levels=tuple(levels), Binv_top=block_inv(B[0]))


@span("linear.solve")
def block_tridiag_apply_cr(factors: CRFactors, rhs: torch.Tensor):
    """Solve with a prepared CR factorization.  rhs: (N, f) in the
    factorization's dtype (padded rows solve to 0 exactly)."""
    N, f = rhs.shape
    M = 2 ** len(factors.levels)
    zv1 = torch.zeros((1, f), dtype=rhs.dtype, device=rhs.device)
    D = rhs
    if M > N:
        D = torch.cat([D, zv1.expand(M - N, f)])

    odd_rhs = []
    for lev in factors.levels:
        D_ev, D_od = D[0::2], D[1::2]
        odd_rhs.append(D_od)
        D_left = torch.cat([zv1, D_od[:-1]])
        D = range_clamp(D_ev - _mv(lev.alpha, D_left) - _mv(lev.gamma, D_od))

    x = (factors.Binv_top @ D[0])[None]               # (1, f)
    for lev, D_od in zip(reversed(factors.levels), reversed(odd_rhs)):
        x_right = torch.cat([x[1:], zv1])
        r_od = range_clamp(D_od - _mv(lev.A_od, x) - _mv(lev.C_od, x_right))
        x_odd = range_clamp(_mv(lev.Binv_od, r_od))
        x = torch.stack([x, x_odd], dim=1).reshape(2 * x.shape[0], f)
    return x[:N]


@span("linear.solve")
def tridiag_mp_solve(ell: BlockELL, rhs: torch.Tensor,
                     tol: float = 1.0e-8, max_refine: int = 40):
    """Mixed-precision 1D direct solve (``LinearConfig(kind='tridiag_cr',
    solve_dtype='f32')``): block-row equilibration in f64 (diagonal blocks
    to identity), one f32 CR factorization, then f64 CGS2-GMRES on the
    equilibrated system preconditioned by the f32 CR apply.  The GMRES
    matvec is ``BlockELL.matvec``: the block-ELL kernel in f64 on CUDA
    tensors.  Returns a KrylovResult in the rhs dtype."""
    Dinv0 = block_inv(ell.diag_blocks())
    ell_eq = ell.scale_rows(Dinv0)
    b = _mv(Dinv0, rhs)
    lo, di, up = block_tridiag_from_ell(ell_eq)
    fac = block_tridiag_factor_cr(lo.to(torch.float32),
                                  di.to(torch.float32),
                                  up.to(torch.float32))

    def solve32(r):
        return block_tridiag_apply_cr(fac, r.to(torch.float32)).to(rhs.dtype)

    return gmres(ell_eq.matvec, b, Minv=solve32, tol=tol,
                 restart=min(max_refine, 30), maxiter=max_refine)


# ---------------------------------------------------------------------------
# Block tridiagonal over sweep lanes: (V, N, f, f) bands, (V, N, f) vectors
# ---------------------------------------------------------------------------
#
# The lane versions of the CR factor / apply / solve: every level is one
# batched call over the V lanes and the level's rows, so V lanes take the
# launches of one.  Each lane computes what the single-lane function
# computes for it (the same operations, with a leading lane axis).

def _mvl(A, x):
    """Batched (V, n, f, f) @ (V, n, f)."""
    return torch.einsum("vnij,vnj->vni", A, x)


def block_tridiag_from_ell_lanes(ell: BlockELL):
    """``block_tridiag_from_ell`` of a lane-batched BlockELL: (lower, diag,
    upper), each (V, N, f, f)."""
    V, N, f, Kf = ell.flat.shape
    K = Kf // f
    assert K <= 3, "not a tridiagonal pattern"
    dev = ell.flat.device
    cols = torch.arange(f, device=dev)

    def slot_block(slot):
        idx = slot[:, None, None] * f + cols[None, None, :]
        return torch.gather(ell.flat, 3, idx.expand(V, N, f, f))

    rows = torch.arange(N, device=dev)
    zero = torch.zeros((), dtype=ell.flat.dtype, device=dev)
    diag = slot_block(ell.diag_slot)
    lower = slot_block(torch.clamp(ell.diag_slot - 1, 0, K - 1))
    upper = slot_block(torch.clamp(ell.diag_slot + 1, 0, K - 1))
    lower = torch.where((rows > 0)[:, None, None], lower, zero)
    upper = torch.where((rows < N - 1)[:, None, None], upper, zero)
    return lower, diag, upper


def _identity_pad_lanes(A, B, C, n_pad):
    if n_pad == 0:
        return A, B, C
    V, _, f, _ = B.shape
    eye = torch.eye(f, dtype=B.dtype, device=B.device).expand(V, n_pad, f, f)
    zed = torch.zeros((V, n_pad, f, f), dtype=B.dtype, device=B.device)
    return (torch.cat([A, zed], 1), torch.cat([B, eye], 1),
            torch.cat([C, zed], 1))


@span("linear.solve")
def block_tridiag_solve_thomas_lanes(lower, diag, upper, rhs):
    """``block_tridiag_solve_thomas`` over lanes: (V, N, f, f) bands, rhs
    (V, N, f) -> x (V, N, f); each row's steps one batched call over the
    lanes."""
    V, N, f, _ = diag.shape
    Cp = torch.zeros((V, f, f), dtype=diag.dtype, device=diag.device)
    dp = torch.zeros((V, f, 1), dtype=diag.dtype, device=diag.device)
    Cps, dps = [], []
    for n in range(N):
        A = lower[:, n]
        dinv = block_inv(diag[:, n] - A @ Cp)
        Cp, dp = dinv @ upper[:, n], dinv @ (rhs[:, n, :, None] - A @ dp)
        Cps.append(Cp)
        dps.append(dp)
    x = torch.zeros((V, f, 1), dtype=diag.dtype, device=diag.device)
    xs = [None] * N
    for n in range(N - 1, -1, -1):
        x = dps[n] - Cps[n] @ x
        xs[n] = x
    return torch.stack(xs, 1)[..., 0]


@span("linear.solve")
def block_tridiag_solve_cr_lanes(lower, diag, upper, rhs):
    """``block_tridiag_solve_cr`` over lanes: (V, N, f, f) bands, rhs
    (V, N, f) -> x (V, N, f)."""
    dtype, dev = diag.dtype, diag.device
    V, N, f, _ = diag.shape
    M = _pow2(N)
    A, B, C = _identity_pad_lanes(lower, diag, upper, M - N)
    D = torch.cat([rhs, torch.zeros((V, M - N, f), dtype=dtype, device=dev)],
                  1)

    eye1 = torch.eye(f, dtype=dtype, device=dev).expand(V, 1, f, f)
    zed1 = torch.zeros((V, 1, f, f), dtype=dtype, device=dev)
    zv1 = torch.zeros((V, 1, f), dtype=dtype, device=dev)
    stack = []
    while A.shape[1] > 1:
        m = A.shape[1]
        Ap = torch.cat([zed1, A, zed1], 1)
        Bp = torch.cat([eye1, B, eye1], 1)
        Cp = torch.cat([zed1, C, zed1], 1)
        Dp = torch.cat([zv1, D, zv1], 1)
        ev, lo, hi = slice(1, m, 2), slice(0, m - 1, 2), slice(2, m + 1, 2)
        alpha = range_clamp(Ap[:, ev] @ block_inv(Bp[:, lo]))
        gamma = range_clamp(Cp[:, ev] @ block_inv(Bp[:, hi]))

        A_new = range_clamp(-alpha @ Ap[:, lo])
        B_new = range_clamp(Bp[:, ev] - alpha @ Cp[:, lo]
                            - gamma @ Ap[:, hi])
        C_new = range_clamp(-gamma @ Cp[:, hi])
        D_new = range_clamp(Dp[:, ev] - _mvl(alpha, Dp[:, lo])
                            - _mvl(gamma, Dp[:, hi]))

        stack.append((A, B, C, D))
        A, B, C, D = A_new, B_new, C_new, D_new

    x = block_solve(B, D)                           # (V, 1, f)

    for A_l, B_l, C_l, D_l in reversed(stack):
        m = A_l.shape[1]
        x_even = x
        x_right = torch.cat([x_even[:, 1:], zv1], 1)
        rhs_od = range_clamp(D_l[:, 1::2] - _mvl(A_l[:, 1::2], x_even)
                             - _mvl(C_l[:, 1::2], x_right))
        x_odd = range_clamp(block_solve(B_l[:, 1::2], rhs_od))
        x = torch.stack([x_even, x_odd], dim=2).reshape(V, m, f)

    return x[:, :N]


@span("linear.factor")
def block_tridiag_factor_cr_lanes(lower, diag, upper) -> CRFactors:
    """``block_tridiag_factor_cr`` over lanes: every factor gains the lane
    axis ((V, h, f, f) per level, ``Binv_top`` (V, f, f))."""
    dtype, dev = diag.dtype, diag.device
    V, N, f, _ = diag.shape
    A, B, C = _identity_pad_lanes(lower, diag, upper, _pow2(N) - N)

    eye1 = torch.eye(f, dtype=dtype, device=dev).expand(V, 1, f, f)
    zed1 = torch.zeros((V, 1, f, f), dtype=dtype, device=dev)
    levels = []
    while A.shape[1] > 1:
        A_od, B_od, C_od = A[:, 1::2], B[:, 1::2], C[:, 1::2]
        Binv_od = block_inv(B_od)
        Binv_left = torch.cat([eye1, Binv_od[:, :-1]], 1)
        alpha = range_clamp(A[:, 0::2] @ Binv_left)
        gamma = range_clamp(C[:, 0::2] @ Binv_od)
        levels.append(_CRLevel(alpha, gamma, A_od, C_od, Binv_od))
        A_left = torch.cat([zed1, A_od[:, :-1]], 1)
        C_left = torch.cat([zed1, C_od[:, :-1]], 1)
        A, B, C = (range_clamp(-alpha @ A_left),
                   range_clamp(B[:, 0::2] - alpha @ C_left - gamma @ A_od),
                   range_clamp(-gamma @ C_od))
    return CRFactors(levels=tuple(levels), Binv_top=block_inv(B[:, 0]))


@span("linear.solve")
def block_tridiag_apply_cr_lanes(factors: CRFactors, rhs: torch.Tensor):
    """``block_tridiag_apply_cr`` over lanes: rhs (V, N, f)."""
    V, N, f = rhs.shape
    M = 2 ** len(factors.levels)
    zv1 = torch.zeros((V, 1, f), dtype=rhs.dtype, device=rhs.device)
    D = rhs
    if M > N:
        D = torch.cat([D, zv1.expand(V, M - N, f)], 1)

    odd_rhs = []
    for lev in factors.levels:
        D_ev, D_od = D[:, 0::2], D[:, 1::2]
        odd_rhs.append(D_od)
        D_left = torch.cat([zv1, D_od[:, :-1]], 1)
        D = range_clamp(D_ev - _mvl(lev.alpha, D_left)
                        - _mvl(lev.gamma, D_od))

    # the top solve lane by lane: the single-lane function's own
    # matrix-vector call, so each lane's apply has its bits
    x = torch.stack([top @ d for top, d in zip(factors.Binv_top,
                                               D[:, 0])])[:, None]  # (V, 1, f)
    for lev, D_od in zip(reversed(factors.levels), reversed(odd_rhs)):
        x_right = torch.cat([x[:, 1:], zv1], 1)
        r_od = range_clamp(D_od - _mvl(lev.A_od, x)
                           - _mvl(lev.C_od, x_right))
        x_odd = range_clamp(_mvl(lev.Binv_od, r_od))
        x = torch.stack([x, x_odd], dim=2).reshape(V, 2 * x.shape[1], f)
    return x[:, :N]


@span("linear.solve")
def tridiag_mp_solve_lanes(ell: BlockELL, rhs: torch.Tensor,
                           tol: float = 1.0e-8, max_refine: int = 40,
                           active: Optional[np.ndarray] = None):
    """``tridiag_mp_solve`` over lanes: a lane-batched BlockELL, rhs
    (V, N, f).  The f64 equilibration and the f32 CR factor and apply of
    every lane at once, then f64 GMRES over the lanes (``gmres_lanes``:
    each lane refines until it meets its own tol) whose matvec is one
    launch of the block-ELL kernel's lane axis.  ``active`` (V,) bool
    leaves the other lanes out.  Returns a KrylovResult whose ``resnorm``,
    ``iters`` and ``converged`` are (V,) arrays."""
    from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned

    Dinv0 = block_inv(ell.diag_blocks())
    ell_eq = ell.scale_rows(Dinv0)
    b = _mvl(Dinv0, rhs)
    lo, di, up = block_tridiag_from_ell_lanes(ell_eq)
    fac = block_tridiag_factor_cr_lanes(lo.to(torch.float32),
                                        di.to(torch.float32),
                                        up.to(torch.float32))
    ell_eq = BlockELL(ell_eq.adj, lane_aligned(ell_eq.flat),
                      ell_eq.diag_slot)

    def solve32(r):
        return block_tridiag_apply_cr_lanes(
            fac, r.to(torch.float32)).to(rhs.dtype)

    return gmres_lanes(ell_eq.matvec, b, Minv=solve32, tol=tol,
                       restart=min(max_refine, 30), maxiter=max_refine,
                       active=active)


# ---------------------------------------------------------------------------
# Preconditioners
# ---------------------------------------------------------------------------

@span("linear.factor")
def block_jacobi_preconditioner(ell: BlockELL) -> Callable[[torch.Tensor],
                                                            torch.Tensor]:
    """M^{-1} z with M = block diagonal of the matrix; z, out: (N, f)."""
    Dinv = block_inv(ell.diag_blocks())

    def apply(z):
        return _mv(Dinv, z)

    return apply


@span("linear.factor")
def block_jacobi_preconditioner_lanes(ell: BlockELL) -> Callable[
        [torch.Tensor], torch.Tensor]:
    """``block_jacobi_preconditioner`` of a lane-batched BlockELL; z, out:
    (V, N, f)."""
    Dinv = block_inv(ell.diag_blocks())

    def apply(z):
        return _mvl(Dinv, z)

    return apply


def greedy_vertex_coloring(adj: "np.ndarray") -> "np.ndarray":
    """Host-side greedy graph coloring of the (padded) adjacency table.

    Adjacent vertices get different colors, so a Gauss-Seidel sweep can
    update each color as one batched, order-independent operation — the
    TPU-parallel replacement for the inherently sequential GS recursion.
    Returns (N,) int32 colors.
    """
    import numpy as _np

    N = adj.shape[0]
    colors = _np.full(N, -1, dtype=_np.int32)
    for v in range(N):
        used = set(colors[u] for u in adj[v] if u != v and colors[u] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def _color_lists(colors: "np.ndarray", dev) -> list:
    """Each color's vertex ids as a device tensor, padded to the longest
    with its first vertex, as in the reference (a padded row computes the
    same value as the row it repeats, so which duplicate write lands does
    not matter)."""
    colors_np = np.asarray(colors)
    nc = int(colors_np.max()) + 1
    maxlen = max((colors_np == c).sum() for c in range(nc))
    lists = []
    for c in range(nc):
        verts = np.nonzero(colors_np == c)[0]
        pad = np.full(maxlen - len(verts), verts[0], dtype=np.int64)
        lists.append(torch.as_tensor(np.concatenate([verts, pad]),
                                     dtype=torch.int64, device=dev))
    return lists


def _diag_mask(ell: BlockELL) -> torch.Tensor:
    """(N, K*f) bool: each row's diagonal block columns (diag_slot*f ..
    diag_slot*f + f-1) of the flat layout."""
    N, K, f, _ = ell.shape4
    dev = ell.flat.device
    dcols = (ell.diag_slot[:, None] * f
             + torch.arange(f, device=dev)[None, :])
    dmask = torch.zeros((N, K * f), dtype=torch.bool, device=dev)
    dmask.scatter_(1, dcols, True)
    return dmask


@span("linear.factor")
def multicolor_ssor_preconditioner(
    ell: BlockELL,
    colors: "np.ndarray",
    sweeps: int = 1,
    omega: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Block-SSOR preconditioner via multicolor sweeps.

    M = (D/w + L) (D/w)^{-1} (D/w + U); application solves the two
    triangular block systems by sweeping the colors forward then backward —
    each color is one batched block solve (all rows of a color are mutually
    non-adjacent).  ``colors`` comes from :func:`greedy_vertex_coloring`
    (or ``FemSpace.colors``), host-side, once per mesh.

    Each color's vertex list is padded to the longest with its first
    vertex, as in the reference; a padded row computes the same value as
    the row it repeats, so which duplicate write lands does not matter.
    The off-diagonal rows of a color are one gather of their block rows
    and of ``z[adj]`` and one batched matrix-vector product (``bmm``).
    """
    _, K, f, _ = ell.shape4
    dev = ell.flat.device
    color_lists = _color_lists(colors, dev)
    nc = len(color_lists)

    D = ell.diag_blocks() / omega
    Dinv = block_inv(D)
    offflat = ell.flat.masked_fill(_diag_mask(ell)[:, None, :], 0.0)
    adj = ell.adj.long()

    def offdiag_rows(z, verts):
        """sum_k offblocks[v,k] z[adj[v,k]] for a vertex set."""
        blk = offflat[verts]                          # (M, f, K*f)
        zg = z[adj[verts]].reshape(len(verts), K * f, 1)
        return torch.bmm(blk, zg)[..., 0]

    def sweep(z, r, order):
        for c in order:
            verts = color_lists[c]
            rhs = r[verts] - offdiag_rows(z, verts)
            z[verts] = _mv(Dinv[verts], rhs)
        return z

    def ssor_solve(r):
        # forward: (D/w + L)^{-1} r -> scale by D/w -> backward (D/w + U)^{-1}
        z = sweep(torch.zeros_like(r), r, range(nc))
        z = _mv(D, z)
        return sweep(torch.zeros_like(r), z, range(nc - 1, -1, -1))

    def apply(r):
        z = ssor_solve(r)
        for _ in range(sweeps - 1):   # extra sweeps = stationary iteration
            z = z + ssor_solve(r - ell.matvec(z))
        return z

    return apply


@span("linear.factor")
def multicolor_ssor_preconditioner_lanes(
    ell: BlockELL,
    colors: "np.ndarray",
    sweeps: int = 1,
    omega: float = 1.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``multicolor_ssor_preconditioner`` of a lane-batched BlockELL (r,
    out: (V, N, f)): the block inverses, the diagonal scaling and the extra
    sweeps' matvecs are one call over the lanes; each color's gathers,
    off-diagonal products and block solves are the single-lane calls, lane
    by lane."""
    _, K, f, _ = ell.shape4
    color_lists = _color_lists(colors, ell.flat.device)
    nc = len(color_lists)
    D = ell.diag_blocks() / omega
    Dinv = block_inv(D)
    offflat = ell.flat.masked_fill(_diag_mask(ell)[None, :, None, :], 0.0)
    adj = ell.adj.long()

    def sweep(z, r, order):
        # lane by lane, the single-lane preconditioner's own calls on
        # operands gathered afresh: one product over the V lanes' rows of a
        # color, or one on a lane's slice of them, rounds otherwise on the
        # card
        for c in order:
            verts = color_lists[c]
            nbrs = adj[verts]
            for zl, rl, offl, Dl in zip(z, r, offflat, Dinv):
                zg = zl[nbrs].reshape(len(verts), K * f, 1)
                rhs = rl[verts] - torch.bmm(offl[verts], zg)[..., 0]
                zl[verts] = _mv(Dl[verts], rhs)
        return z

    def ssor_solve(r):
        z = sweep(torch.zeros_like(r), r, range(nc))
        z = _mvl(D, z)
        return sweep(torch.zeros_like(r), z, range(nc - 1, -1, -1))

    def apply(r):
        z = ssor_solve(r)
        for _ in range(sweeps - 1):
            z = z + ssor_solve(r - ell.matvec(z))
        return z

    return apply


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------

class KrylovResult(NamedTuple):
    x: torch.Tensor
    resnorm: float
    iters: int
    converged: bool


# Breakdown guard magnitude, the reference's value: representable in f32
# and far below any legitimate quantity in the scaled systems solved here.
_TINY = 1e-30


def _guard(x):
    """Replace ~zero denominators with a representable tiny value."""
    return torch.where(torch.abs(x) < _TINY,
                       torch.full_like(x, _TINY), x)


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


@span("linear.krylov")
def gmres(
    matvec: Callable,
    b: torch.Tensor,
    Minv: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 300,
) -> KrylovResult:
    """Right-preconditioned restarted GMRES with Givens-rotation residual
    tracking.  Operates on arbitrarily-shaped arrays (flattened
    internally).  Stops when ||r|| <= max(tol*||b||, atol).

    The reference's ``while_loop``/``fori_loop``/``cond`` become Python
    loops: each Arnoldi step reads its new Hessenberg column back to the
    host (one device sync), where the Givens rotations, the ``done`` test
    and the small triangular solve run in numpy in b's dtype — the same
    operations, in the same precision, as the reference's.  Iteration
    counts follow the reference: the ``done`` flag is checked before each
    inner step and ``total_it < maxiter`` before each cycle.
    """
    shape = b.shape
    n = b.numel()
    dtype = b.dtype
    dev = b.device
    nd = _NP_DTYPE[dtype]
    tiny = nd(_TINY)
    bflat = b.reshape(-1)
    if Minv is None:
        Minv = lambda z: z
    mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
    pc = lambda v: Minv(v.reshape(shape)).reshape(-1)

    x = (torch.zeros(n, dtype=dtype, device=dev) if x0 is None
         else x0.reshape(-1))
    bnorm = nd(to_host(_norm(bflat)))
    target = max(nd(tol) * bnorm, nd(atol), tiny)
    m = restart

    rnorm, total_it, conv = nd(np.inf), 0, False
    while (not conv) and total_it < maxiter:
        r = bflat - mv(x)
        beta_t = _norm(r)
        beta = nd(to_host(beta_t))

        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.clamp_min(beta_t, _TINY)
        H = np.zeros((m + 1, m), nd)
        cs = np.zeros(m, nd)
        sn = np.zeros(m, nd)
        g = np.zeros(m + 1, nd)
        g[0] = beta
        done = beta <= target
        k = 0
        for j in range(m):
            if done:
                break
            w = mv(pc(V[j]))
            # classical Gram-Schmidt with one re-orthogonalization (CGS2);
            # rows of V beyond j are zero, so no masking is needed
            h1 = V @ w
            w = w - h1 @ V
            h2 = V @ w
            w = w - h2 @ V
            hlast = _norm(w)
            V[j + 1] = w / torch.clamp_min(hlast, _TINY)
            hcol_t = h1 + h2
            hcol_t[j + 1] = hlast
            hcol = to_host(hcol_t).astype(nd)
            # apply previous Givens rotations to the new column
            for i in range(j):
                hi, hip = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * hi + sn[i] * hip
                hcol[i + 1] = -sn[i] * hi + cs[i] * hip
            # new rotation annihilating hcol[j+1]
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = hcol[j] / max(denom, tiny) if denom > 0 else nd(1.0)
            s = hcol[j + 1] / max(denom, tiny) if denom > 0 else nd(0.0)
            hcol[j] = c * hcol[j] + s * hcol[j + 1]
            hcol[j + 1] = 0.0
            cs[j] = c
            sn[j] = s
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            H[:, j] = hcol[:m + 1]
            done = abs(g[j + 1]) <= target
            k += 1

        if k == 0:
            # no Arnoldi step: the update is exactly zero and the residual
            # is the cycle's starting residual
            rnorm = beta
        else:
            # H[:k,:k] y = g[:k], padded with identity to m x m as the
            # reference does
            used = np.arange(m) < k
            Hsq = np.where(used[None, :] & used[:, None], H[:m, :m],
                           np.eye(m, dtype=nd))
            gv = np.where(used, g[:m], nd(0.0))
            y = triangular_solve_upper(Hsq, gv)
            y_t = torch.as_tensor(y, dtype=dtype).to(dev)
            x = x + pc(V[:m].T @ y_t)
            rnorm = nd(to_host(_norm(bflat - mv(x))))
        total_it += k
        conv = bool(rnorm <= target)
    return KrylovResult(x.reshape(shape), float(rnorm), total_it, conv)


# The Krylov lanes' reductions and products: each lane takes the
# single-lane solver's own call on its slice (V small calls where a batched
# product or row reduction would round otherwise, on the card too), so a
# lane's iterates follow its single-lane solve's arithmetic.

def _norm_lanes(v):
    """(V, n) -> (V,): ``_norm`` of each lane."""
    return torch.stack([_norm(x) for x in v])


def _dot_lanes(a, b):
    """(V, n), (V, n) -> (V,): ``torch.dot`` of each lane."""
    return torch.stack([torch.dot(x, y) for x, y in zip(a, b)])


def _scalar_squares(a: np.ndarray) -> np.ndarray:
    """``v ** 2`` of each entry as a numpy scalar squares it (``gmres``'s
    Givens arithmetic): the scalar power goes through the C library's pow,
    which for about one value in a thousand rounds otherwise than the
    array power's product."""
    return np.array([v ** 2 for v in a], dtype=a.dtype)


@span("linear.krylov")
def gmres_lanes(
    matvec: Callable,
    b: torch.Tensor,
    Minv: Optional[Callable] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 300,
    active: Optional[np.ndarray] = None,
) -> KrylovResult:
    """``gmres`` over sweep lanes: b (V, ...), ``matvec`` and ``Minv`` map
    (V, ...) to (V, ...) (one batched call for all lanes).

    Each lane has its own Arnoldi basis, Givens rotations, residual target
    and stopping: a lane that meets its target (or, between cycles, spends
    its ``maxiter``) is frozen while the others go on, as the lanes of the
    reference's vmapped ``while_loop`` are.  The matvec and the
    preconditioner take every lane at once; each lane's CGS2 products and
    norms are ``gmres``'s own calls on its slice.  Each Arnoldi step reads
    the (V, j+2) block of new Hessenberg columns back to the host in one
    sync, not one per lane.  ``active`` (V,) bool leaves the other lanes out
    altogether (zero iterations, x = 0).  Returns a KrylovResult whose
    ``resnorm``, ``iters`` and ``converged`` are (V,) numpy arrays."""
    V = b.shape[0]
    shape = b.shape
    n = b[0].numel()
    dtype = b.dtype
    dev = b.device
    nd = _NP_DTYPE[dtype]
    tiny = nd(_TINY)
    bflat = b.reshape(V, n)
    if Minv is None:
        Minv = lambda z: z
    mv = lambda v: matvec(v.reshape(shape)).reshape(V, n)
    pc = lambda v: Minv(v.reshape(shape)).reshape(V, n)

    x = torch.zeros((V, n), dtype=dtype, device=dev)
    bnorm = to_host(_norm_lanes(bflat)).astype(nd)
    target = np.maximum(np.maximum(nd(tol) * bnorm, nd(atol)), tiny)
    m = restart
    live = (np.ones(V, bool) if active is None
            else np.asarray(active, bool).copy())

    rnorm = np.full(V, np.inf, nd)
    total_it = np.zeros(V, np.int64)
    conv = np.zeros(V, bool)
    going = live & ~conv & (total_it < maxiter)
    while going.any():
        r = bflat - mv(x)
        beta_t = _norm_lanes(r)
        beta = to_host(beta_t).astype(nd)

        zero = torch.zeros((), dtype=dtype, device=dev)
        Vb = torch.zeros((V, m + 1, n), dtype=dtype, device=dev)
        Vb[:, 0] = torch.where(
            torch.as_tensor(going, device=dev)[:, None],
            r / torch.clamp_min(beta_t, _TINY)[:, None], zero)
        H = np.zeros((V, m + 1, m), nd)
        cs = np.zeros((V, m), nd)
        sn = np.zeros((V, m), nd)
        g = np.zeros((V, m + 1), nd)
        g[:, 0] = beta
        done = (beta <= target) | ~going
        k = np.zeros(V, np.int64)
        for j in range(m):
            if done.all():
                break
            step = ~done
            # the matvec and preconditioner step every lane on the device
            # (a lane that is done computes rows it never uses, cleared
            # before the update below), so the only sync is the read of
            # the new columns
            w = mv(pc(Vb[:, j]))
            # CGS2 of each stepping lane, ``gmres``'s own calls; rows of a
            # lane's basis beyond j are zero
            hcol_t = torch.zeros((V, m + 1), dtype=dtype, device=dev)
            for lane in np.nonzero(step)[0]:
                Vl, wl = Vb[lane], w[lane]
                h1 = Vl @ wl
                wl = wl - h1 @ Vl
                h2 = Vl @ wl
                wl = wl - h2 @ Vl
                hlast = _norm(wl)
                Vl[j + 1] = wl / torch.clamp_min(hlast, _TINY)
                hcol_t[lane] = h1 + h2
                hcol_t[lane, j + 1] = hlast
            hcol = to_host(hcol_t[:, :j + 2]).astype(nd)
            # previous rotations, then the new one, lane by lane (the
            # scalar arithmetic of ``gmres`` on (V,) arrays)
            for i in range(j):
                hi, hip = hcol[:, i].copy(), hcol[:, i + 1].copy()
                hcol[:, i] = cs[:, i] * hi + sn[:, i] * hip
                hcol[:, i + 1] = -sn[:, i] * hi + cs[:, i] * hip
            denom = np.sqrt(_scalar_squares(hcol[:, j])
                            + _scalar_squares(hcol[:, j + 1]))
            safe = np.maximum(denom, tiny)
            pos = denom > 0
            c = np.where(pos, hcol[:, j] / safe, nd(1.0))
            sv = np.where(pos, hcol[:, j + 1] / safe, nd(0.0))
            hcol[:, j] = c * hcol[:, j] + sv * hcol[:, j + 1]
            hcol[:, j + 1] = 0.0
            cs[:, j] = np.where(step, c, cs[:, j])
            sn[:, j] = np.where(step, sv, sn[:, j])
            gj = g[:, j].copy()
            g[:, j] = np.where(step, c * gj, g[:, j])
            g[:, j + 1] = np.where(step, -sv * gj, g[:, j + 1])
            H[step, :j + 2, j] = hcol[step]
            done = done | (step & (np.abs(g[:, j + 1]) <= target))
            k += step

        upd = going & (k > 0)
        rnorm = np.where(going & (k == 0), beta, rnorm)
        if upd.any():
            Y = np.zeros((V, m), nd)
            for lane in np.nonzero(upd)[0]:
                Vb[lane, k[lane]:] = 0.0
                used = np.arange(m) < k[lane]
                Hsq = np.where(used[None, :] & used[:, None],
                               H[lane, :m, :m], np.eye(m, dtype=nd))
                gv = np.where(used, g[lane, :m], nd(0.0))
                Y[lane] = triangular_solve_upper(Hsq, gv)
            upd_t = torch.as_tensor(upd, device=dev)[:, None]
            x = torch.where(upd_t, x + pc(torch.stack(
                [Vl[:m].T @ torch.as_tensor(yl, dtype=dtype).to(dev)
                 for Vl, yl in zip(Vb, Y)])), x)
            rn = to_host(_norm_lanes(bflat - mv(x))).astype(nd)
            rnorm = np.where(upd, rn, rnorm)
        total_it += np.where(going, k, 0)
        conv = np.where(going, rnorm <= target, conv)
        going = live & ~conv & (total_it < maxiter)
    return KrylovResult(x.reshape(shape), rnorm.astype(np.float64),
                        total_it, conv)


@span("linear.krylov")
def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    Minv: Optional[Callable] = None,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 500,
) -> KrylovResult:
    """Preconditioned BiCGStab (right preconditioning).

    The reference's ``while_loop`` becomes a Python loop with the same
    stopping rule, tested before every iteration: go on while the residual
    is above target, the budget is not spent, and the state is healthy
    (finite residual, rho and omega; |rho|, |omega| above the breakdown
    guard; residual under 1e12).  The predicate is one device tensor read
    back through ``sync.to_host`` per iteration.
    """
    shape = b.shape
    dtype = b.dtype
    dev = b.device
    nd = _NP_DTYPE[dtype]
    bflat = b.reshape(-1)
    if Minv is None:
        Minv = lambda z: z
    mv = lambda v: matvec(v.reshape(shape)).reshape(-1)
    pc = lambda v: Minv(v.reshape(shape)).reshape(-1)

    x = torch.zeros_like(bflat) if x0 is None else x0.reshape(-1)
    r = bflat - mv(x)
    rhat = r
    bnorm = nd(to_host(_norm(bflat)))
    target = max(nd(tol) * bnorm, nd(atol), nd(_TINY))

    def going(r, rho, omega):
        rn = _norm(r)
        healthy = (torch.isfinite(rn) & torch.isfinite(rho)
                   & torch.isfinite(omega) & (torch.abs(rho) > _TINY)
                   & (torch.abs(omega) > _TINY) & (rn < 1e12))
        return bool(to_host((rn > target) & healthy))

    p = torch.zeros_like(bflat)
    v = torch.zeros_like(bflat)
    one = torch.ones((), dtype=dtype, device=dev)
    rho, alpha, omega = one, one, one
    it = 0
    while it < maxiter and going(r, rho, omega):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p = r + beta * (p - omega * v)
        phat = pc(p)
        v = mv(phat)
        alpha = rho_new / _guard(torch.dot(rhat, v))
        s = r - alpha * v
        shat = pc(s)
        t = mv(shat)
        omega = torch.dot(t, s) / _guard(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
    rnorm = nd(to_host(_norm(r)))
    return KrylovResult(x.reshape(shape), float(rnorm), it,
                        bool(rnorm <= target))


@span("linear.krylov")
def bicgstab_lanes(
    matvec: Callable,
    b: torch.Tensor,
    Minv: Optional[Callable] = None,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 500,
    active: Optional[np.ndarray] = None,
) -> KrylovResult:
    """``bicgstab`` over sweep lanes: b (V, ...), ``matvec`` and ``Minv``
    map (V, ...) to (V, ...) (one batched call for all lanes).

    Each lane keeps its own scalars, residual target and stopping rule
    (``bicgstab``'s, tested before every iteration); a lane that stops is
    frozen by a select while the others go on, as the lanes of the
    reference's vmapped ``while_loop`` are, so its ``x`` and ``iters`` are
    its single-lane solve's.  The (V,) predicate is one host read per
    iteration, whatever V is.  ``active`` (V,) bool leaves the other lanes
    out altogether (zero iterations, x = 0).  Returns a KrylovResult whose
    ``resnorm``, ``iters`` and ``converged`` are (V,) numpy arrays."""
    V = b.shape[0]
    shape = b.shape
    n = b[0].numel()
    dtype = b.dtype
    dev = b.device
    nd = _NP_DTYPE[dtype]
    bflat = b.reshape(V, n)
    if Minv is None:
        Minv = lambda z: z
    mv = lambda v: matvec(v.reshape(shape)).reshape(V, n)
    pc = lambda v: Minv(v.reshape(shape)).reshape(V, n)

    x = torch.zeros_like(bflat)
    r = bflat - mv(x)
    rhat = r
    bnorm = to_host(_norm_lanes(bflat)).astype(nd)
    target = np.maximum(np.maximum(nd(tol) * bnorm, nd(atol)), nd(_TINY))
    target_t = torch.as_tensor(target, device=dev)
    live = (np.ones(V, bool) if active is None
            else np.asarray(active, bool).copy())

    def going(r, rho, omega):
        rn = _norm_lanes(r)
        healthy = (torch.isfinite(rn) & torch.isfinite(rho)
                   & torch.isfinite(omega) & (torch.abs(rho) > _TINY)
                   & (torch.abs(omega) > _TINY) & (rn < 1e12))
        return to_host((rn > target_t) & healthy).astype(bool)

    p = torch.zeros_like(bflat)
    v = torch.zeros_like(bflat)
    one = torch.ones(V, dtype=dtype, device=dev)
    rho, alpha, omega = one, one, one
    it = np.zeros(V, np.int64)
    go = live & (it < maxiter)
    if go.any():
        go &= going(r, rho, omega)
    while go.any():
        g = torch.as_tensor(go, device=dev)
        gv = g[:, None]
        rho_new = _dot_lanes(rhat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p_new = r + beta[:, None] * (p - omega[:, None] * v)
        phat = pc(p_new)
        v_new = mv(phat)
        alpha_new = rho_new / _guard(_dot_lanes(rhat, v_new))
        s = r - alpha_new[:, None] * v_new
        shat = pc(s)
        t = mv(shat)
        omega_new = _dot_lanes(t, s) / _guard(_dot_lanes(t, t))
        x = torch.where(gv, x + alpha_new[:, None] * phat
                        + omega_new[:, None] * shat, x)
        r = torch.where(gv, s - omega_new[:, None] * t, r)
        p = torch.where(gv, p_new, p)
        v = torch.where(gv, v_new, v)
        rho = torch.where(g, rho_new, rho)
        alpha = torch.where(g, alpha_new, alpha)
        omega = torch.where(g, omega_new, omega)
        it += go
        go = live & (it < maxiter)
        if go.any():
            go &= going(r, rho, omega)
    rnorm = to_host(_norm_lanes(r)).astype(nd)
    return KrylovResult(x.reshape(shape), rnorm.astype(np.float64), it,
                        live & (rnorm <= target))


@span("linear.solve")
def dense_solve(ell: BlockELL, rhs: torch.Tensor) -> torch.Tensor:
    """Direct dense solve (tests / small systems)."""
    N, _, f, _ = ell.shape4
    x = torch.linalg.solve(ell.to_dense(), rhs.reshape(-1))
    return x.reshape(N, f)


@span("linear.solve")
def dense_solve_lanes(ell: BlockELL, rhs: torch.Tensor) -> torch.Tensor:
    """``dense_solve`` of a lane-batched BlockELL: rhs (V, N, f), one
    batched dense solve of the lanes' (V, N*f, N*f) matrices."""
    V = rhs.shape[0]
    x = torch.linalg.solve(ell.to_dense(), rhs.reshape(V, -1))
    return x.reshape(rhs.shape)
