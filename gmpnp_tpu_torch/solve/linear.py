"""Krylov and dense solvers over BlockELL matrices.

Ported so far: restarted GMRES (CGS2 Arnoldi, Givens residual tracking) —
the Krylov iteration of the z-slab direct solver (solve.slab) — and the
dense direct solve used by tests.  The 1D block-tridiagonal solvers,
BiCGStab and the block-Jacobi/SSOR preconditioners of
``gmpnp_tpu/solve/linear.py`` are still to be ported (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL
from gmpnp_tpu_torch.solve.smallblock import triangular_solve_upper
from gmpnp_tpu_torch.sync import to_host


class KrylovResult(NamedTuple):
    x: torch.Tensor
    resnorm: float
    iters: int
    converged: bool


# Breakdown guard magnitude, the reference's value: representable in f32
# and far below any legitimate quantity in the scaled systems solved here.
_TINY = 1e-30


def _norm(v):
    return torch.sqrt(torch.sum(v * v))


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


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


def dense_solve(ell: BlockELL, rhs: torch.Tensor) -> torch.Tensor:
    """Direct dense solve (tests / small systems)."""
    N, _, f, _ = ell.shape4
    x = torch.linalg.solve(ell.to_dense(), rhs.reshape(-1))
    return x.reshape(N, f)
