"""Solvers: small-block Gauss-Jordan, the 1D block-tridiagonal direct
solvers (cyclic reduction, Thomas, mixed precision), GMRES, the z-slab
direct solver, damped Newton and the implicit time loop.

Ported from ``gmpnp_tpu.solve``; BiCGStab, AMG and the SSOR/block-Jacobi
preconditioners are still to be ported (ROADMAP queue 1).
"""

from gmpnp_tpu_torch.solve.linear import (
    block_tridiag_apply_cr,
    block_tridiag_factor_cr,
    block_tridiag_from_ell,
    block_tridiag_solve_cr,
    block_tridiag_solve_thomas,
    dense_solve,
    gmres,
    tridiag_mp_solve,
)
from gmpnp_tpu_torch.solve.newton import NewtonResult, newton_solve

__all__ = [
    "block_tridiag_apply_cr",
    "block_tridiag_factor_cr",
    "block_tridiag_from_ell",
    "block_tridiag_solve_cr",
    "block_tridiag_solve_thomas",
    "tridiag_mp_solve",
    "dense_solve",
    "gmres",
    "NewtonResult",
    "newton_solve",
]
