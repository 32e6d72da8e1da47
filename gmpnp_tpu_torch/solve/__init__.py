"""Solvers: small-block Gauss-Jordan, the 1D block-tridiagonal direct
solvers (cyclic reduction, Thomas, mixed precision), GMRES and BiCGStab
with block-Jacobi, multicolor SSOR and AMG (``solve.amg``)
preconditioners, the z-slab direct solver, damped Newton and the implicit
time loop.  Ported from ``gmpnp_tpu.solve``.
"""

from gmpnp_tpu_torch.solve.linear import (
    bicgstab,
    block_jacobi_preconditioner,
    block_tridiag_apply_cr,
    block_tridiag_factor_cr,
    block_tridiag_from_ell,
    block_tridiag_solve_cr,
    block_tridiag_solve_thomas,
    dense_solve,
    gmres,
    greedy_vertex_coloring,
    multicolor_ssor_preconditioner,
    tridiag_mp_solve,
)
from gmpnp_tpu_torch.solve.newton import NewtonResult, newton_solve

__all__ = [
    "bicgstab",
    "block_jacobi_preconditioner",
    "greedy_vertex_coloring",
    "multicolor_ssor_preconditioner",
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
