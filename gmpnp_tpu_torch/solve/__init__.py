"""Solvers: small-block Gauss-Jordan, GMRES, the z-slab direct solver,
damped Newton and the implicit time loop.

Ported from ``gmpnp_tpu.solve`` for the 3D slab path; the 1D
block-tridiagonal solvers, BiCGStab, AMG and the SSOR/block-Jacobi
preconditioners are still to be ported (ROADMAP queue 1).
"""

from gmpnp_tpu_torch.solve.linear import dense_solve, gmres
from gmpnp_tpu_torch.solve.newton import NewtonResult, newton_solve

__all__ = [
    "dense_solve",
    "gmres",
    "NewtonResult",
    "newton_solve",
]
