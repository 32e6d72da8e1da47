"""Finite-element core: P1 simplicial elements, weak-form assembly, BCs.

Weak forms are per-quadrature-point torch functions; element Jacobians come
from ``torch.func.jacfwd`` of the local residual, vmapped over elements;
global assembly reduces into a block-ELL sparse structure whose sparsity is
precomputed host-side in numpy (the same tables as ``gmpnp_tpu.fem``).
"""

from gmpnp_tpu_torch.fem.elements import QuadratureRule, simplex_quadrature
from gmpnp_tpu_torch.fem.forms import WeakForm
from gmpnp_tpu_torch.fem.assembly import FemSpace, BlockELL
from gmpnp_tpu_torch.fem.dirichlet import ArithDirichletBC, DirichletBC

__all__ = [
    "QuadratureRule",
    "simplex_quadrature",
    "WeakForm",
    "FemSpace",
    "BlockELL",
    "DirichletBC",
    "ArithDirichletBC",
]
