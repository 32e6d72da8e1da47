"""L2 projection onto P1 vertex fields.

Replaces FEniCS ``project(...)`` as used by the reference for cell-wise
quantities (field = project(-grad(u)) post-processing; per-species gradient
projections 3D/MPNP_CO2ER_pore.py:884-909).

For piecewise-constant integrands on P1 simplices the load vector is exact:
    b_a = sum_cells f_c * vol_c / (dim+1)
and the projection solves the consistent P1 mass system  M x = b  (CG — the
mass matrix is SPD and well-conditioned, a handful of iterations suffice).
"""

from __future__ import annotations

import torch

from gmpnp_tpu_torch.fem.assembly import FemSpace
from gmpnp_tpu_torch.sync import to_host


def mass_matvec(space: FemSpace, x: torch.Tensor) -> torch.Tensor:
    """y = M x for the scalar P1 consistent mass matrix, computed matrix-free
    from element mass blocks (exact for affine simplices)."""
    cells = space.dev["cells"]
    nv = cells.shape[1]
    # element mass matrix (nv, nv): vol * (1 + delta_ab) / ((nv)(nv+1))
    Me = ((torch.ones((nv, nv), dtype=x.dtype, device=x.device)
           + torch.eye(nv, dtype=x.dtype, device=x.device))
          / (nv * (nv + 1.0)))
    x_e = x[cells]                             # (C, nv, comps)
    y_e = torch.einsum("ab,c,cbk->cak", Me, space.dev["vols"], x_e)
    return torch.zeros_like(x).index_add(0, cells.reshape(-1),
                                         y_e.reshape(-1, x.shape[1]))


def project_cellwise(
    space: FemSpace,
    cell_values: torch.Tensor,
    tol: float = 1e-12,
    maxiter: int = 200,
) -> torch.Tensor:
    """L2-project piecewise-constant cell data (C,) or (C, k) onto P1
    vertex values (N,) or (N, k)."""
    squeeze = cell_values.dim() == 1
    f_c = cell_values[:, None] if squeeze else cell_values
    cells = space.dev["cells"]
    nv = cells.shape[1]
    # exact load vector for cellwise-constant f
    b_e = ((space.dev["vols"][:, None] / nv)[:, None, :]
           * torch.ones((1, nv, 1), dtype=f_c.dtype, device=f_c.device)
           * f_c[:, None, :])
    b = torch.zeros((space.num_vertices, f_c.shape[1]), dtype=f_c.dtype,
                    device=f_c.device)
    b = b.index_add(0, cells.reshape(-1), b_e.reshape(-1, f_c.shape[1]))
    x = _mass_cg(space, b, tol=tol, maxiter=maxiter)
    return x[:, 0] if squeeze else x


def project_gradient(
    space: FemSpace,
    u_vertex: torch.Tensor,
    sign: float = 1.0,
    tol: float = 1e-12,
    maxiter: int = 200,
) -> torch.Tensor:
    """Project ``sign * grad(u)`` of a P1 scalar field to a P1 vector field
    (N, dim) — the reference's ``field = project(-grad(u_np), W)``."""
    grads = torch.einsum("ca,cad->cd", u_vertex[space.dev["cells"]],
                         space.dev["gradN"])
    return project_cellwise(space, sign * grads, tol=tol, maxiter=maxiter)


def _mass_cg(space: FemSpace, b: torch.Tensor, tol: float, maxiter: int):
    """Conjugate gradients on the SPD mass system (multi-RHS)."""
    # Jacobi preconditioner: lumped mass (exact diagonal scaling surrogate)
    cells = space.dev["cells"]
    nv = cells.shape[1]
    lump = torch.zeros(space.num_vertices, dtype=b.dtype, device=b.device)
    lump = lump.index_add(
        0, cells.reshape(-1),
        (space.dev["vols"] / nv)[:, None].expand(cells.shape).reshape(-1))
    Minv = 1.0 / lump

    x = b * Minv[:, None]  # lumped-mass initial guess
    r = b - mass_matvec(space, x)
    z = r * Minv[:, None]
    p = z
    rz = torch.sum(r * z)
    bnorm = to_host(torch.sqrt(torch.sum(b * b)))
    target = tol * max(bnorm, 1e-300)

    it = 0
    while it < maxiter and to_host(torch.sqrt(torch.sum(r * r))) > target:
        Ap = mass_matvec(space, p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * Minv[:, None]
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x
