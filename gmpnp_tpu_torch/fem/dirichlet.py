"""Dirichlet boundary conditions via row masking.

Replaces dolfin::DirichletBC application (row replacement in the Newton
system).  The constrained residual entry becomes ``u - value`` and the
Jacobian row becomes the identity row, which reproduces DOLFIN's
NonlinearVariationalSolver behavior exactly: the Newton update drives the
constrained dof to its value in one step and keeps it there.

Masks are fixed per mesh (sparsity-defining); values are device tensors so
per-step BC updates (the Sechenov CO2 Dirichlet value,
3D/MPNP_CO2ER_pore.py:835-838) stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL


class DirichletBC(NamedTuple):
    mask: torch.Tensor    # (N, fields) bool — constrained dofs
    values: torch.Tensor  # (N, fields) — target values (entries off-mask ignored)

    @staticmethod
    def from_vertex_sets(
        num_vertices: int,
        n_fields: int,
        entries: Sequence[Tuple[np.ndarray, int, float]],
        device="cpu",
    ) -> "DirichletBC":
        """Build from (vertex_ids, field, value) triples (later entries win
        on shared vertices)."""
        mask = np.zeros((num_vertices, n_fields), dtype=bool)
        vals = np.zeros((num_vertices, n_fields))
        for verts, fld, val in entries:
            mask[verts, fld] = True
            vals[verts, fld] = val
        return DirichletBC(
            torch.as_tensor(mask, device=device),
            torch.as_tensor(vals, dtype=torch.float64, device=device))

    def with_values(self, values: torch.Tensor) -> "DirichletBC":
        """Replace the value array (e.g. per-step updates)."""
        return DirichletBC(self.mask, values)

    def set_value(self, verts, fld: int, value) -> "DirichletBC":
        """Functionally update the value on a vertex set; ``value`` may be a
        float or a 0-d tensor on the BC's device."""
        vals = self.values.clone()
        vals[verts, fld] = value
        return DirichletBC(self.mask, vals)

    def arith(self) -> "ArithDirichletBC":
        """Arithmetic-blend view of this BC (see ArithDirichletBC)."""
        return ArithDirichletBC(self.mask, self.mask.to(torch.float64),
                                self.values)

    def apply_to_residual(self, r: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask, u - self.values, r)

    def apply_to_jacobian(self, J: BlockELL) -> BlockELL:
        """Zero constrained rows and place 1 on their diagonal entries (in
        every lane of a lane-batched matrix: the rows depend on the mask
        alone)."""
        if J.flat.dim() == 4:
            return self._apply_to_lane_jacobian(J)
        N, f, Kf = J.flat.shape
        flat = torch.where(self.mask[:, :, None],
                           torch.zeros((), dtype=J.flat.dtype,
                                       device=J.flat.device), J.flat)
        # constrained (n, r): set flat[n, r, diag_slot[n]*f + r] = 1
        rows = torch.arange(N, device=flat.device)[:, None].expand(N, f)
        rr = torch.arange(f, device=flat.device)[None, :].expand(N, f)
        cols = J.diag_slot[:, None] * f + rr
        vals = torch.where(self.mask,
                           torch.ones((), dtype=flat.dtype,
                                      device=flat.device),
                           flat[rows, rr, cols])
        flat[rows, rr, cols] = vals
        return BlockELL(adj=J.adj, flat=flat, diag_slot=J.diag_slot)

    def _apply_to_lane_jacobian(self, J: BlockELL) -> BlockELL:
        V, N, f, Kf = J.flat.shape
        dev = J.flat.device
        flat = torch.where(self.mask[:, :, None],
                           torch.zeros((), dtype=J.flat.dtype, device=dev),
                           J.flat)
        rows, rr = torch.nonzero(self.mask, as_tuple=True)
        flat[:, rows, rr, J.diag_slot[rows] * f + rr] = 1.0
        return BlockELL(adj=J.adj, flat=flat, diag_slot=J.diag_slot)

    def project(self, u: torch.Tensor) -> torch.Tensor:
        """Force constrained dofs to their values."""
        return torch.where(self.mask, self.values, u)


class ArithDirichletBC(NamedTuple):
    """Dirichlet BC applied by arithmetic blends with a 0/1 mask, the form
    the reference's sweeps use for their per-lane Dirichlet values.

    Same semantics as :class:`DirichletBC` (the mask is 0/1, so the blends
    are exact).  ``mask`` (bool) is kept for the Jacobian row rewrite,
    which depends only on the sparsity, never on the values.

    Lanes: a value of shape (V,) (one per sweep lane) makes ``values``
    (V, N, fields); the blends then act on (V, N, fields) states and the
    Jacobian rewrite on every lane of a lane-batched matrix.
    """

    mask: torch.Tensor    # (N, fields) bool
    maskf: torch.Tensor   # (N, fields) f64 0/1
    values: torch.Tensor  # (N, fields)

    def set_value_arith(self, verts, fld: int, value) -> "ArithDirichletBC":
        """Blend a scalar (a float or a 0-d tensor) onto a vertex set by
        multiply-add with a one-hot mask; a (V,) tensor blends one value
        per lane."""
        onehot = torch.zeros_like(self.maskf)
        onehot[torch.as_tensor(np.asarray(verts), dtype=torch.int64,
                               device=onehot.device), fld] = 1.0
        if isinstance(value, torch.Tensor) and value.dim() == 1:
            value = value[:, None, None]
        vals = self.values * (1.0 - onehot) + value * onehot
        return ArithDirichletBC(self.mask, self.maskf, vals)

    def apply_to_residual(self, r: torch.Tensor,
                          u: torch.Tensor) -> torch.Tensor:
        return r + self.maskf * ((u - self.values) - r)

    def apply_to_jacobian(self, J: BlockELL) -> BlockELL:
        return DirichletBC(self.mask, self.values).apply_to_jacobian(J)

    def project(self, u: torch.Tensor) -> torch.Tensor:
        return u + self.maskf * (self.values - u)
