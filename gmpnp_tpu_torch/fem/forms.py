"""Weak-form abstraction.

A :class:`WeakForm` is the model-facing contract replacing UFL + FFC in the
reference stack: instead of symbolic forms compiled to C kernels
(1D/MPNP_CO2ER_EDL.py:412-595 via fenics-ffc), a model supplies plain torch
functions evaluated per quadrature point; ``torch.func.jacfwd`` of the
resulting local residual supplies the consistent element Jacobian.  The
functions run under ``torch.func.vmap``/``jacfwd``: pure tensor code, no
in-place updates, no ``.item()`` and no Python branch on tensor values.

Every first-order weak form used by the reference fits the canonical shape

    F(u; v) = sum_i  \\int_Omega  fval_i(u, grad u) v_i
                     + fgrad_i(u, grad u) . grad v_i  dx
             + sum_{marker m} \\int_{Gamma_m} gval_i^m(u) v_i ds

with fval/fgrad/gval supplied by the model:

- time term       (u_i - u^n_i)/(dt Ld)      -> fval
- reaction        -R_i(u)                    -> fval
- Poisson charge  q sum z_i C0_i u_i         -> fval
- diffusion       grad u_i                   -> fgrad
- migration       z_i u_i grad phi           -> fgrad
- steric          u_i/(1-sum s_j u_j) sum s_j grad u_j -> fgrad
- permittivity    -eps(u) grad phi           -> fgrad
- flux/Robin BCs  J_i, k(u_i - 1)            -> gval on marked facets
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

# signature: (u (fields,), grad_u (fields, dim), u_prev (fields,),
#             x (dim,), theta pytree) -> (fval (fields,), fgrad (fields, dim))
VolumeFn = Callable[..., Any]
# signature: (u (fields,), x (dim,), theta) -> gval (fields,)
BoundaryFn = Callable[..., Any]


class WeakForm:
    """Container coupling a volume integrand with per-marker boundary
    integrands.

    Parameters
    ----------
    n_fields : number of coupled scalar fields.
    volume : VolumeFn, the (fval, fgrad) integrand.
    boundary : mapping facet-marker -> BoundaryFn.  In 1D, DOLFIN's bare
        ``ds`` integrates over *both* endpoints (the Dirichlet row at x=1
        subsequently overwrites that contribution) — models reproduce this by
        registering the same integrand for both endpoint markers.

    ``n_aux`` > 0 declares auxiliary P1 vertex fields (e.g. the SUPG
    stabilization parameters rho_i, which the reference rebuilds per step
    from the previous potential, 1D/MPNP_CO2ER_EDL.py:650-714).  When set,
    the volume signature gains an ``aux`` argument after ``u_prev``:
    ``volume(u, grad_u, u_prev, aux, x, theta)``; aux is interpolated at
    quadrature points like ``u`` but never differentiated.

    ``spec`` (``models.pore_3d.PoreVolumeSpec``, or None) is the object
    whose ``volume`` this is, where a hand-written kernel evaluates the same
    integrand from its constants; ``FemSpace.residual`` then takes the
    kernel on CUDA tensors (``FemSpace.uses_residual_kernel``).
    """

    def __init__(
        self,
        n_fields: int,
        volume: VolumeFn,
        boundary: Optional[Dict[int, BoundaryFn]] = None,
        n_aux: int = 0,
        spec: Any = None,
    ):
        self.n_fields = n_fields
        self.volume = volume
        self.boundary = dict(boundary or {})
        self.n_aux = n_aux
        self.spec = spec
