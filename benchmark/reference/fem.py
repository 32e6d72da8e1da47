"""Plain P1 finite elements in PyTorch: the reference's residual, Jacobian
and damped Newton step.

Nothing here comes from the program. A residual is the backward-Euler weak
form of the model, element by element with every element's quadrature
points at once, summed onto vertices with ``index_add_``:

    r_a = sum_cells vol * sum_q w_q (N_a(q) fval(q) + grad N_a . fgrad(q))
          + boundary fluxes,

with the Dirichlet rows replaced by ``u - value``. The Jacobian is the
forward-mode derivative of each element's residual, summed into a dense
matrix; the Newton step solves it with a dense LU. Both run in the dtype
they are given, which is how the lower-precision control is made.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def quadrature(dim, degree):
    """(points (Q, dim), weights (Q,) summing to 1) of the simplex rule of
    the given degree: Gauss-Legendre on the interval, the 4-point degree-2
    rule on the tetrahedron."""
    if dim == 1:
        n = max(1, math.ceil((degree + 1) / 2))
        x, w = np.polynomial.legendre.leggauss(n)
        return ((x + 1.0) / 2.0).reshape(-1, 1), w / w.sum()
    if dim == 3 and degree == 2:
        a, b = 0.5854101966249685, 0.1381966011250105
        pts = np.array([[b, b, b], [a, b, b], [b, a, b], [b, b, a]])
        return pts, np.full(4, 0.25)
    raise ValueError(f"no reference rule for dim {dim}, degree {degree}")


class P1Space:
    """Element tables of a simplicial mesh, on ``device`` in ``dtype``."""

    def __init__(self, points, cells, quad_degree, device, dtype):
        points = np.asarray(points, np.float64)
        cells = np.asarray(cells, np.int64)
        dim = points.shape[1]
        X = points[cells]
        J = X[:, 1:, :] - X[:, :1, :]
        vol = np.abs(np.linalg.det(J)) / math.factorial(dim)
        gref = np.vstack([-np.ones((1, dim)), np.eye(dim)])
        gradN = np.einsum("ai,cei->cae", gref, np.linalg.inv(J))
        qp, qw = quadrature(dim, quad_degree)
        Nq = np.concatenate([1.0 - qp.sum(axis=1, keepdims=True), qp], 1)
        t = dict(device=device, dtype=dtype)
        self.num_vertices = len(points)
        self.cells = torch.as_tensor(cells, device=device)
        self.vol = torch.as_tensor(vol, **t)
        self.gradN = torch.as_tensor(gradN, **t)
        self.Nq = torch.as_tensor(Nq, **t)
        self.wq = torch.as_tensor(qw, **t)
        self.dtype, self.device = dtype, device

    def element_residual(self, volume, ue, upe, gradN, vol, theta):
        """Residual rows (..., nv, f) of elements whose values are ue."""
        uq = torch.einsum("qa,...af->...qf", self.Nq, ue)
        upq = torch.einsum("qa,...af->...qf", self.Nq, upe)
        gu = torch.einsum("...af,...ad->...fd", ue, gradN)
        fval, fgrad = volume(uq, gu.unsqueeze(-3), upq, theta)
        return vol[..., None, None] * (
            torch.einsum("q,qa,...qf->...af", self.wq, self.Nq, fval)
            + torch.einsum("q,...ad,...qfd->...af", self.wq, gradN, fgrad))

    def residual(self, problem, u, u_prev, theta):
        """The Dirichlet-applied residual (N, f) at u."""
        c = self.cells
        re = self.element_residual(problem.volume, u[c], u_prev[c],
                                   self.gradN, self.vol, theta)
        r = torch.zeros_like(u).index_add_(0, c.reshape(-1),
                                           re.reshape(-1, u.shape[1]))
        r = problem.add_fluxes(r, u, theta)
        mask, values = problem.dirichlet(theta)
        return torch.where(mask, u - values, r)

    def jacobian(self, problem, u, u_prev, theta, chunk=4096):
        """The Dirichlet-applied Jacobian at u as a dense (N f, N f)
        matrix. Boundary fluxes here do not depend on u."""
        from torch.func import jacfwd, vmap

        N, f = u.shape
        c = self.cells
        nv = c.shape[1]
        Jd = torch.zeros((N * f, N * f), dtype=u.dtype, device=u.device)

        def one(ue, upe, g, v):
            return self.element_residual(problem.volume, ue, upe, g, v, theta)

        dofs = (c[:, :, None] * f
                + torch.arange(f, device=c.device)).reshape(len(c), -1)
        for s in range(0, len(c), chunk):
            sl = slice(s, s + chunk)
            je = vmap(jacfwd(one))(u[c[sl]], u_prev[c[sl]], self.gradN[sl],
                                   self.vol[sl])
            je = je.reshape(-1, nv * f, nv * f)
            d = dofs[sl]
            rows = d[:, :, None].expand_as(je).reshape(-1)
            cols = d[:, None, :].expand_as(je).reshape(-1)
            Jd.index_put_((rows, cols), je.reshape(-1), accumulate=True)
        mask, _ = problem.dirichlet(theta)
        m = mask.reshape(-1)
        Jd[m] = 0.0
        idx = torch.nonzero(m).reshape(-1)
        Jd[idx, idx] = 1.0
        return Jd


def l2(r):
    return torch.linalg.vector_norm(r.reshape(-1))


def newton_step(space, problem, u_prev, theta, newton):
    """One damped Newton solve of the step from u_prev, in the space's
    dtype, stopped by the program's rule (||r|| < atol or < rtol ||r0||).
    Returns (u, iterations, converged)."""
    mask, values = problem.dirichlet(theta)
    u = torch.where(mask, values, u_prev)
    r = space.residual(problem, u, u_prev, theta)
    n0 = float(l2(r))
    rn, it = n0, 0

    def done(x):
        return x < newton["atol"] or x < newton["rtol"] * n0

    while it < newton["max_iter"] and not done(rn):
        J = space.jacobian(problem, u, u_prev, theta)
        du = torch.linalg.solve(J, r.reshape(-1)).reshape(u.shape)
        del J
        u = u - newton["relaxation"] * du
        r = space.residual(problem, u, u_prev, theta)
        rn = float(l2(r))
        it += 1
        if not math.isfinite(rn):
            break
    return u, it, done(rn)
