"""P1 Lagrange reference elements and simplex quadrature.

Replaces FIAT tabulation (environment.yml:22-27 in the reference stack).
Only degree-1 simplices are needed: the reference uses P1 interval elements
(1D/MPNP_CO2ER_EDL.py:301-303) and P1 tetrahedra (3D/MPNP_CO2ER_pore.py:405-408).

Reference-domain conventions (barycentric-style):
- interval: vertices at x=0,1;      N = [1-x, x]
- triangle: vertices (0,0),(1,0),(0,1);  N = [1-x-y, x, y]
- tet:      vertices (0,0,0),e1,e2,e3;   N = [1-x-y-z, x, y, z]

Quadrature weights are normalized to sum to 1 (multiply by the physical cell
measure during assembly).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class QuadratureRule:
    """points (Q, dim) on the reference simplex; weights (Q,) summing to 1;
    shape (Q, nodes): P1 shape functions tabulated at the points."""

    points: np.ndarray
    weights: np.ndarray
    shape: np.ndarray
    degree: int

    @property
    def num_points(self) -> int:
        return len(self.weights)


def p1_shape(points: np.ndarray, dim: int) -> np.ndarray:
    """Tabulate P1 shape functions at reference points (Q, dim) -> (Q, dim+1)."""
    pts = np.atleast_2d(points)
    first = 1.0 - pts.sum(axis=1, keepdims=True)
    return np.concatenate([first, pts], axis=1)


def p1_grad_reference(dim: int) -> np.ndarray:
    """Constant reference gradients dN/dxi, shape (dim+1, dim)."""
    g = np.zeros((dim + 1, dim))
    g[0, :] = -1.0
    g[1:, :] = np.eye(dim)
    return g


def _gauss_legendre_01(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0,1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def simplex_quadrature(dim: int, degree: int) -> QuadratureRule:
    """Quadrature exact to (at least) the requested polynomial degree.

    All rules except the degree>=3 tetrahedron rules have positive weights;
    the Keast 5-point degree-3 tet rule carries the classic negative centroid
    weight (flagged in its docline) — callers integrating non-polynomial
    (steric) terms may prefer degree 2 or 4.
    """
    if dim == 1:
        n = max(1, math.ceil((degree + 1) / 2))
        x, w = _gauss_legendre_01(n)
        pts = x.reshape(-1, 1)
    elif dim == 2:
        if degree <= 1:
            pts = np.array([[1 / 3, 1 / 3]])
            w = np.array([1.0])
        elif degree == 2:
            pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
            w = np.full(3, 1 / 3)
        else:  # degree 3-4: 6-point positive rule (Dunavant deg 4)
            a1, a2 = 0.445948490915965, 0.091576213509771
            w1, w2 = 0.223381589678011, 0.109951743655322
            pts = np.array([
                [a1, a1], [1 - 2 * a1, a1], [a1, 1 - 2 * a1],
                [a2, a2], [1 - 2 * a2, a2], [a2, 1 - 2 * a2],
            ])
            w = np.array([w1, w1, w1, w2, w2, w2])
    elif dim == 3:
        if degree <= 1:
            pts = np.array([[0.25, 0.25, 0.25]])
            w = np.array([1.0])
        elif degree == 2:
            a = 0.5854101966249685
            b = 0.1381966011250105
            pts = np.array([
                [b, b, b], [a, b, b], [b, a, b], [b, b, a]])
            w = np.full(4, 0.25)
        elif degree == 3:
            # Keast 5-point, degree 3 (negative centroid weight)
            pts = np.array([
                [0.25, 0.25, 0.25],
                [1 / 2, 1 / 6, 1 / 6], [1 / 6, 1 / 2, 1 / 6],
                [1 / 6, 1 / 6, 1 / 2], [1 / 6, 1 / 6, 1 / 6]])
            w = np.array([-0.8, 0.45, 0.45, 0.45, 0.45])
        else:
            # Keast 11-point, degree 4
            a = 0.7857142857142857
            b = 0.0714285714285714
            c = 0.3994035761667992
            d = 0.1005964238332008
            pts = np.array([
                [0.25, 0.25, 0.25],
                [a, b, b], [b, a, b], [b, b, a], [b, b, b],
                [c, c, d], [c, d, c], [d, c, c],
                [d, d, c], [d, c, d], [c, d, d]])
            w = np.array([-0.0789333333333333]
                         + [0.0457333333333333] * 4
                         + [0.1493333333333333] * 6)
    else:
        raise ValueError(f"unsupported dim {dim}")

    w = w / w.sum()
    return QuadratureRule(
        points=pts, weights=w, shape=p1_shape(pts, dim), degree=degree)


def physical_gradients(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Physical shape-function gradients per cell: (C, dim+1, dim).

    For affine P1 simplices, grad N_a is constant on the cell:
    grad N = J^{-T} dN/dxi with J the affine map Jacobian."""
    dim = points.shape[1]
    X = points[cells]                       # (C, dim+1, dim)
    J = X[:, 1:, :] - X[:, :1, :]           # (C, dim, dim), rows = edge vecs
    Jinv = np.linalg.inv(J)                 # (C, dim, dim)
    gref = p1_grad_reference(dim)           # (dim+1, dim)
    # x = x0 + xi . J (row convention) => dxi_i/dx_e = (J^{-1})[e, i], so
    # grad_x N_a[e] = sum_i gref[a, i] * Jinv[e, i]
    return np.einsum("ai,cei->cae", gref, Jinv)
