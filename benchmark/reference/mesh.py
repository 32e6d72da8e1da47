"""Frozen copies of the two mesh generators the benchmark's models use.

The reference derives its meshes here, from the configuration's sizes, and
never from the program: the vertex numbering must equal the program's (its
states are compared vertex by vertex), so the generators are copied as
they were when the benchmark was written and are not to follow later
changes to the program's own.

- ``cylinder``: the structured tetrahedral pore (x, y in the disc of radius
  R/L, z in [0, 1]): a hex-pattern disc, its Delaunay triangulation,
  extruded in layers, each prism split into three tets.
- ``graded_interval``: the 1D two-zone grading (1,000 cells of 0.1 nm over
  the first 100 nm, then uniform 10 nm cells, 50 nm above 50 um).

Boundary vertex sets are found from coordinates (``near``), the rule the
model scripts use for their markers.
"""

from __future__ import annotations

import math

import numpy as np

FINE_CELLS = 1000
FINE_WIDTH_M = 100.0e-9
COARSE_DX_M = 10.0e-9
COARSE_DX_LARGE_M = 50.0e-9


def _disc_points(radius, n_rings):
    pts = [(0.0, 0.0)]
    for j in range(1, n_rings + 1):
        r = radius * j / n_rings
        m = 6 * j
        for i in range(m):
            th = 2.0 * math.pi * i / m
            pts.append((r * math.cos(th), r * math.sin(th)))
    return np.asarray(pts, dtype=np.float64)


def _split_prism(a, b, c, a2, b2, c2):
    verts = [(a, a2), (b, b2), (c, c2)]
    k = min(range(3), key=lambda i: verts[i][0])
    (a, a2), (b, b2), (c, c2) = verts[k:] + verts[:k]
    if b < c:
        return [(a, b, c, c2), (a, b, c2, b2), (a, b2, c2, a2)]
    return [(a, b, c, b2), (a, b2, c, c2), (a, b2, c2, a2)]


def cylinder(L, R, n_rings=None, n_layers=None):
    """(points (N, 3), cells (C, 4)) of the pore of length L, radius R."""
    from scipy.spatial import Delaunay

    aspect = R / L
    target_h = max(aspect / 4.0, 1.0 / 64.0)
    if n_rings is None:
        n_rings = max(2, int(round(aspect / target_h)))
    if n_layers is None:
        n_layers = max(4, int(round(1.0 / target_h)))
    disc = _disc_points(aspect, n_rings)
    tris = Delaunay(disc).simplices.astype(np.int64)
    nd = len(disc)
    zs = np.linspace(0.0, 1.0, n_layers + 1)
    pts = np.empty((nd * (n_layers + 1), 3), dtype=np.float64)
    for k, z in enumerate(zs):
        pts[k * nd:(k + 1) * nd, :2] = disc
        pts[k * nd:(k + 1) * nd, 2] = z
    tets = []
    for k in range(n_layers):
        lo, hi = k * nd, (k + 1) * nd
        for a, b, c in tris:
            tets.extend(_split_prism(lo + a, lo + b, lo + c,
                                     hi + a, hi + b, hi + c))
    return pts, np.asarray(tets, dtype=np.int64)


def graded_interval(L_n):
    """(points (N, 1), cells (N-1, 2)) of the graded unit interval."""
    coarse_dx = COARSE_DX_LARGE_M if L_n * 1.0e6 > 50 else COARSE_DX_M
    brk = FINE_WIDTH_M / L_n
    n_coarse = int(round((L_n - FINE_WIDTH_M) / coarse_dx))
    xs = np.concatenate([np.linspace(0.0, brk, FINE_CELLS + 1),
                         np.linspace(brk, 1.0, n_coarse + 1)[1:]])
    n = len(xs) - 1
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return xs.reshape(-1, 1), cells


def near(x, x0, tol):
    return np.abs(x - x0) <= tol


def pore_vertex_sets(points, L, R):
    """Entry (z=0), wall and exit (z=1) vertex sets of the pore."""
    aspect = R / L
    wall_tol = 5.0e-3 if (R in (5.0e-9, 50.0e-9) and L == 10.0e-9) else 1e-3
    z = points[:, 2]
    r2 = points[:, 0] ** 2 + points[:, 1] ** 2
    return {"entry": np.nonzero(near(z, 0.0, 1e-12))[0],
            "wall": np.nonzero(near(r2, aspect ** 2, wall_tol))[0],
            "exit": np.nonzero(near(z, 1.0, 1e-12))[0]}
