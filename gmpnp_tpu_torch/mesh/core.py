"""Core mesh data structures.

A mesh is a pair of static arrays (points, cells) plus derived connectivity
computed host-side once and baked into compiled programs as constants — the
TPU-native replacement for dolfin::Mesh + DofMap (the reference relies on
those via every ``Mesh(...)``/``FunctionSpace`` call, e.g.
1D/MPNP_CO2ER_EDL.py:231-306).

Supported cell types: interval (dim 1), triangle (dim 2, for facet work),
tetrahedron (dim 3).  P1 Lagrange nodes coincide with vertices, so the DOF
map for a scalar field is the identity; multi-field layouts use a trailing
field axis (N, n_fields) rather than DOLFIN's interleaved mixed-element
numbering.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class Mesh:
    """Simplicial mesh with static int32 connectivity.

    points : (N, dim) float64 vertex coordinates
    cells  : (C, dim+1) int32 vertex indices per cell
    facets : (F, dim) int32 boundary facet vertices (computed by
             :func:`boundary_facets`; for dim=1 a facet is a single vertex)
    facet_cells : (F,) int32 index of the unique cell owning each facet
    facet_markers : (F,) int32 marker id per boundary facet (0 = unmarked)
    """

    points: np.ndarray
    cells: np.ndarray
    facets: Optional[np.ndarray] = None
    facet_cells: Optional[np.ndarray] = None
    facet_markers: Optional[np.ndarray] = None

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def with_boundary(self) -> "Mesh":
        """Return a copy with boundary facets extracted (markers zeroed)."""
        fac, owner = boundary_facets(self.points, self.cells)
        return replace(
            self,
            facets=fac,
            facet_cells=owner,
            facet_markers=np.zeros(len(fac), dtype=np.int32),
        )

    def with_markers(self, markers: np.ndarray) -> "Mesh":
        assert self.facets is not None
        return replace(self, facet_markers=np.asarray(markers, dtype=np.int32))


# ---------------------------------------------------------------------------
# Connectivity
# ---------------------------------------------------------------------------

def _cell_facets(cells: np.ndarray) -> np.ndarray:
    """All facets of all cells: facet k of a cell is opposite local vertex k.

    Returns (C, dim+1, dim) array of vertex indices (unsorted order preserved
    from the cell)."""
    C, nv = cells.shape
    out = np.empty((C, nv, nv - 1), dtype=cells.dtype)
    for k in range(nv):
        idx = [j for j in range(nv) if j != k]
        out[:, k, :] = cells[:, idx]
    return out


def boundary_facets(
    points: np.ndarray, cells: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract boundary facets (those shared by exactly one cell).

    Returns (facets (F, dim) int32, owning_cell (F,) int32).  Equivalent to
    DOLFIN's exterior-facet iteration used by every ``ds`` integral.
    """
    try:
        from gmpnp_tpu_torch import native
        res = native.boundary_facets(cells)
    except Exception:
        res = None
    if res is not None:
        return res
    C, nv = cells.shape
    all_fac = _cell_facets(cells).reshape(C * nv, nv - 1)
    keys = np.sort(all_fac, axis=1)
    # unique rows appearing exactly once
    order = np.lexsort(keys.T[::-1])
    sk = keys[order]
    if len(sk) == 0:
        return (np.zeros((0, nv - 1), np.int32), np.zeros((0,), np.int32))
    neq_prev = np.ones(len(sk), dtype=bool)
    neq_prev[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    neq_next = np.ones(len(sk), dtype=bool)
    neq_next[:-1] = neq_prev[1:]
    unique_once = neq_prev & neq_next
    sel = order[unique_once]
    facets = all_fac[sel].astype(np.int32)
    owners = (sel // nv).astype(np.int32)
    return facets, owners


def vertex_cell_incidence(
    cells: np.ndarray, num_vertices: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Padded incidence table: for each vertex, the cells touching it.

    Returns (inc_cells (N, K) int32, inc_local (N, K) int32, counts (N,))
    where K = max cells per vertex; padding entries point at cell 0 / local 0
    and must be masked by ``counts``.  This turns scatter-style assembly into
    gather-style (TPU-friendly).
    """
    C, nv = cells.shape
    flat_v = cells.reshape(-1)
    flat_c = np.repeat(np.arange(C, dtype=np.int32), nv)
    flat_l = np.tile(np.arange(nv, dtype=np.int32), C)
    order = np.argsort(flat_v, kind="stable")
    sv, sc, sl = flat_v[order], flat_c[order], flat_l[order]
    counts = np.bincount(sv, minlength=num_vertices).astype(np.int32)
    K = int(counts.max()) if len(counts) else 0
    inc_c = np.zeros((num_vertices, K), dtype=np.int32)
    inc_l = np.zeros((num_vertices, K), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for v in range(num_vertices):
        s, c = starts[v], counts[v]
        inc_c[v, :c] = sc[s:s + c]
        inc_l[v, :c] = sl[s:s + c]
    return inc_c, inc_l, counts


def vertex_adjacency(
    cells: np.ndarray, num_vertices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Padded vertex adjacency (including self, sorted): the sparsity pattern
    of the P1 stiffness/Jacobian.

    Returns (adj (N, D) int32, counts (N,)); padding entries repeat the
    vertex itself (harmless for block-ELL storage: padded blocks stay zero).
    """
    N = num_vertices
    nbrs = [set() for _ in range(N)]
    for cell in cells:
        for a in cell:
            nbrs[a].update(cell.tolist())
    counts = np.array([len(s) for s in nbrs], dtype=np.int32)
    D = int(counts.max()) if N else 0
    adj = np.empty((N, D), dtype=np.int32)
    for v in range(N):
        s = sorted(nbrs[v])
        adj[v, :len(s)] = s
        adj[v, len(s):] = v
    return adj, counts


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

def cell_measures(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Length/area/volume of each cell (positive)."""
    dim = points.shape[1]
    X = points[cells]  # (C, dim+1, dim)
    if dim == 1:
        return np.abs(X[:, 1, 0] - X[:, 0, 0])
    if dim == 2:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        return 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    if dim == 3:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        e3 = X[:, 3] - X[:, 0]
        return np.abs(np.einsum("ci,ci->c", np.cross(e1, e2), e3)) / 6.0
    raise ValueError(f"unsupported dim {dim}")


def facet_measures(points: np.ndarray, facets: np.ndarray) -> np.ndarray:
    """Measure of boundary facets: 1 for points (dim 1), length for edges,
    area for triangles."""
    if facets.shape[1] == 1:
        return np.ones(len(facets))
    X = points[facets]
    if facets.shape[1] == 2:
        return np.linalg.norm(X[:, 1] - X[:, 0], axis=1)
    if facets.shape[1] == 3:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    raise ValueError("unsupported facet type")


def fix_cell_orientation(points: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Reorder cell vertices so signed measures are positive."""
    dim = points.shape[1]
    cells = cells.copy()
    X = points[cells]
    if dim == 1:
        flip = X[:, 1, 0] < X[:, 0, 0]
    elif dim == 3:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        e3 = X[:, 3] - X[:, 0]
        flip = np.einsum("ci,ci->c", np.cross(e1, e2), e3) < 0
    elif dim == 2:
        e1 = X[:, 1] - X[:, 0]
        e2 = X[:, 2] - X[:, 0]
        flip = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) < 0
    else:
        raise ValueError(f"unsupported dim {dim}")
    cells[flip, -2], cells[flip, -1] = (
        cells[flip, -1].copy(), cells[flip, -2].copy())
    return cells


def reorder_by_coordinate(mesh: Mesh, axis: int = 0) -> Tuple[Mesh, np.ndarray]:
    """Renumber vertices ascending along ``axis`` (stable).

    Used for 1D meshes (makes the Jacobian block-tridiagonal) and for z-slab
    domain decomposition of the pore meshes.  Returns (new_mesh, perm) with
    ``new_points = points[perm]``.
    """
    perm = np.argsort(mesh.points[:, axis], kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    new_points = mesh.points[perm]
    new_cells = inv[mesh.cells].astype(np.int32)
    m = Mesh(points=new_points, cells=new_cells).with_boundary()
    return m, perm
