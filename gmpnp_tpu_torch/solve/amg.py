"""Aggregation-based algebraic multigrid preconditioner (the Hypre slot).

Port of ``gmpnp_tpu/solve/amg.py``: plain aggregation, Galerkin coarse
operators and a V-cycle with damped block-Jacobi smoothing, in the style of
Notay's AGMG.

- ALL sparsity structure is computed ONCE per mesh on the host
  (:class:`AMGPlan`, numpy, the reference's code): greedy vertex
  aggregation per level, the coarse block-ELL adjacency it induces, and a
  flat table mapping every fine block (row, slot) to its coarse
  destination.
- Per-matrix VALUES (:func:`amg_prepare`): the Galerkin product RAP with
  piecewise-constant aggregation is one segment sum of the fine blocks
  per level.  On the card it must give the same bits on every call (GMRES
  iteration counts depend on it), so it is a gather of each segment's
  members in sorted order, padded with a zero block, and a sum over them —
  no atomics (``segment_table`` builds the padded member lists on the host
  once per matrix).  The restriction in the cycle is the same operation
  over vertices.
- The cycle (:func:`amg_vcycle`): damped block-Jacobi smoothing, every
  fine- and coarse-level matvec through ``BlockELL.matvec`` (the block-ELL
  kernel on CUDA tensors), piecewise-constant restriction / prolongation
  (gather), and a dense factorized coarsest solve in f32
  (``torch.linalg.lu_factor`` / ``lu_solve``).  The f32 coarsest solve is
  the reference's (XLA:TPU has no f64 LU) and changes numbers, so it is
  kept for parity; it is to be retired only on an H100 measurement with
  parity held.

Used as ``LinearConfig(kind='gmres'|'bicgstab', precond='amg')``.  The
same functions serve the V lanes of a batched sweep (one lane-batched
BlockELL, r (V, N, f)): one plan for every lane (the aggregation depends
only on the mesh), its segment tables built once per matrix and shared by
the lanes, every level's matvecs and smoothing one batched call over the
lanes, its segment sums and the coarsest LU and solve one call per lane
(``smallblock.lane_by_lane``).  The preconditioner builds run in
``linear.factor`` spans (``utils.profiling``).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL
from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned
from gmpnp_tpu_torch.solve.smallblock import block_inv, block_mv, lane_by_lane
from gmpnp_tpu_torch.utils.profiling import span


def aggregate_vertices(adj: np.ndarray) -> Tuple[np.ndarray, int]:
    """Greedy root aggregation of a padded adjacency graph.

    Pass 1 sweeps vertices in order; a vertex whose whole neighborhood is
    unaggregated becomes the root of a new aggregate containing that
    neighborhood.  Pass 2 attaches each leftover vertex to the aggregate
    most represented among its neighbors.  Returns ((N,) int32 aggregate
    ids, n_aggregates).  Aggregates are vertex-connected by construction,
    diameter <= 4 — the standard plain-aggregation coarsening (coarsening
    ratio ~ 2**dim .. 3**dim on P1 meshes).
    """
    N, _ = adj.shape
    agg = np.full(N, -1, dtype=np.int32)
    nagg = 0
    for v in range(N):
        if agg[v] != -1:
            continue
        nbrs = np.unique(adj[v])
        if (agg[nbrs] == -1).all():
            agg[nbrs] = nagg
            nagg += 1
    for v in range(N):
        if agg[v] != -1:
            continue
        cand = agg[np.unique(adj[v])]
        cand = cand[cand >= 0]
        if len(cand):
            agg[v] = np.bincount(cand).argmax()
        else:                                   # isolated vertex
            agg[v] = nagg
            nagg += 1
    return agg, nagg


def _coarse_graph(adj: np.ndarray, agg: np.ndarray, nagg: int):
    """Coarse padded adjacency induced by aggregation.

    Returns (coarse_adj (Nc, Kc) int32 sorted rows padded with the row
    id, coarse_diag_slot (Nc,) int32, scatter (N*K,) int32 mapping each
    fine block slot to its flat coarse destination row*Kc + slot).
    """
    N, K = adj.shape
    rows = agg[np.repeat(np.arange(N), K)]
    cols = agg[adj.reshape(-1)]
    neighbors = [set() for _ in range(nagg)]
    for a, b in zip(rows, cols):
        neighbors[a].add(b)
    for a in range(nagg):
        neighbors[a].add(a)
    Kc = max(len(s) for s in neighbors)
    coarse_adj = np.empty((nagg, Kc), dtype=np.int32)
    for a in range(nagg):
        lst = sorted(neighbors[a])
        # pad with the row id; pad slots receive zero blocks (nothing
        # scatters to them beyond genuine (a, a) edges at the diag slot)
        coarse_adj[a] = np.pad(lst, (0, Kc - len(lst)),
                               constant_values=a)[:Kc]
    coarse_diag_slot = np.argmax(
        coarse_adj == np.arange(nagg)[:, None], axis=1).astype(np.int32)
    # position of each coarse column within its row (rows are sorted over
    # the genuine prefix; searchsorted per row)
    slot = np.empty(N * K, dtype=np.int32)
    for i, (a, b) in enumerate(zip(rows, cols)):
        slot[i] = int(np.searchsorted(coarse_adj[a], b))
    scatter = rows.astype(np.int64) * Kc + slot
    return coarse_adj, coarse_diag_slot, scatter.astype(np.int32)


def segment_table(dest: np.ndarray, n_seg: int) -> np.ndarray:
    """(n_seg, L) int64 table of the members of each segment of ``dest``,
    in ascending source order, padded with len(dest) (a zero row appended
    by :func:`segment_sum`); L is the largest segment."""
    dest = np.asarray(dest).reshape(-1)
    order = np.argsort(dest, kind="stable")
    counts = np.bincount(dest, minlength=n_seg)
    L = max(int(counts.max()) if len(counts) else 0, 1)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(dest)) - np.repeat(start, counts)
    table = np.full((n_seg, L), len(dest), dtype=np.int64)
    table[dest[order], pos] = order
    return table


def segment_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """values (M, ...) -> (n_seg, ...): each segment's members gathered by
    ``table`` (see :func:`segment_table`) and summed, the same order on
    every call."""
    zero = torch.zeros((1,) + tuple(values.shape[1:]), dtype=values.dtype,
                       device=values.device)
    return torch.cat([values, zero])[table].sum(dim=1)


class AMGLevelPlan(NamedTuple):
    """Host-built static structure of one coarsening step."""
    agg: np.ndarray             # (N,) fine-vertex -> coarse-vertex
    nagg: int
    scatter: np.ndarray         # (N*K,) flat coarse block destination
    coarse_adj: np.ndarray      # (Nc, Kc)
    coarse_diag_slot: np.ndarray


class AMGPlan(NamedTuple):
    levels: Tuple[AMGLevelPlan, ...]

    @staticmethod
    def build(adj: np.ndarray, n_fields: int,
              coarsest_dofs: int = 600, max_levels: int = 10) -> "AMGPlan":
        """Coarsen the vertex graph until the coarsest dense system is
        below ``coarsest_dofs`` unknowns (n_fields per coarse vertex)."""
        adj = np.asarray(adj)
        levels = []
        while (len(levels) < max_levels
               and adj.shape[0] * n_fields > coarsest_dofs):
            agg, nagg = aggregate_vertices(adj)
            if nagg >= adj.shape[0]:            # no progress (tiny graph)
                break
            coarse_adj, cds, scatter = _coarse_graph(adj, agg, nagg)
            levels.append(AMGLevelPlan(agg=agg, nagg=nagg, scatter=scatter,
                                       coarse_adj=coarse_adj,
                                       coarse_diag_slot=cds))
            adj = coarse_adj
        return AMGPlan(levels=tuple(levels))


def galerkin_coarse(ell: BlockELL, lvl: AMGLevelPlan) -> BlockELL:
    """A_c = P^T A P for piecewise-constant P: every fine block A[v, k]
    lands whole on coarse block (agg[v], agg[adj[v, k]]) — one segment
    sum.  Padded fine slots hold zero blocks and sum benignly into coarse
    diagonals.  Over lanes the segment sums run lane by lane (a sum over
    the V lanes' members at once rounds otherwise on the card), from one
    table."""
    N, K, f, _ = ell.shape4
    lead = ell.flat.shape[:-3]
    Nc = lvl.nagg
    Kc = lvl.coarse_adj.shape[1]
    dev = ell.flat.device
    table = torch.as_tensor(segment_table(lvl.scatter, Nc * Kc),
                            dtype=torch.int64, device=dev)
    blocks = ell.flat.reshape(*lead, N, f, K, f).transpose(-3, -2)
    coarse = lane_by_lane(partial(segment_sum, table=table), bool(lead),
                          blocks.reshape(*lead, N * K, f * f))
    flat = coarse.reshape(*lead, Nc, Kc, f, f).transpose(-3, -2).reshape(
        *lead, Nc, f, Kc * f)
    return BlockELL(
        torch.as_tensor(lvl.coarse_adj, dtype=torch.int32, device=dev),
        flat,
        torch.as_tensor(lvl.coarse_diag_slot, dtype=torch.int64, device=dev))


class AMGLevelValues(NamedTuple):
    ell: BlockELL
    Dinv: torch.Tensor          # (N, f, f) inverse diagonal blocks
    agg: torch.Tensor           # (N,) prolongation gather, on the device
    restrict: torch.Tensor      # restriction segment table (segment_table)


class AMGValues(NamedTuple):
    levels: Tuple[AMGLevelValues, ...]
    # f32 (lu, pivots) of the bottom; over lanes a tuple of the lanes'
    coarsest_lu: tuple


def amg_prepare(ell: BlockELL, plan: AMGPlan) -> AMGValues:
    """Compute the level values for one matrix: Galerkin coarse operators
    (one segment sum per level), block-diagonal inverses, and the f32 LU
    of the coarsest dense system.  Over lanes every level's values gain
    the lane axis and ``coarsest_lu`` holds each lane's (lu, pivots),
    factored lane by lane (a batched f32 LU pivots and rounds otherwise on
    the card); the aggregation tables are the plan's, on the device once
    for all lanes."""
    levels = []
    cur = ell
    i64 = dict(dtype=torch.int64, device=ell.flat.device)
    for lvl in plan.levels:
        levels.append(AMGLevelValues(
            ell=cur, Dinv=block_inv(cur.diag_blocks()),
            agg=torch.as_tensor(lvl.agg, **i64),
            restrict=torch.as_tensor(segment_table(lvl.agg, lvl.nagg),
                                     **i64)))
        cur = galerkin_coarse(cur, lvl)
        if cur.lanes:
            cur = BlockELL(cur.adj, lane_aligned(cur.flat), cur.diag_slot)
    dense = cur.to_dense().to(torch.float32)
    return AMGValues(levels=tuple(levels), coarsest_lu=lane_by_lane(
        torch.linalg.lu_factor, bool(ell.lanes), dense))


def _smooth(ell: BlockELL, Dinv, r, z, omega, sweeps):
    """Damped block-Jacobi: z <- z + omega * Dinv (r - A z)."""
    for i in range(sweeps):
        resid = r if z is None else r - ell.matvec(z)
        upd = omega * block_mv(Dinv, resid)
        z = upd if z is None else z + upd
    return z


def _coarsest_solve(lu_piv, b):
    lu, piv = lu_piv
    return torch.linalg.lu_solve(lu, piv, b.reshape(-1, 1).to(torch.float32))


def amg_vcycle(vals: AMGValues, plan: AMGPlan, r: torch.Tensor,
               omega: float = 0.67, pre: int = 1, post: int = 1
               ) -> torch.Tensor:
    """One V(pre, post)-cycle applied to residual r; returns z ~ A^{-1} r.
    Over lanes (r (V, N, f)) the restrictions and the coarsest solve run
    lane by lane."""
    lanes = r.dim() == 3

    def cyc(i, r_i):
        if i == len(plan.levels):
            x = lane_by_lane(_coarsest_solve, lanes, vals.coarsest_lu, r_i)
            return x.to(r_i.dtype).reshape(r_i.shape)
        lv = vals.levels[i]
        z = _smooth(lv.ell, lv.Dinv, r_i, None, omega, pre)
        r_c = lane_by_lane(partial(segment_sum, table=lv.restrict), lanes,
                           r_i - lv.ell.matvec(z))
        z = z + cyc(i + 1, r_c)[..., lv.agg, :]
        return _smooth(lv.ell, lv.Dinv, r_i, z, omega, post)

    return cyc(0, r)


@span("linear.factor")
def amg_preconditioner(ell: BlockELL, plan: AMGPlan,
                       omega: float = 0.67, pre: int = 1, post: int = 1
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """M^{-1} z = one V-cycle on the given matrix; z, out: (N, f), or
    (V, N, f) of a lane-batched BlockELL.

    Same call contract as :func:`solve.linear.block_jacobi_preconditioner`.
    """
    vals = amg_prepare(ell, plan)

    def apply(r):
        return amg_vcycle(vals, plan, r, omega=omega, pre=pre, post=post)

    return apply
