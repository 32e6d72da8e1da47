"""Global assembly: residual vectors and block-ELL Jacobians.

Replaces the dolfin::Assembler element loop + PETSc matrix scatter
(SURVEY.md §2b).  All connectivity/geometry tables are precomputed host-side
in numpy — the same tables as ``gmpnp_tpu.fem.assembly`` — and copied once
to the space's device; the per-element work is torch, vmapped over
elements, with the element Jacobian obtained by ``torch.func.jacfwd`` of the
local residual.

Sparse storage is block-ELL ("padded CSR"): per mesh vertex a fixed-width,
sorted neighbor list (padded with self-loops) and per neighbor an
(n_fields x n_fields) dense block.  Every shape is static, and the matvec is
one pass of the hand-written kernel in ``ops.ell_spmv``.

On CUDA tensors the volume residual of a form that carries a spec (the
3D pore's ``models.pore_3d.PoreVolumeSpec``) is one hand-written kernel
(``ops.pore_residual``, ``FemSpace.uses_residual_kernel``); the Jacobian
keeps ``jacfwd`` of the torch integrand, and the element loop
(``element_volume_residual``) serves every other residual.

``FemSpace.residual`` and ``residual_lanes`` run in ``assembly.residual``
spans, ``jacobian`` and ``jacobian_lanes`` in ``assembly.jacobian`` spans
(``utils.profiling``; a lane call holds its vmapped single-lane one).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from gmpnp_tpu_torch.fem.elements import (
    physical_gradients,
    simplex_quadrature,
)
from gmpnp_tpu_torch.fem.forms import WeakForm
from gmpnp_tpu_torch.mesh.core import (
    Mesh,
    cell_measures,
    facet_measures,
    vertex_adjacency,
)
from gmpnp_tpu_torch.ops.pore_residual import pore_residual
from gmpnp_tpu_torch.ops.segment_sum import segment_sum_op
from gmpnp_tpu_torch.utils.profiling import span


class BlockELL(NamedTuple):
    """Block sparse matrix in ELL format.

    adj : (N, K) int32 neighbor ids (sorted, padded with the row vertex)
    flat : (N, f, K*f) float: flat[n, r, k*f + c] = block[n, k][r, c] — the
        layout the matvec kernel reads directly
    diag_slot : (N,) int64 position of the diagonal block within each row

    Lanes: ``flat`` (V, N, f, K*f) holds V matrices of one sparsity (the
    lanes of a batched sweep, ``adj`` and ``diag_slot`` shared); ``matvec``,
    ``diag_blocks`` and ``scale_rows`` then take and give a leading lane
    axis.
    """

    adj: torch.Tensor
    flat: torch.Tensor
    diag_slot: torch.Tensor

    @property
    def lanes(self):
        """V for a lane-batched matrix, else None."""
        return self.flat.shape[0] if self.flat.dim() == 4 else None

    @property
    def n_fields(self) -> int:
        return self.flat.shape[-2]

    @property
    def K(self) -> int:
        return self.flat.shape[-1] // self.flat.shape[-2]

    @property
    def shape4(self):
        N, f, Kf = self.flat.shape[-3:]
        return (N, Kf // f, f, f)

    @staticmethod
    def from_blocks(adj, blocks4, diag_slot) -> "BlockELL":
        """Build from (N, K, f, f) block layout (tests / interop)."""
        N, K, f, _ = blocks4.shape
        flat = blocks4.transpose(1, 2).reshape(N, f, K * f)
        return BlockELL(adj=adj, flat=flat, diag_slot=diag_slot)

    def blocks4(self) -> torch.Tensor:
        """(N, K, f, f) copy of the blocks."""
        N, f, Kf = self.flat.shape
        K = Kf // f
        return self.flat.reshape(N, f, K, f).transpose(1, 2)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y[n] = sum_k block[n,k] @ x[adj[n,k]];  x, y: (N, f) ((V, N, f)
        over lanes, one launch).  The CUDA kernel on CUDA tensors, its plain
        version on CPU tensors."""
        from gmpnp_tpu_torch.ops.ell_spmv import ell_spmv

        return ell_spmv(self.flat, self.adj, x.contiguous())

    def diag_blocks(self) -> torch.Tensor:
        """(N, f, f) diagonal blocks ((V, N, f, f) over lanes)."""
        if self.flat.dim() == 4:
            V, N, f, Kf = self.flat.shape
            idx = (self.diag_slot[:, None, None] * f
                   + torch.arange(f, device=self.flat.device)[None, None, :])
            return torch.gather(self.flat, 3, idx.expand(V, N, f, f))
        N, f, Kf = self.flat.shape
        idx = (self.diag_slot[:, None, None] * f
               + torch.arange(f, device=self.flat.device)[None, None, :])
        return torch.gather(self.flat, 2, idx.expand(N, f, f))

    def scale_rows(self, Dinv: torch.Tensor) -> "BlockELL":
        """Left-multiply every block row by (N, f, f) matrices (block-row
        equilibration): new[n, r, :] = sum_s Dinv[n, r, s] flat[n, s, :]
        (per lane over lanes: Dinv (V, N, f, f))."""
        if self.flat.dim() == 4:
            flat = torch.einsum("vnrs,vnsk->vnrk", Dinv, self.flat)
            return BlockELL(adj=self.adj, flat=flat,
                            diag_slot=self.diag_slot)
        flat = torch.einsum("nrs,nsk->nrk", Dinv, self.flat)
        return BlockELL(adj=self.adj, flat=flat, diag_slot=self.diag_slot)

    def to_dense(self) -> torch.Tensor:
        """(N*f, N*f) dense matrix ((V, N*f, N*f) over lanes) — tests /
        small direct solves only.  Slot k's blocks land on distinct (row,
        column) pairs, so the K slots are added one after another in slot
        order (a padded slot adds its zero block to the diagonal): no
        atomic sum, the same bits on every run."""
        N, K, f, _ = self.shape4
        lead = tuple(self.flat.shape[:-3])
        dev = self.flat.device
        rows = torch.arange(N, device=dev)
        adj = self.adj.long()
        blocks = self.flat.reshape(lead + (N, f, K, f))
        dense = torch.zeros(lead + (N, N, f, f), dtype=self.flat.dtype,
                            device=dev)
        for k in range(K):
            dense[..., rows, adj[:, k], :, :] += blocks[..., k, :]
        return dense.transpose(-3, -2).reshape(lead + (N * f, N * f))


def split_lane_theta(theta):
    """A lane theta (the per-step ``theta`` of V sweep lanes: a dict whose
    values are shared Python scalars or (V,) / (V, ...) tensors, one entry
    per lane) -> (shared dict, dict of lane tensors)."""
    theta = theta or {}
    shared = {k: v for k, v in theta.items()
              if not isinstance(v, torch.Tensor)}
    lane = {k: v for k, v in theta.items() if isinstance(v, torch.Tensor)}
    return shared, lane


def _facet_tables(mesh: Mesh, quad_deg: int):
    """Per-marker facet tables: (nodes, measures, shape, weights, xq)."""
    assert mesh.facets is not None
    dim = mesh.dim
    fdim = dim - 1
    out: Dict[int, dict] = {}
    markers = np.unique(mesh.facet_markers)
    if fdim == 0:
        shape = np.ones((1, 1))
        w = np.ones(1)
        pts = np.zeros((1, 0))
    else:
        rule = simplex_quadrature(fdim, quad_deg)
        shape, w, pts = rule.shape, rule.weights, rule.points
    for m in markers:
        sel = mesh.facet_markers == m
        fnodes = mesh.facets[sel]
        fmeas = facet_measures(mesh.points, fnodes)
        X = mesh.points[fnodes]  # (F, fnv, dim)
        xq = np.einsum("qa,fad->fqd", shape, X)
        out[int(m)] = dict(
            nodes=fnodes.astype(np.int32),
            meas=fmeas,
            shape=shape,
            weights=w,
            xq=xq,
        )
    return out


def _sorted_segment_tables(dest: np.ndarray, n_dest: int):
    """Host-side tables for the gather/cumsum segment reduction.

    Returns (order, start, end) int32 such that segment i's values are
    ``values[order[start[i]:end[i]]]``.
    """
    dest = np.asarray(dest).reshape(-1)
    order = np.argsort(dest, kind="stable")
    sorted_dest = dest[order]
    idx = np.arange(n_dest)
    start = np.searchsorted(sorted_dest, idx, side="left")
    end = np.searchsorted(sorted_dest, idx, side="right")
    return (order.astype(np.int32), start.astype(np.int32),
            end.astype(np.int32))


def _segment_reduce(values: torch.Tensor, order, start, end) -> torch.Tensor:
    """values (M, d) -> (n_dest, d): per-segment sums in sorted order
    (``ops.segment_sum``: the hand-written kernel on CUDA tensors, the
    reference's sorted gather + cumulative sum + prefix difference on CPU
    tensors; under ``vmap`` one call over the lanes).  Segments with
    start == end yield exact zeros."""
    return segment_sum_op(values.contiguous(), order, start, end)


def _slot_table(cells: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """slot[c, a, b] = index of cells[c,b] within adj[cells[c,a]]."""
    C, nv = cells.shape
    rows = cells[:, :, None].repeat(nv, axis=2)      # (C, nv, nv)
    cols = cells[:, None, :].repeat(nv, axis=1)      # (C, nv, nv)
    row_adj = adj[rows]                              # (C, nv, nv, K)
    slot = np.argmax(row_adj == cols[..., None], axis=-1)
    assert (np.take_along_axis(row_adj, slot[..., None], -1)[..., 0]
            == cols).all(), "adjacency table missing an entry"
    return slot.astype(np.int32)


def _node_slot(nodes: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """slot[i, a, b] for facet node tuples (same as _slot_table)."""
    return _slot_table(nodes, adj)


class _EvaluateIn(TorchFunctionMode):
    """Runs every torch call with its float64 tensor arguments (and a
    ``dtype=torch.float64`` keyword) cast to ``dtype``: a form's float64
    closure constants then take part in the arithmetic in ``dtype``, as
    the reference's forms do when traced with x64 disabled."""

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def cast(a):
            if isinstance(a, torch.Tensor) and a.dtype == torch.float64:
                return a.to(self.dtype)
            return self.dtype if a is torch.float64 else a

        return func(*tree_map(cast, args), **tree_map(cast, kwargs or {}))


def _device_tables(space: "FemSpace") -> dict:
    """Device copies of the tables the per-step work reads."""
    dev = torch.device(space.device)
    f64 = dict(dtype=torch.float64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    t = {
        "cells": torch.as_tensor(space.cells, **i64),
        "vols": torch.as_tensor(space.vols, **f64),
        "gradN": torch.as_tensor(space.gradN, **f64),
        "Nq": torch.as_tensor(space.Nq, **f64),
        "wq": torch.as_tensor(space.wq, **f64),
        "xq": torch.as_tensor(space.xq, **f64),
        "adj": torch.as_tensor(space.adj, dtype=torch.int32, device=dev),
        "diag_slot": torch.as_tensor(space.diag_slot, **i64),
        "res_tables": tuple(torch.as_tensor(a, **i64)
                            for a in space.res_tables),
        "jac_tables": tuple(torch.as_tensor(a, **i64)
                            for a in space.jac_tables),
        "facets": {},
    }
    for m, tab in space.facet_tabs:
        t["facets"][m] = {
            "nodes": torch.as_tensor(tab["nodes"], **i64),
            "meas": torch.as_tensor(tab["meas"], **f64),
            "shape": torch.as_tensor(tab["shape"], **f64),
            "weights": torch.as_tensor(tab["weights"], **f64),
            "xq": torch.as_tensor(tab["xq"], **f64),
            "jac_tables": tuple(torch.as_tensor(a, **i64)
                                for a in tab["jac_tables"]),
            "res_tables": tuple(torch.as_tensor(a, **i64)
                                for a in tab["res_tables"]),
        }
    return t


def element_volume_residual(volume, u_e, u_prev_e, gradN_c, vol_c, Nq, wq,
                            xq_c, theta, aux_e=None):
    """Element residual (nv, fields) of one P1 element: ``volume`` (a
    ``WeakForm.volume``, with an ``aux`` argument where ``aux_e`` is
    given) at the quadrature points (Nq (Q, nv), wq (Q,), xq_c (Q, dim) or
    None), fval tested with N_a and fgrad with grad N_a."""
    # grad u (fields, dim): constant over the P1 element
    grad_u = torch.einsum("af,ad->fd", u_e, gradN_c)

    def at_q(Nq_q, x_q):
        u_q = Nq_q @ u_e           # (fields,)
        up_q = Nq_q @ u_prev_e
        if aux_e is not None:
            aux_q = Nq_q @ aux_e
            fval, fgrad = volume(u_q, grad_u, up_q, aux_q, x_q, theta)
        else:
            fval, fgrad = volume(u_q, grad_u, up_q, x_q, theta)
        # (nv, fields): fval tested with N_a, fgrad with grad N_a
        return (torch.outer(Nq_q, fval)
                + torch.einsum("ad,fd->af", gradN_c, fgrad))

    contrib = vmap(at_q, in_dims=(0, None if xq_c is None else 0))(
        Nq, xq_c)                                       # (Q, nv, fields)
    return vol_c * torch.einsum("q,qaf->af", wq, contrib)

@dataclass(frozen=True)
class FemSpace:
    """Precomputed multi-field P1 space over a mesh.

    The numpy tables are identical to ``gmpnp_tpu.fem.FemSpace``'s;
    ``dev`` holds their device copies on ``device``.
    """

    n_fields: int
    num_vertices: int
    dim: int
    cells: np.ndarray           # (C, nv)
    vols: np.ndarray            # (C,)
    gradN: np.ndarray           # (C, nv, dim)
    Nq: np.ndarray              # (Q, nv)
    wq: np.ndarray              # (Q,)
    xq: np.ndarray              # (C, Q, dim)
    adj: np.ndarray             # (N, K)
    diag_slot: np.ndarray       # (N,)
    slot: np.ndarray            # (C, nv, nv)
    facet_tabs: tuple           # ((marker, dict), ...) static ordering
    points: np.ndarray          # (N, dim) vertex coords
    colors: np.ndarray = None   # (N,) greedy vertex coloring (host-side)
    # sorted-segment tables (host-side int32) for scatter-free assembly:
    # volume residual reduces (C*nv, f) onto vertices, volume Jacobian
    # reduces (C*nv*nv, f*f) onto (vertex, adjacency-slot) block ids
    res_tables: tuple = None    # (order, start, end) over dest = cells
    jac_tables: tuple = None    # (order, start, end) over dest = row*K+slot
    device: str = "cpu"
    dev: dict = field(default=None, compare=False, repr=False)

    #: elements per chunk of the vmapped jacfwd.  Its forward-mode
    #: intermediates grow as chunk * (nv*f) tangents * quadrature points.
    #: At 2,048 one Jacobian of the 3D pore main path (11,520 elements, 6
    #: chunks) stays far inside an H100's 80 GB, with room to grow the
    #: chunk when a profile asks for it; ``python3 chip_smoke.py
    #: --profile`` prints its peak device memory (PERF.md section 5).
    jac_chunk: int = 2048

    @staticmethod
    def build(mesh: Mesh, n_fields: int, quad_degree: int = 3,
              facet_quad_degree: int = 2, device="cpu") -> "FemSpace":
        dim = mesh.dim
        rule = simplex_quadrature(dim, quad_degree)
        vols = cell_measures(mesh.points, mesh.cells)
        gradN = physical_gradients(mesh.points, mesh.cells)
        X = mesh.points[mesh.cells]                       # (C, nv, dim)
        xq = np.einsum("qa,cad->cqd", rule.shape, X)
        adj, _ = vertex_adjacency(mesh.cells, mesh.num_vertices)
        diag_slot = np.argmax(adj == np.arange(len(adj))[:, None], axis=1)
        slot = _slot_table(mesh.cells, adj)
        colors = None
        try:
            from gmpnp_tpu_torch import native
            csr = native.vertex_adjacency_csr(mesh.cells, mesh.num_vertices)
            if csr is not None:
                colors = native.greedy_color(*csr, mesh.num_vertices)
        except Exception:
            colors = None
        if colors is None:
            from gmpnp_tpu_torch.solve.linear import greedy_vertex_coloring
            colors = greedy_vertex_coloring(adj)

        K = adj.shape[1]
        ftabs = []
        for m, t in sorted(_facet_tables(mesh, facet_quad_degree).items()):
            t = dict(t)
            t["slot"] = _node_slot(t["nodes"], adj)
            # sorted-segment tables reducing this marker's facet Jacobians
            # onto (vertex, adjacency-slot) block ids — same machinery as
            # the volume reduction
            fjac_dest = (t["nodes"][:, :, None].astype(np.int64) * K
                         + t["slot"]).reshape(-1)
            t["jac_tables"] = _sorted_segment_tables(
                fjac_dest, mesh.num_vertices * K)
            # and its facet residual rows onto vertices (the port's own
            # table: the reference scatter-adds them, which on the card
            # would be an atomic sum whose order changes from run to run)
            t["res_tables"] = _sorted_segment_tables(
                t["nodes"].reshape(-1), mesh.num_vertices)
            ftabs.append((m, {k: np.asarray(v) if not isinstance(v, tuple)
                              else v for k, v in t.items()}))
        res_tables = _sorted_segment_tables(
            mesh.cells.reshape(-1), mesh.num_vertices)
        jac_dest = (mesh.cells[:, :, None].astype(np.int64) * K
                    + slot).reshape(-1)          # (C*nv*nv,)
        jac_tables = _sorted_segment_tables(
            jac_dest, mesh.num_vertices * K)

        space = FemSpace(
            n_fields=n_fields,
            num_vertices=mesh.num_vertices,
            dim=dim,
            cells=np.asarray(mesh.cells),
            vols=np.asarray(vols),
            gradN=np.asarray(gradN),
            Nq=np.asarray(rule.shape),
            wq=np.asarray(rule.weights),
            xq=np.asarray(xq),
            adj=np.asarray(adj),
            diag_slot=np.asarray(diag_slot.astype(np.int32)),
            slot=np.asarray(slot),
            facet_tabs=tuple(ftabs),
            points=np.asarray(mesh.points),
            colors=colors,
            res_tables=res_tables,
            jac_tables=jac_tables,
            device=str(torch.device(device)),
        )
        object.__setattr__(space, "dev", _device_tables(space))
        return space

    # -- local kernels -------------------------------------------------------

    def _local_volume_residual(self, form: WeakForm, u_e, u_prev_e,
                               gradN_c, vol_c, xq_c, theta, aux_e=None):
        """Element residual (nv, fields) for one element."""
        return element_volume_residual(
            form.volume, u_e, u_prev_e, gradN_c, vol_c, self.dev["Nq"],
            self.dev["wq"], xq_c, theta, aux_e if form.n_aux else None)

    def _local_facet_residual(self, fn, u_f, meas_f, shape, weights,
                              xq_f, theta):
        """Facet residual (fnv, fields) for one boundary facet."""
        def at_q(Nq_q, x_q):
            u_q = Nq_q @ u_f
            g = fn(u_q, x_q, theta)
            return torch.outer(Nq_q, g)

        contrib = vmap(at_q)(shape, xq_f)
        return meas_f * torch.einsum("q,qaf->af", weights, contrib)

    # -- global assembly -----------------------------------------------------

    def uses_residual_kernel(self, form: WeakForm, device) -> bool:
        """Whether ``residual`` takes the volume term of ``form`` on
        ``device`` through the hand-written element kernel
        (``ops.pore_residual``): CUDA, a form that carries the kernel's
        spec for this many fields, no auxiliary fields, P1 tetrahedra."""
        spec = form.spec
        return (torch.device(device).type == "cuda" and spec is not None
                and form.n_aux == 0 and self.dim == 3
                and self.cells.shape[1] == 4
                and spec.n_fields == self.n_fields)

    @span("assembly.residual")
    def residual(self, form: WeakForm, u, u_prev, theta,
                 aux=None) -> torch.Tensor:
        """Assembled residual (N, fields); ``aux`` (N, n_aux) when the form
        declares auxiliary fields.  The volume term is the element kernel's
        where ``uses_residual_kernel``, else the vmapped ``form.volume``."""
        d = self.dev
        cells = d["cells"]
        if self.uses_residual_kernel(form, u.device):
            r_e = pore_residual(u, u_prev, theta["dt"], cells, d["gradN"],
                                d["vols"], d["Nq"], d["wq"], form.spec)
        elif form.n_aux:
            r_e = vmap(
                lambda ue, upe, ax, g, v, x: self._local_volume_residual(
                    form, ue, upe, g, v, x, theta, ax)
            )(u[cells], u_prev[cells], aux[cells], d["gradN"], d["vols"],
              d["xq"])
        else:
            r_e = vmap(
                lambda ue, upe, g, v, x: self._local_volume_residual(
                    form, ue, upe, g, v, x, theta)
            )(u[cells], u_prev[cells], d["gradN"], d["vols"], d["xq"])
        # scatter-free reduction onto vertices (sorted-segment sum; the
        # facet terms below too): the same bits on every run on the card
        C, nv = self.cells.shape
        r = _segment_reduce(
            r_e.reshape(C * nv, self.n_fields), *d["res_tables"])

        for marker, _ in self.facet_tabs:
            fn = form.boundary.get(marker)
            if fn is None:
                continue
            tab = d["facets"][marker]
            rf = vmap(
                lambda uf, mf, xf: self._local_facet_residual(
                    fn, uf, mf, tab["shape"], tab["weights"], xf, theta)
            )(u[tab["nodes"]], tab["meas"], tab["xq"])
            r = r + _segment_reduce(rf.reshape(-1, self.n_fields),
                                    *tab["res_tables"])
        return r

    # -- lane-batched assembly (sweep lanes) ---------------------------------

    @span("assembly.residual")
    def residual_lanes(self, form: WeakForm, u, u_prev, theta,
                       aux=None) -> torch.Tensor:
        """``residual`` of V lanes at once: u, u_prev (V, N, fields),
        ``theta`` a lane theta (``split_lane_theta``), ``aux`` (V, N, n_aux)
        or None -> (V, N, fields).  One vmapped call over the lane axis:
        each lane computes what ``residual`` computes for it."""
        shared, lane = split_lane_theta(theta)

        def one(ul, upl, th, ax):
            return self.residual(form, ul, upl, {**shared, **th}, aux=ax)

        return vmap(one, in_dims=(0, 0, 0, None if aux is None else 0))(
            u, u_prev, lane, aux)

    @span("assembly.jacobian")
    def jacobian_lanes(self, form: WeakForm, u, u_prev, theta,
                       aux=None, dtype=None) -> BlockELL:
        """``jacobian`` of V lanes at once -> BlockELL with flat (V, N, f,
        K*f) (arguments as ``residual_lanes``).  The element Jacobians and
        the sorted-segment sum of every lane are one vmapped call, so the
        assembly's peak memory is V times one lane's."""
        shared, lane = split_lane_theta(theta)

        def one(ul, upl, th, ax):
            return self.jacobian(form, ul, upl, {**shared, **th}, aux=ax,
                                 dtype=dtype).flat

        flat = vmap(one, in_dims=(0, 0, 0, None if aux is None else 0))(
            u, u_prev, lane, aux)
        return BlockELL(adj=self.dev["adj"], flat=flat,
                        diag_slot=self.dev["diag_slot"])

    @span("assembly.jacobian")
    def jacobian(self, form: WeakForm, u, u_prev, theta,
                 aux=None, dtype=None) -> BlockELL:
        """Assembled Jacobian dF/du as BlockELL (aux never differentiated).

        Element Jacobians come from ``jacfwd`` vmapped over chunks of
        ``jac_chunk`` elements, flattened to (C, nv*nv*f*f) in (a, b, r, c)
        order, and reduced onto (vertex, adjacency-slot) blocks by the
        sorted-segment sum in u's dtype.

        ``dtype=torch.float32`` evaluates the element Jacobians in f32
        (inexact Newton; the reference's ``jac_dtype='f32'``): their inputs
        and the form's float64 constants are cast to f32 (``_EvaluateIn``).
        The reduction and the facet Jacobians stay in u's dtype, as in the
        reference: the cumsum prefixes of the reduction would lose ~5
        digits in f32."""
        d = self.dev
        f = self.n_fields
        N = self.num_vertices
        K = self.adj.shape[1]
        C, nv = self.cells.shape
        cells = d["cells"]

        def local_jac(ue, upe, g, v, x, ax=None):
            fn = lambda uu: self._local_volume_residual(
                form, uu, upe, g, v, x, theta, ax)
            J = jacfwd(fn)(ue)                 # (nv, f, nv, f)
            return J.permute(0, 2, 1, 3).reshape(-1)

        args = [u[cells], u_prev[cells], d["gradN"], d["vols"], d["xq"]]
        if form.n_aux:
            args.append(aux[cells])
        ctx = contextlib.nullcontext()
        if dtype is not None and dtype != u.dtype:
            args = [a.to(dtype) for a in args]
            ctx = _EvaluateIn(dtype)
        kernel = vmap(local_jac)
        chunk = max(1, min(self.jac_chunk, C))
        with ctx:
            J_e = torch.cat([kernel(*(a[i:i + chunk] for a in args))
                             for i in range(0, C, chunk)], dim=0)

        blocks = _segment_reduce(
            J_e.to(u.dtype).reshape(C * nv * nv, f * f), *d["jac_tables"])

        for marker, _ in self.facet_tabs:
            fn = form.boundary.get(marker)
            if fn is None:
                continue
            tab = d["facets"][marker]

            def local_fjac(uf, mf, xf):
                f_res = lambda uu: self._local_facet_residual(
                    fn, uu, mf, tab["shape"], tab["weights"], xf, theta)
                J = jacfwd(f_res)(uf)
                return J.permute(0, 2, 1, 3).reshape(-1)

            Jf = vmap(local_fjac)(u[tab["nodes"]], tab["meas"], tab["xq"])
            Fc, fnv = tab["nodes"].shape
            blocks = blocks + _segment_reduce(
                Jf.reshape(Fc * fnv * fnv, f * f), *tab["jac_tables"])

        flat = blocks.reshape(N, K, f, f).transpose(1, 2).reshape(N, f, K * f)
        return BlockELL(adj=d["adj"], flat=flat, diag_slot=d["diag_slot"])
