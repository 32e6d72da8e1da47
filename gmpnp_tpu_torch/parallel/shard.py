"""Z-slab domain decomposition of the 3D pore solve over a line of ranks.

Port of ``gmpnp_tpu/parallel/shard.py``.  The reference is one
``shard_map`` program over a 1-D device mesh, driven by one process; the
port keeps that model: one process, one rank per entry of
``mesh_devices`` (a list of ``torch.device`` that may repeat a device —
four ranks on one card, or four on the host), each rank's tensors on its
device, the rank-local work called once per rank in a Python loop, and the
collectives in :class:`ZGroup`:

- ``ppermute(xs, perm)``: receivers not named in ``perm`` get zeros, as in
  ``jax.lax.ppermute``;
- ``psum(xs)``: summed in fixed rank order on rank 0's device, then copied
  back to every rank;
- ``all_gather(xs)``; ``axis_index``.

Every ``while_loop``/``cond`` predicate of the reference is a psum-reduced
scalar; here it is one host read on rank 0, counted by ``sync.to_host``.

Partitioning scheme (host-side, ZShardPlan.build — numpy code copied from
the reference):
- vertices sorted by z and split into equal contiguous blocks of N_p
  (zero-padded to n_dev * N_p);
- an element is owned by the rank owning its minimum vertex; since slabs
  are contiguous in z, every element's vertices then live in
  [own block, own block + H) where H is the (exact, precomputed) maximum
  overshoot — the right halo width;
- boundary facets follow the same ownership rule.

Step primitives:
- halo_gather:  u_ext = [u_own ; first H rows of the right neighbor]
- spill_reduce: fold contributions accumulated for halo rows back onto
  their owner (a ppermute to the right + add)
- Dirichlet row masking happens post-reduction on the owner, which is
  exactly equivalent to the single-device row replacement.

The reference's scatter-adds (``.at[cells].add``) are per-destination sums
over padded gather tables here (no atomics, so two runs on one card are
bitwise equal); the band of the distributed SPIKE solver is reduced by the
plan's sorted-segment tables, as in the reference.  The f32 SPIKE
factorization and the seam inverses run at full f32 precision (no TF32).

Not ported: ``jit`` and ``axis_name`` (nothing is traced), and two TPU
workarounds, the ``optimization_barrier`` on the Dirichlet lift and the
``shard_map`` version shims.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from gmpnp_tpu_torch.fem.assembly import (
    _segment_reduce,
    _sorted_segment_tables,
)
from gmpnp_tpu_torch.fem.elements import (
    physical_gradients,
    simplex_quadrature,
)
from gmpnp_tpu_torch.fem.forms import WeakForm
from gmpnp_tpu_torch.mesh.core import (
    Mesh as FemMesh,
    cell_measures,
    facet_measures,
)
from gmpnp_tpu_torch.solve.amg import segment_sum, segment_table
from gmpnp_tpu_torch.solve.slab import (
    SlabFactors,
    full_f32_precision,
    slab_factor,
    slab_solve,
)
from gmpnp_tpu_torch.solve.smallblock import (
    block_inv,
    triangular_solve_upper,
)
from gmpnp_tpu_torch.sync import to_host


@dataclass(frozen=True)
class ZShardPlan:
    """Host-side partition tables.  All per-device arrays carry a leading
    n_dev axis (row p is rank p's)."""

    n_dev: int
    n_fields: int
    N: int              # true vertex count
    N_p: int            # owned vertices per device (padded)
    H: int              # right-halo width
    # per-device element tables, shape (n_dev, C_p, ...)
    cells_l: np.ndarray     # extended-local vertex ids, (n_dev, C_p, nv)
    vols: np.ndarray        # (n_dev, C_p); padding elements have vol 0
    gradN: np.ndarray       # (n_dev, C_p, nv, dim)
    # quadrature (shared)
    Nq: np.ndarray
    wq: np.ndarray
    # per-device boundary facet tables per marker:
    # dict marker -> (nodes_l (n_dev, F_p, fnv), meas (n_dev, F_p), shape, w)
    facets: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]
    # Dirichlet data over owned nodes, (n_dev, N_p, f)
    bc_mask: np.ndarray
    bc_vals: np.ndarray
    # owned-node validity (padding rows false), (n_dev, N_p)
    valid: np.ndarray
    # z-sort permutation: plan vertex i is original vertex perm[i] (identity
    # when the mesh is already sorted, e.g. generated cylinder meshes)
    perm: np.ndarray

    def localize(self, u: np.ndarray) -> np.ndarray:
        """(N, ...) original vertex order -> (n_dev*N_p, ...) plan order,
        zero-padded."""
        u = np.asarray(u)
        out = np.zeros((self.n_dev * self.N_p,) + u.shape[1:], u.dtype)
        out[: self.N] = u[self.perm]
        return out

    def globalize(self, u_pad) -> np.ndarray:
        """(n_dev*N_p, ...) plan order -> (N, ...) original vertex order."""
        u_pad = np.asarray(u_pad)
        out = np.empty((self.N,) + u_pad.shape[1:], u_pad.dtype)
        out[self.perm] = u_pad[: self.N]
        return out

    @staticmethod
    def build(mesh: FemMesh, n_fields: int, n_dev: int,
              bc_mask: np.ndarray, bc_vals: np.ndarray,
              quad_degree: int = 2):
        """bc_mask/vals are global (N, f) in the mesh's vertex order.

        The z-slab partition needs vertices numbered ascending in the last
        coordinate; the SHIPPED reference meshes are not (their DOLFIN-XML
        ordering has z-bandwidth ~N/2, which round-3 found silently
        produced halo = slab and crashed XLA:CPU at N=3530).  The plan
        therefore z-sorts internally and records ``perm``; use
        ``localize``/``globalize`` to move between orderings."""
        z = mesh.points[:, -1]
        if np.any(np.diff(z) < 0):
            perm = np.argsort(z, kind="stable")
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            mesh = _dc_replace(
                mesh,
                points=mesh.points[perm],
                cells=inv[mesh.cells].astype(np.int32),
                facets=(inv[mesh.facets].astype(np.int32)
                        if mesh.facets is not None else None),
            )
            bc_mask = np.asarray(bc_mask)[perm]
            bc_vals = np.asarray(bc_vals)[perm]
        else:
            perm = np.arange(mesh.num_vertices)
        dim = mesh.dim
        nv = dim + 1
        N = mesh.num_vertices
        N_p = -(-N // n_dev)
        N_pad = N_p * n_dev

        cells = mesh.cells.astype(np.int64)
        owner = cells.min(axis=1) // N_p
        block_end = (owner + 1) * N_p
        overshoot = cells.max(axis=1) - (block_end - 1)
        H = max(1, int(np.maximum(overshoot, 0).max()))
        if H > N_p:
            raise ValueError(
                f"halo width {H} exceeds slab size {N_p}: too many devices "
                f"for this mesh ({N} vertices, {n_dev} devices)")

        vols_g = cell_measures(mesh.points, mesh.cells)
        gradN_g = physical_gradients(mesh.points, mesh.cells)
        rule = simplex_quadrature(dim, quad_degree)

        C_p = max(int((owner == p).sum()) for p in range(n_dev))
        cells_l = np.zeros((n_dev, C_p, nv), dtype=np.int32)
        vols = np.zeros((n_dev, C_p))
        gradN = np.zeros((n_dev, C_p, nv, dim))
        for p in range(n_dev):
            sel = np.nonzero(owner == p)[0]
            k = len(sel)
            cells_l[p, :k] = cells[sel] - p * N_p
            vols[p, :k] = vols_g[sel]
            gradN[p, :k] = gradN_g[sel]

        # boundary facets by the same ownership rule
        facets = {}
        if mesh.facets is not None and len(mesh.facets):
            fdim = dim - 1
            if fdim == 0:
                fshape = np.ones((1, 1))
                fw = np.ones(1)
            else:
                frule = simplex_quadrature(fdim, quad_degree)
                fshape, fw = frule.shape, frule.weights
            for m in np.unique(mesh.facet_markers):
                fsel = mesh.facets[mesh.facet_markers == m].astype(np.int64)
                fmeas_g = facet_measures(mesh.points, fsel)
                fowner = fsel.min(axis=1) // N_p
                over = fsel.max(axis=1) - ((fowner + 1) * N_p - 1)
                assert int(np.maximum(over, 0).max(initial=0)) <= H
                F_p = max(1, max(int((fowner == p).sum())
                                 for p in range(n_dev)))
                fn = np.zeros((n_dev, F_p, fsel.shape[1]), dtype=np.int32)
                fm = np.zeros((n_dev, F_p))
                for p in range(n_dev):
                    s = np.nonzero(fowner == p)[0]
                    fn[p, :len(s)] = fsel[s] - p * N_p
                    fm[p, :len(s)] = fmeas_g[s]
                facets[int(m)] = (fn, fm, fshape, fw)

        def pad_nodes(arr, fill=0.0):
            out = np.full((N_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
            out[:N] = arr
            return out.reshape((n_dev, N_p) + arr.shape[1:])

        valid = pad_nodes(np.ones(N, dtype=bool), False)
        return ZShardPlan(
            n_dev=n_dev, n_fields=n_fields, N=N, N_p=N_p, H=H,
            cells_l=cells_l, vols=vols, gradN=gradN,
            Nq=rule.shape, wq=rule.weights,
            facets=facets,
            bc_mask=pad_nodes(np.asarray(bc_mask).astype(bool), False),
            bc_vals=pad_nodes(np.asarray(bc_vals).astype(np.float64)),
            valid=valid,
            perm=perm,
        )


@dataclass(frozen=True)
class SlabPrecondPlan:
    """Host-side tables for the DISTRIBUTED z-slab direct solver (SPIKE).

    Distributes the production slab solver (solve.slab) across the ranks
    as an EXACT f32 direct solve of the full Newton system, used as the
    preconditioner of the sharded f64 GMRES (the same mixed-precision
    recipe as the single-device slab_direct path, so the sharded inner
    solve converges in the same O(10)-iteration regime regardless of
    rank count).

    Algorithm (classic SPIKE / block cyclic reduction over rank blocks;
    each Newton iteration):

    1. every rank assembles its owned-rows block-banded Jacobian from its
       element AND boundary-facet blocks (sorted-segment reduction over
       this plan's tables), row-replaces Dirichlet rows, equilibrates with
       the exact spill-reduced block diagonal, and factors it with f32
       block-Thomas (solve.slab);
    2. the seam coupling blocks B_p (own last rows -> right neighbor's
       head columns) and C_p (own head rows -> left neighbor's tail
       columns; assembled by the LEFT neighbor's elements and exchanged
       one ppermute right) are restricted to the static interface
       windows of ``h_v`` vertices (h_v = element bandwidth >= halo) and
       turned into spikes V_p = A_p^{-1} B_p, W_p = A_p^{-1} C_p by the
       factored local solve with h_v*f simultaneous RHS columns;
    3. the interface unknowns y_p (tail window of rank p) and z_{p+1}
       (head window of rank p+1) close a block-tridiagonal REDUCED system
       of n_dev-1 seam blocks of size 2*h_v*f, built replicated from one
       all_gather of the four spike tip blocks per rank and factored once
       per Newton iteration (again solve.slab);
    4. each application then costs one local banded solve, one all_gather
       of the two interface RHS windows, one replicated reduced solve, and
       two (S, m, h) spike corrections — and returns the EXACT (up to f32)
       solution of the full distributed system.

    Layout: extended positions 0..(S+1)*m_v; local vertex id r maps to
    position r for owned rows (padding positions N_p..S*m_v are identity
    rows inside the last owned slab) and to S*m_v + (r - N_p) for halo
    rows.  ``m_v`` is chosen with m_v >= bw + pad so that EVERY element
    coupling lands within one slab of its row (|band| <= 1) — including
    owned-row -> halo-column couplings across the padding gap.  That same
    inequality places the tail interface window [N_p - h_v, N_p) entirely
    inside the last slab.
    """

    S: int           # owned slabs per device (assembly space has S+1)
    m_v: int         # vertices per slab
    f: int
    N_p: int
    h_v: int         # interface window width in vertices (= bandwidth)
    pad: int         # identity padding rows inside the last slab
    # per-device sorted-segment tables over extended band destinations
    # (element pair blocks first, then facet pair blocks per marker in
    # ``facet_markers`` order — the runtime concatenates values the same
    # way)
    facet_markers: Tuple[int, ...]
    order: np.ndarray   # (n_dev, n_pairs) int32
    start: np.ndarray   # (n_dev, (S+1)*m_v*3*m_v) int32
    end: np.ndarray     # (n_dev, (S+1)*m_v*3*m_v) int32
    # owned-position coverage: True = some element assembles this row
    # (own elements or left-neighbor spill); uncovered -> identity row
    cover: np.ndarray   # (n_dev, (S+1)*m_v) bool

    @property
    def m(self) -> int:
        return self.m_v * self.f

    @property
    def h(self) -> int:
        return self.h_v * self.f

    @staticmethod
    def build(plan: ZShardPlan,
              facet_markers: Sequence[int] = ()) -> "SlabPrecondPlan":
        n_dev, N_p, f = plan.n_dev, plan.N_p, plan.n_fields
        cells_l = np.asarray(plan.cells_l)          # (n_dev, C_p, nv)
        n_dev_, C_p, nv = cells_l.shape
        facet_markers = tuple(sorted(facet_markers))

        # local bandwidth over element couplings; m_v >= bw makes the
        # extended system block tridiagonal in slabs (solve.slab)
        span = cells_l.max(axis=2) - cells_l.min(axis=2)    # (n_dev, C_p)
        bw = max(1, int(span.max(initial=0)))
        if bw > N_p:
            raise ValueError(
                f"element bandwidth {bw} exceeds slab size {N_p}: too "
                f"many devices for this mesh")
        m_v = min(max(bw, 1), N_p)
        S = max(-(-N_p // m_v), 1)
        m_v = min(max(-(-N_p // S), bw), N_p)
        # m_v < bw silently drops couplings from the band (the root cause
        # of a divergence at N_p=162, bw=36, where m_v rounded down to
        # 33); SPIKE further needs m_v >= bw + pad so couplings that jump
        # the padding gap into the halo slab stay within |band| <= 1 and
        # the tail interface window stays inside the last slab
        while S * m_v - N_p > m_v - bw:
            m_v += 1
            S = max(-(-N_p // m_v), 1)
        pad = S * m_v - N_p
        assert 0 <= pad <= m_v - bw and m_v <= N_p
        E = (S + 1) * m_v
        n_dest = E * 3 * m_v

        cover = np.zeros((n_dev, E), bool)
        vols = np.asarray(plan.vols)                        # (n_dev, C_p)

        def pos_of(idx):
            return np.where(idx < N_p, idx, S * m_v + (idx - N_p))

        for p in range(n_dev):
            c = cells_l[p].astype(np.int64)
            real = vols[p] > 0                              # padding cells
            cov = np.unique(c[real])
            cover[p, pos_of(cov)] = True
            # own rows also covered via the left neighbor's spill
            # exchange (element owner = min-vertex device and span <= bw
            # <= m_v, so no device beyond the left neighbor contributes)
            if p > 0:
                cl = cells_l[p - 1].astype(np.int64)
                spill = np.unique(cl[vols[p - 1] > 0])
                spill = spill[spill >= N_p] - N_p
                cover[p, spill[spill < N_p]] = True

        def pair_dest(c):
            """(n, k) node tuples -> flat band destinations for every
            (row, col) node pair, matching the runtime value order
            J[n, a, b] -> (row c[a], col c[b])."""
            k = c.shape[1]
            r = np.repeat(c[:, :, None], k, 2).reshape(-1)
            q = np.repeat(c[:, None, :], k, 1).reshape(-1)
            pr, pq = pos_of(r), pos_of(q)
            s_r, i_r = pr // m_v, pr % m_v
            s_q, i_q = pq // m_v, pq % m_v
            band = s_q - s_r
            assert (np.abs(band) <= 1).all(), "band overflow: bad m_v"
            return (s_r * m_v + i_r) * (3 * m_v) + (band + 1) * m_v + i_q

        # element pair blocks first, then facet pair blocks per marker —
        # facet Jacobians INCLUDED so the f32 factorization is the exact
        # (rounded) inverse of the Krylov operator, not a perturbation
        n_pairs = C_p * nv * nv + sum(
            plan.facets[mk][0].shape[1] * plan.facets[mk][0].shape[2] ** 2
            for mk in facet_markers)
        orders = np.zeros((n_dev, n_pairs), np.int32)
        starts = np.zeros((n_dev, n_dest), np.int32)
        ends = np.zeros((n_dev, n_dest), np.int32)
        for p in range(n_dev):
            dest = [pair_dest(cells_l[p].astype(np.int64))]
            for mk in facet_markers:
                fn = np.asarray(plan.facets[mk][0][p]).astype(np.int64)
                dest.append(pair_dest(fn))
            o, st, en = _sorted_segment_tables(
                np.concatenate(dest), n_dest)
            orders[p], starts[p], ends[p] = o, st, en
        return SlabPrecondPlan(S=S, m_v=m_v, f=f, N_p=N_p, h_v=bw, pad=pad,
                               facet_markers=facet_markers,
                               order=orders, start=starts, end=ends,
                               cover=cover)


class ZGroup:
    """The collectives of a line of ranks, rank p on ``devices[p]``.

    A rank-distributed value is a list with one tensor per rank.  The
    device list may repeat a device (several ranks share a card or the
    host); with distinct cards the same calls copy between peers."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)

    @property
    def axis_index(self) -> range:
        """The rank index of each rank (the reference's
        ``jax.lax.axis_index``)."""
        return range(self.n)

    def ppermute(self, xs, perm):
        """out[dst] = xs[src] for every (src, dst) in ``perm``; ranks that
        receive nothing get zeros (``jax.lax.ppermute``)."""
        out = [None] * self.n
        for src, dst in perm:
            out[dst] = xs[src].to(self.devices[dst])
        return [torch.zeros_like(x) if o is None else o
                for x, o in zip(xs, out)]

    def psum(self, xs):
        """The sum over ranks, in rank order on rank 0's device, on every
        rank."""
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x.to(acc.device)
        return [acc.to(d) for d in self.devices]

    def all_gather(self, xs):
        """(n_dev, ...) stack of every rank's value, on every rank."""
        g = torch.stack([x.to(self.devices[0]) for x in xs])
        return [g.to(d) for d in self.devices]

    def per_device(self, fn, xs):
        """``fn`` of a replicated value, computed once per distinct device
        (ranks on one device share the result)."""
        done, out = {}, []
        for d, x in zip(self.devices, xs):
            if d not in done:
                done[d] = fn(x)
            out.append(done[d])
        return out

    def shard(self, u_pad: torch.Tensor):
        """(n_dev*N_p, ...) plan order -> per-rank (N_p, ...) blocks."""
        return [b.to(d) for b, d in zip(u_pad.chunk(self.n), self.devices)]

    def unshard(self, xs) -> torch.Tensor:
        """Per-rank blocks -> (n_dev*N_p, ...) on rank 0's device."""
        return torch.cat([x.to(self.devices[0]) for x in xs])


def halo_gather(group: ZGroup, us, H: int):
    """u_ext = [u_own ; first H rows of the right neighbor] on every rank
    (the last rank's halo is zeros)."""
    fwd_perm = [(p, p - 1) for p in range(1, group.n)]
    recv = group.ppermute([u[:H] for u in us], fwd_perm)
    return [torch.cat([u, r], dim=0) for u, r in zip(us, recv)]


def spill_reduce(group: ZGroup, rs, N_p: int, H: int):
    """Fold the halo rows (N_p:) of each rank's extended vector onto the
    first H rows of their owner, the right neighbor."""
    bwd_perm = [(p, p + 1) for p in range(group.n - 1)]
    recv = group.ppermute([r[N_p:] for r in rs], bwd_perm)
    return [torch.cat([r[:H] + s, r[H:N_p]], dim=0)
            for r, s in zip(rs, recv)]


def pdot(group: ZGroup, a, b):
    """Global dot product of two rank-distributed tensors, on every
    rank."""
    return group.psum([torch.sum(x * y) for x, y in zip(a, b)])


def pnorm(group: ZGroup, a):
    return [torch.sqrt(s) for s in pdot(group, a, a)]


def ring_shift(group: ZGroup, xs, dist: int, fill):
    """Per-rank value of ``xs`` at ring position idx+dist, replaced by
    ``fill`` where idx+dist falls outside [0, n_dev) — ppermute is
    cyclic, but the seam chain is a LINE, so wraparound neighbors must
    act as identity/zero rows.  ``fill`` is 0.0 or a function of the
    received tensor (e.g. an identity of its shape)."""
    n = group.n
    got = group.ppermute(xs, [(j, (j - dist) % n) for j in range(n)])
    return [g if 0 <= idx + dist < n else
            (torch.zeros_like(g) if fill == 0.0 else fill(g))
            for idx, g in zip(group.axis_index, got)]


def _eye_like(x):
    return torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)


def _on(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


class _RankTables:
    """One rank's device copies of the plan tables."""

    def __init__(self, plan: ZShardPlan, pp, p: int, device, lifts,
                 active_markers):
        i64 = dict(dtype=torch.int64, device=device)
        f64 = dict(dtype=torch.float64, device=device)
        N_p, H = plan.N_p, plan.H
        self.device = device
        self.cells = torch.as_tensor(plan.cells_l[p], **i64)
        self.vols = torch.as_tensor(plan.vols[p], **f64)
        self.gradN = torch.as_tensor(plan.gradN[p], **f64)
        self.Nq = torch.as_tensor(plan.Nq, **f64)
        self.wq = torch.as_tensor(plan.wq, **f64)
        self.cell_tab = torch.as_tensor(
            segment_table(plan.cells_l[p], N_p + H), **i64)
        # only the markers the form integrates (the reference skips the
        # others wherever it loops over facets)
        self.facets = {}
        for m in active_markers:
            fn, fm, fshape, fw = plan.facets[m]
            self.facets[m] = (
                torch.as_tensor(fn[p], **i64), torch.as_tensor(fm[p], **f64),
                torch.as_tensor(fshape, **f64), torch.as_tensor(fw, **f64),
                torch.as_tensor(segment_table(fn[p], N_p + H), **i64))
        self.bc_mask = torch.as_tensor(plan.bc_mask[p], device=device)
        self.bc_vals = torch.as_tensor(plan.bc_vals[p], **f64)
        self.valid = torch.as_tensor(plan.valid[p], device=device)
        self.ident_rows = self.bc_mask | (~self.valid)[:, None]
        self.lifts = [(torch.as_tensor(oh.reshape(plan.n_dev, N_p, -1)[p],
                                       **f64), key) for oh, key in lifts]
        if pp is not None:
            self.order = torch.as_tensor(pp.order[p], **i64)
            self.start = torch.as_tensor(pp.start[p], **i64)
            self.end = torch.as_tensor(pp.end[p], **i64)
            self.cover = torch.as_tensor(pp.cover[p], device=device)


def _element_residual(form, ue, upe, g, v, Nq, wq, theta):
    """Element residual (nv, f) of one element (quadrature over Nq)."""
    grad_u = torch.einsum("af,ad->fd", ue, g)

    def at_q(Nq_q):
        u_q = Nq_q @ ue
        up_q = Nq_q @ upe
        fval, fgrad = form.volume(u_q, grad_u, up_q, None, theta)
        return (torch.outer(Nq_q, fval)
                + torch.einsum("ad,fd->af", g, fgrad))

    contrib = vmap(at_q)(Nq)
    return v * torch.einsum("q,qaf->af", wq, contrib)


def _facet_residual(bfn, uf, meas, fshape, fw, theta):
    """Facet residual (fnv, f) of one boundary facet."""
    def at_q(Nq_q):
        g = bfn(Nq_q @ uf, None, theta)
        return torch.outer(Nq_q, g)

    contrib = vmap(at_q)(fshape)
    return meas * torch.einsum("q,qaf->af", fw, contrib)


#: elements per chunk of the vmapped jacfwd (FemSpace.jac_chunk's value)
_JAC_CHUNK = 2048


def make_sharded_step(
    plan: ZShardPlan,
    form,
    mesh_devices,
    newton_max_iter: int = 50,
    newton_rtol: float = 1.0e-4,
    newton_atol: float = 1.0e-4,
    relaxation: float = 0.9,
    krylov_tol: float = 1.0e-6,
    krylov_maxiter: int = 2000,
    krylov_restart: int = 30,
    linear: str = "slab_direct",
    refresh: str = "iter",
    chord_max_iter: int = 16,
    refresh_iters: int = 8,
    bc_lifts: Optional[Sequence[Tuple[np.ndarray, str]]] = None,
    seam: str = "replicated",
):
    """Build a sharded implicit step over the ranks ``mesh_devices``.

    ``form`` is a WeakForm (its constants on every rank's device) or a
    sequence of them, one per rank.  Returns ``(step, group)`` with
    ``step(u, u_prev, theta) -> (u_new, (iters, converged, resnorm,
    lin_iters))``: u, u_prev and u_new are per-rank (N_p, f) blocks in plan
    order (``group.shard`` of the padded (n_dev*N_p, f) array), the stats
    are Python numbers.  Damped Newton runs over the ranks.

    linear: 'slab_direct' (default) runs distributed f64 CGS2-GMRES
    preconditioned by the EXACT f32 distributed SPIKE direct solve of
    the banded Jacobian (per-rank block-Thomas factorizations + a
    replicated reduced seam system; see SlabPrecondPlan) — the
    distributed form of the production solve.slab solver, with
    rank-count-independent O(10) inner iterations; 'bicgstab_jacobi'
    keeps block-Jacobi BiCGStab.

    refresh: 'iter' (default) re-assembles the Jacobian and re-factors
    at every Newton iterate (exact Newton); 'step' assembles + factors
    ONCE at the step's start iterate and reuses both for the whole step
    (modified/chord Newton, certified on the true residual).  'carried'
    extends 'step' ACROSS time steps (the distributed
    LinearConfig.refresh='carried'): the local Jacobian blocks + SPIKE
    factorization ride the transient carry, the chord attempt gets
    ``chord_max_iter`` iterations, non-convergence falls back to exact
    Newton from the safe previous state (re-factoring the carry), and a
    converged-but-slow step (> ``refresh_iters`` iterations) refreshes
    proactively.  With refresh='carried' the return is
    ``(step, prep_init, group)`` with ``step(u_start, u_prev, theta,
    carry) -> (u_new, stats, carry_new)`` and ``prep_init(u0, u0, theta)
    -> carry``; the carry is ``(dev, rep)``, per rank a tuple of its own
    leaves and a tuple of the replicated ones, in the reference's
    ``carry_split`` order.  Requires linear='slab_direct'.

    bc_lifts: optional static (n_dev*N_p, f) one-hot masks paired with
    theta keys; per step the Dirichlet VALUES become
    ``vals*(1-onehot) + theta[key]*onehot`` (pure arithmetic, the
    fem.dirichlet.ArithDirichletBC formulation), which is how the moving
    Sechenov CO2 Dirichlet value enters the sharded transient.
    """
    if linear not in ("slab_direct", "bicgstab_jacobi"):
        raise ValueError(f"unknown sharded linear solver {linear!r}; "
                         f"'slab_direct' or 'bicgstab_jacobi'")
    if refresh not in ("iter", "step", "carried"):
        raise ValueError(f"refresh must be 'iter', 'step' or 'carried', "
                         f"got {refresh!r}")
    if refresh == "carried" and linear != "slab_direct":
        raise ValueError("refresh='carried' requires linear='slab_direct' "
                         "(the carried state is the SPIKE factorization)")
    if seam not in ("replicated", "ring"):
        # 'replicated': the reduced block-tridiagonal seam system is
        # all_gathered and factored identically on every device — O(n_dev)
        # (2h)^2 blocks per device.  'ring': the seam system stays
        # distributed one block-row per rank and is solved by parallel
        # cyclic reduction over the rank ring — O(log n_dev) blocks per
        # rank, removing the n_dev^2 aggregate memory term
        raise ValueError(f"seam must be 'replicated' or 'ring', got "
                         f"{seam!r}")
    full_f32_precision()
    n_dev, N_p, H, nf = plan.n_dev, plan.N_p, plan.H, plan.n_fields
    group = ZGroup(mesh_devices)
    if group.n != n_dev:
        raise ValueError(f"the plan has {n_dev} ranks, mesh_devices "
                         f"{group.n}")
    devs = group.devices
    forms = ([form] * n_dev if isinstance(form, WeakForm) else list(form))
    form0 = forms[0]
    active_markers = sorted(
        mk for mk in plan.facets if form0.boundary.get(mk) is not None)
    pp = (SlabPrecondPlan.build(plan, facet_markers=active_markers)
          if linear == "slab_direct" else None)
    bc_lifts = list(bc_lifts or [])
    for oh, _key in bc_lifts:
        assert np.asarray(oh).shape == (n_dev * N_p, nf), (
            f"bc_lift onehot must be padded to ({n_dev * N_p}, {nf})")
    lifts = [(np.asarray(oh, np.float64), key) for oh, key in bc_lifts]
    R = [_RankTables(plan, pp, p, devs[p], lifts, active_markers)
         for p in range(n_dev)]
    ranks = range(n_dev)

    def _halo(us):
        return halo_gather(group, us, H)

    def _spill(rs):
        return spill_reduce(group, rs, N_p, H)

    def _pdot(a, b):
        return pdot(group, a, b)

    def _pnorm(a):
        return pnorm(group, a)

    def _ring_shift(xs, dist, fill):
        return ring_shift(group, xs, dist, fill)

    _pcr_rounds = max(1, int(np.ceil(np.log2(max(n_dev, 2)))))

    def _pcr_factor(Dp, Lp, Up):
        """Distributed parallel-cyclic-reduction factorization of the
        seam block-tridiagonal system, one (2h,2h) block-row per rank
        (out-of-range neighbors are identity rows, so the line system
        embeds in the ring).  Per round k (distance d=2^k) each row
        eliminates its +-d neighbors:
            alpha = -L @ Dinv_{i-d},  beta = -U @ Dinv_{i+d}
            D' = D + alpha U_{i-d} + beta L_{i+d}
            L' = alpha L_{i-d},       U' = beta U_{i+d}
        After ceil(log2(n_dev)) rounds the system is block-diagonal.
        Stores (alphas, betas, Dinv_final): O(log n_dev) blocks per rank
        vs the replicated factor's O(n_dev)."""
        alphas, betas = [[] for _ in ranks], [[] for _ in ranks]
        d = 1
        for _ in range(_pcr_rounds):
            Dinv = [torch.linalg.inv(x) for x in Dp]
            Dinv_l = _ring_shift(Dinv, -d, _eye_like)
            Dinv_r = _ring_shift(Dinv, +d, _eye_like)
            Ll, Ul = _ring_shift(Lp, -d, 0.0), _ring_shift(Up, -d, 0.0)
            Lr, Ur = _ring_shift(Lp, +d, 0.0), _ring_shift(Up, +d, 0.0)
            for p in ranks:
                alpha = -(Lp[p] @ Dinv_l[p])
                beta = -(Up[p] @ Dinv_r[p])
                Dp[p] = Dp[p] + alpha @ Ul[p] + beta @ Lr[p]
                Lp[p] = alpha @ Ll[p]
                Up[p] = beta @ Ur[p]
                alphas[p].append(alpha)
                betas[p].append(beta)
            d *= 2
        return [(torch.stack(alphas[p]), torch.stack(betas[p]),
                 torch.linalg.inv(Dp[p])) for p in ranks]

    def _pcr_solve(reds, bs):
        """RHS sweep of the stored PCR elimination + final diagonal
        solve."""
        d = 1
        for k in range(_pcr_rounds):
            bl = _ring_shift(bs, -d, 0.0)
            br = _ring_shift(bs, +d, 0.0)
            bs = [b + red[0][k] @ l_ + red[1][k] @ r_
                  for b, red, l_, r_ in zip(bs, reds, bl, br)]
            d *= 2
        return [red[2] @ b for red, b in zip(reds, bs)]

    # the ranks of each device: their element kernels run as one batch
    # (a few large launches instead of one set per rank)
    dev_groups = {}
    for p in ranks:
        dev_groups.setdefault(devs[p], []).append(p)

    def _batched(fn, per_rank):
        """``fn(p0, *args)`` once per device, on the concatenation of its
        ranks' ``per_rank[p]`` (tuples of tensors with a leading item
        axis; ``p0`` the device's first rank); returns the per-rank
        slices of the results."""
        out = [None] * n_dev
        for ps in dev_groups.values():
            args = [torch.cat([per_rank[p][i] for p in ps])
                    for i in range(len(per_rank[ps[0]]))]
            res = fn(ps[0], *args)
            for p, r in zip(ps, res.split(
                    [per_rank[p][0].shape[0] for p in ps])):
                out[p] = r
        return out

    def _elem_args(u_ext, up_ext):
        return [(u_ext[p][R[p].cells], up_ext[p][R[p].cells], R[p].gradN,
                 R[p].vols) for p in ranks]

    def _facet_args(u_ext, m):
        return [(u_ext[p][R[p].facets[m][0]], R[p].facets[m][1])
                for p in ranks]

    def local_residual_ext(u_ext, up_ext, th):
        """Element + facet assembly into each rank's extended index space
        (per-destination sums, no scatter)."""
        def elems(p, ue, upe, g, v):
            T = R[p]
            return vmap(lambda a, b_, c, d: _element_residual(
                forms[p], a, b_, c, d, T.Nq, T.wq, th[p]))(ue, upe, g, v)

        r_e = _batched(elems, _elem_args(u_ext, up_ext))
        r_ext = [segment_sum(r_e[p].reshape(-1, nf), R[p].cell_tab)
                 for p in ranks]
        for m in active_markers:
            def facets(p, uf, ms, m=m):
                _, _, fshape, fw, _ = R[p].facets[m]
                bfn = forms[p].boundary[m]
                return vmap(lambda a, b_: _facet_residual(
                    bfn, a, b_, fshape, fw, th[p]))(uf, ms)

            rf = _batched(facets, _facet_args(u_ext, m))
            r_ext = [r_ext[p] + segment_sum(rf[p].reshape(-1, nf),
                                            R[p].facets[m][4])
                     for p in ranks]
        return r_ext

    def local_jacobian(u_ext, up_ext, th):
        """Per-element Jacobian blocks (C_p, nv, nv, f, f) of every rank
        in its extended space (not reduced: the matvec spills instead),
        and the facet blocks per marker."""
        def elems(p, ue, upe, g, v):
            T = R[p]

            def elem_jac(ue, upe, g, v):
                J = jacfwd(lambda uu: _element_residual(
                    forms[p], uu, upe, g, v, T.Nq, T.wq, th[p]))(ue)
                return J.permute(0, 2, 1, 3)            # (nv, nv, f, f)

            kernel = vmap(elem_jac)
            return torch.cat(
                [kernel(ue[i:i + _JAC_CHUNK], upe[i:i + _JAC_CHUNK],
                        g[i:i + _JAC_CHUNK], v[i:i + _JAC_CHUNK])
                 for i in range(0, ue.shape[0], _JAC_CHUNK)], dim=0)

        J_e = _batched(elems, _elem_args(u_ext, up_ext))
        J_f = [{} for _ in ranks]
        for m in active_markers:
            def facets(p, uf, ms, m=m):
                _, _, fshape, fw, _ = R[p].facets[m]
                bfn = forms[p].boundary[m]

                def facet_jac(uf, ms):
                    J = jacfwd(lambda uu: _facet_residual(
                        bfn, uu, ms, fshape, fw, th[p]))(uf)
                    return J.permute(0, 2, 1, 3)

                return vmap(facet_jac)(uf, ms)

            for p, J in enumerate(_batched(facets, _facet_args(u_ext, m))):
                J_f[p][m] = J
        return J_e, J_f

    def _square(J):
        """(C, k, k, f, f) element blocks -> (C, k*f, k*f) matrices."""
        C, k = J.shape[0], J.shape[1]
        return J.permute(0, 1, 3, 2, 4).reshape(C, k * nf, k * nf)

    def make_matvec(J_e, J_f):
        """Distributed matvec with identity action on masked rows
        (Dirichlet + padding), equivalent to single-device row
        replacement."""
        Jm = [_square(J) for J in J_e]
        Jfm = [{m: _square(J) for m, J in jf.items()} for jf in J_f]

        def apply(J, nodes, x_ext, tab):
            x_e = x_ext[nodes].reshape(nodes.shape[0], -1, 1)
            return segment_sum((J @ x_e).reshape(-1, nf), tab)

        def matvec(xs):
            x_ext = _halo(xs)
            ys = []
            for p in ranks:
                T = R[p]
                y = apply(Jm[p], T.cells, x_ext[p], T.cell_tab)
                for m, Jf in Jfm[p].items():
                    y = y + apply(Jf, T.facets[m][0], x_ext[p],
                                  T.facets[m][4])
                ys.append(y)
            ys = _spill(ys)
            return [torch.where(R[p].ident_rows, xs[p], ys[p])
                    for p in ranks]
        return matvec

    def diag_blocks_reduced(J_e, J_f):
        """Exact owned diagonal blocks (spill-reduced), inverted."""
        D_ext = []
        for p in ranks:
            T = R[p]
            Je_diag = torch.diagonal(J_e[p], dim1=1, dim2=2)  # (C,f,f,nv)
            D = segment_sum(Je_diag.permute(0, 3, 1, 2).reshape(-1, nf * nf),
                            T.cell_tab)
            for m, Jf in J_f[p].items():
                Jf_diag = torch.diagonal(Jf, dim1=1, dim2=2)
                D = D + segment_sum(
                    Jf_diag.permute(0, 3, 1, 2).reshape(-1, nf * nf),
                    T.facets[m][4])
            D_ext.append(D.reshape(-1, nf, nf))
        Ds = _spill(D_ext)
        out = []
        for p in ranks:
            ident = R[p].ident_rows[:, :, None]
            eye = torch.eye(nf, device=devs[p])[None]
            D = torch.where(ident & (eye > 0), 1.0, Ds[p])
            D = torch.where(ident & (eye == 0), 0.0, D)
            out.append(block_inv(D))
        return out

    def build_spike_prep(J_e, J_f, Dinv_blocks):
        """Distributed SPIKE direct factorization of the full Newton
        system (see SlabPrecondPlan): per-rank f32 block-Thomas
        factorization of the owned band (elements + facets, sorted-
        segment reduction, no scatter), seam blocks exchanged one
        ppermute right, spikes by the factored local solve with h RHS
        columns, and the reduced seam system (replicated from one
        all_gather of the spike tips, or one block-row per rank with
        seam='ring').  Returns per rank the prep tuple consumed by
        ``spike_apply`` — exact up to f32 rounding.  Splitting prep from
        apply lets refresh='step'/'carried' factor once per step / per
        refresh and reuse it."""
        S, m_v, m, h, pad = pp.S, pp.m_v, pp.m, pp.h, pp.pad
        f = nf
        f32 = torch.float32
        ring_r = [(i, (i + 1) % n_dev) for i in ranks]
        wlo = (m_v - pad - pp.h_v) * f     # tail interface window start
        mid = slice(m_v, 2 * m_v)

        # --- band assembly from element + facet blocks (value order
        #     matches SlabPrecondPlan.build's destination order)
        B4 = []
        for p in ranks:
            T = R[p]
            vals = [J_e[p].reshape(-1, f * f)]
            for mk in pp.facet_markers:
                vals.append(J_f[p][mk].reshape(-1, f * f))
            bsum = _segment_reduce(torch.cat(vals, dim=0),
                                   T.order, T.start, T.end)
            B4.append(bsum.reshape(S + 1, m_v, 3 * m_v, f, f))

        # Seam exchange in RAW values (the receiver applies its own row
        # replacement and equilibration):
        # - halo-row band 0 -> right: completes the receiver's head
        #   diagonal (the last rank's halo rows hold no coupling, so the
        #   ring wraparound to rank 0 carries zeros)
        # - halo-row band -1 -> right: C_p, the receiver's head rows
        #   coupling to THIS rank's tail columns
        recv_diag = group.ppermute([b[S, :, mid] for b in B4], ring_r)
        C4s = group.ppermute([b[S, :, :m_v] for b in B4], ring_r)

        locals_ = []
        for p in ranks:
            T = R[p]
            dev = devs[p]
            b4 = B4[p][:S].clone()
            b4[0, :, mid] += recv_diag[p]
            # (S, m, 3m) band rows: row (i, r), column (j, g)
            B = b4.permute(0, 1, 3, 2, 4).reshape(S, m, 3 * m)
            Cm = C4s[p].permute(0, 2, 1, 3).reshape(m, m)
            # --- identity rows: Dirichlet + invalid + uncovered + pad
            # gap.  Row-replace BEFORE equilibrating: Dinv_blocks is the
            # inverse of the ROW-REPLACED diagonal, so equilibrating the
            # raw band would mix the ORIGINAL ident rows of A into
            # non-ident rows — an inconsistent system
            identp = T.ident_rows | (~T.cover[:N_p])[:, None]
            if pad:
                identp = torch.cat(
                    [identp, torch.ones((pad, f), dtype=torch.bool,
                                        device=dev)], dim=0)
            identp = identp.reshape(S, m)
            B = torch.where(identp[:, :, None], 0.0, B)
            torch.diagonal(B[:, :, m:2 * m], dim1=1, dim2=2).add_(
                identp.to(B.dtype))
            # C rows follow the receiver's own head-slab ident mask
            Cm = torch.where(identp[0][:, None], 0.0, Cm)

            # --- block-row equilibration (keeps the f32 bands well
            #     ranged, solve.slab.slab_prepare): each vertex's f rows
            #     times its (f, f) inverse diagonal block
            Dv = Dinv_blocks[p]
            if pad:
                Dv = torch.cat(
                    [Dv, torch.eye(f, dtype=Dv.dtype, device=dev).expand(
                        pad, f, f)], dim=0)
            Dv = Dv.reshape(S, m_v, f, f)
            B = (Dv @ B.reshape(S, m_v, f, 3 * m)).reshape(
                S, m, 3 * m).to(f32)
            Cm = (Dv[0] @ Cm.reshape(m_v, f, m)).reshape(m, m).to(f32)

            lower, diag = B[:, :, :m], B[:, :, m:2 * m]
            upper = B[:, :, 2 * m:].clone()
            # the seam blocks leave the local factorization: B_p = last
            # slab's halo coupling restricted to the neighbor's head
            # window (halo width <= bandwidth = h_v); C_p's nonzero
            # columns sit in the sender's tail window [wlo, wlo+h) by the
            # same bound
            Bp = upper[S - 1, :, :h].clone()
            upper[S - 1] = 0.0
            Cw = Cm[:, wlo:wlo + h]
            factors = slab_factor(lower, diag, upper)

            # --- spikes: V = A^-1 [0;...;0; Bp], W = A^-1 [Cw; 0;...;0]
            rhs = torch.zeros((S, m, h), dtype=f32, device=dev)
            rhs[S - 1] = Bp
            V = slab_solve(factors, rhs)
            rhs = torch.zeros((S, m, h), dtype=f32, device=dev)
            rhs[0] = Cw
            W = slab_solve(factors, rhs)
            locals_.append((factors, V, W))

        V1 = [V[0, :h] for _, V, _ in locals_]
        W1 = [W[0, :h] for _, _, W in locals_]
        VS = [V[S - 1, wlo:wlo + h] for _, V, _ in locals_]
        WS = [W[S - 1, wlo:wlo + h] for _, _, W in locals_]
        if n_dev > 1 and seam == "ring":
            # seam block-row p = [y_p ; z_{p+1}] OWNED by rank p
            # (p < n_dev-1; the last rank holds an identity pad row),
            # built with ONE ppermute from the right neighbor instead of
            # an all_gather, then factored by distributed parallel cyclic
            # reduction over the ring (_pcr_factor): O(log n_dev) (2h)^2
            # blocks per rank vs the replicated O(n_dev)
            nbr = _ring_shift([torch.stack([a, b]) for a, b in zip(V1, W1)],
                              +1, 0.0)
            Dp, Lp, Up = [], [], []
            for p in ranks:
                eye2 = torch.eye(2 * h, dtype=f32, device=devs[p])
                zero2 = torch.zeros((2 * h, 2 * h), dtype=f32,
                                    device=devs[p])
                if p < n_dev - 1:
                    D_ = eye2.clone()
                    D_[:h, h:] = VS[p]
                    D_[h:, :h] = nbr[p][1]
                    L_ = zero2.clone()
                    L_[:h, :h] = WS[p]
                    U_ = zero2.clone()
                    U_[h:, h:] = nbr[p][0]
                else:
                    D_, L_, U_ = eye2, zero2, zero2.clone()
                Dp.append(D_)
                Lp.append(L_)
                Up.append(U_)
            reds = _pcr_factor(Dp, Lp, Up)
        elif n_dev > 1:
            # reduced block-tridiagonal seam system over interface pairs
            # U_p = [y_p ; z_{p+1}] (y = tail window of rank p, z = head
            # window of rank p+1), replicated from the spike tips
            tips = group.all_gather(
                [torch.stack([a, b, c, d])
                 for a, b, c, d in zip(V1, VS, W1, WS)])  # (n_dev,4,h,h)

            def reduced_factor(tp):
                V1g, VSg, W1g, WSg = tp[:, 0], tp[:, 1], tp[:, 2], tp[:, 3]
                nseam = n_dev - 1
                dev = tp.device
                eye_h = torch.eye(h, dtype=f32, device=dev)
                Dred = torch.zeros((nseam, 2 * h, 2 * h), dtype=f32,
                                   device=dev)
                Dred[:, :h, :h] = eye_h
                Dred[:, h:, h:] = eye_h
                Dred[:, :h, h:] = VSg[:-1]
                Dred[:, h:, :h] = W1g[1:]
                Lred = torch.zeros_like(Dred)
                Lred[:, :h, :h] = WSg[:-1]
                Ured = torch.zeros_like(Dred)
                Ured[:, h:, h:] = V1g[1:]
                return slab_factor(Lred, Dred, Ured)

            reds = group.per_device(reduced_factor, tips)
        else:
            reds = [None] * n_dev

        return [(Dinv_blocks[p], locals_[p][0], locals_[p][1],
                 locals_[p][2], reds[p]) for p in ranks]

    def spike_apply(preps, rr):
        """One distributed SPIKE direct solve with a prepared
        factorization (see build_spike_prep)."""
        S, m_v, m, h, pad = pp.S, pp.m_v, pp.m, pp.h, pp.pad
        f = nf
        f32 = torch.float32
        wlo = (m_v - pad - pp.h_v) * f
        g = []
        for p in ranks:
            Dinv_blocks, factors = preps[p][0], preps[p][1]
            b = (Dinv_blocks @ rr[p][:, :, None])[:, :, 0]
            if pad:
                b = torch.cat([b, torch.zeros((pad, f), dtype=b.dtype,
                                              device=b.device)], dim=0)
            g.append(slab_solve(factors, b.reshape(S, m).to(f32)))
        if n_dev > 1 and seam == "ring":
            # distributed PCR seam solve: rhs row p = [gS_p ; g1_{p+1}]
            # assembled with one ppermute; the elimination sweep runs
            # O(log n_dev) ppermute rounds and the final seam solution
            # stays one row per rank
            g1r = _ring_shift([gp[0, :h] for gp in g], +1, 0.0)
            rhs = [torch.cat([g[p][S - 1, wlo:wlo + h], g1r[p]])
                   if p < n_dev - 1 else
                   torch.zeros((2 * h,), dtype=f32, device=devs[p])
                   for p in ranks]
            Urow = _pcr_solve([pr[4] for pr in preps], rhs)
            y_prev = _ring_shift(Urow, -1, 0.0)
            y_prev = [y[:h] for y in y_prev]      # left seam's y part
            z_next = [Urow[p][h:] if p < n_dev - 1
                      else torch.zeros_like(Urow[p][h:]) for p in ranks]
        elif n_dev > 1:
            gtips = group.all_gather(
                [torch.stack([gp[S - 1, wlo:wlo + h], gp[0, :h]])
                 for gp in g])                   # (n_dev, 2, h)

            def reduced_solve(gt, red):
                rhs_red = torch.cat([gt[:-1, 0], gt[1:, 1]], dim=-1)
                return slab_solve(red, rhs_red)  # (nseam, 2h)

            Us = group.per_device(
                lambda pair: reduced_solve(*pair),
                list(zip(gtips, [pr[4] for pr in preps])))
            y_prev = [Us[p][p - 1, :h] if p > 0
                      else torch.zeros((h,), dtype=f32, device=devs[p])
                      for p in ranks]
            z_next = [Us[p][p, h:] if p < n_dev - 1
                      else torch.zeros((h,), dtype=f32, device=devs[p])
                      for p in ranks]
        out = []
        for p in ranks:
            gp = g[p]
            if n_dev > 1:
                V, W = preps[p][2], preps[p][3]
                gp = gp - W @ y_prev[p] - V @ z_next[p]
            out.append(gp.reshape(S * m_v, f)[:N_p].to(rr[p].dtype))
        return out

    def carry_split(J_e, J_f, preps):
        """Flatten the carried chord state (local Jacobian blocks + SPIKE
        factorization) into (per-rank leaves, replicated leaves), each a
        list over ranks.  With seam='replicated' the reduced seam
        factorization is identical on every rank and travels as the
        replicated part; with seam='ring' the PCR factors are per-rank
        rows and travel with the rank's own leaves."""
        dev, rep = [], []
        for p in ranks:
            Dinv_b, factors, V, W, red = preps[p]
            d = ((J_e[p],) + tuple(J_f[p][m] for m in active_markers)
                 + (Dinv_b, factors.Dinv, factors.Cp, factors.Al, V, W))
            if red is None:
                r = ()
            elif seam == "ring":
                d = d + tuple(red)
                r = ()
            else:
                r = tuple(red)
            dev.append(d)
            rep.append(r)
        return dev, rep

    def carry_join(dev, rep):
        nfm = len(active_markers)
        J_e, J_f, preps = [], [], []
        for p in ranks:
            J_e.append(dev[p][0])
            J_f.append({m: dev[p][1 + i]
                        for i, m in enumerate(active_markers)})
            tail = dev[p][1 + nfm:]
            if seam == "ring" and n_dev > 1:
                Dinv_b, fD, fC, fA, V, W, ra, rb, rdf = tail
                red = (ra, rb, rdf)
            else:
                Dinv_b, fD, fC, fA, V, W = tail
                red = SlabFactors(*rep[p]) if rep[p] else None
            preps.append((Dinv_b, SlabFactors(fD, fC, fA), V, W, red))
        return J_e, J_f, preps

    TINY = 1e-30

    def bicgstab_sharded(matvec, Minv_apply, b):
        # the reference's breakdown guards (TINY) and overflow horizon
        def guard(xs):
            return [torch.where(torch.abs(x) < TINY,
                                torch.full_like(x, TINY), x) for x in xs]

        def div(a, b_):
            return [x / y for x, y in zip(a, b_)]

        def mul(a, b_):
            return [x * y for x, y in zip(a, b_)]

        x = [torch.zeros_like(bb) for bb in b]
        r = [bb - y for bb, y in zip(b, matvec(x))]
        rhat = r
        target = max(krylov_tol * to_host(_pnorm(b)[0]), TINY)
        p_ = [torch.zeros_like(bb) for bb in b]
        v = [torch.zeros_like(bb) for bb in b]
        one = [torch.ones((), dtype=bb.dtype, device=bb.device) for bb in b]
        rho, alpha, omega = one, one, one
        it = 0
        while True:
            rn = _pnorm(r)
            rn_h, rho_h, om_h = (float(t) for t in to_host(
                torch.stack([rn[0], rho[0], omega[0]])))
            healthy = (np.isfinite(rn_h) and np.isfinite(rho_h)
                       and np.isfinite(om_h) and abs(rho_h) > TINY
                       and abs(om_h) > TINY and rn_h < 1e12)
            if not (rn_h > target and it < krylov_maxiter and healthy):
                break
            rho_new = _pdot(rhat, r)
            beta = mul(div(rho_new, guard(rho)), div(alpha, guard(omega)))
            p_ = [ri + bt * (pi - om * vi) for ri, bt, pi, om, vi
                  in zip(r, beta, p_, omega, v)]
            phat = Minv_apply(p_)
            v = matvec(phat)
            alpha = div(rho_new, guard(_pdot(rhat, v)))
            s = [ri - al * vi for ri, al, vi in zip(r, alpha, v)]
            shat = Minv_apply(s)
            t = matvec(shat)
            omega = div(_pdot(t, s), guard(_pdot(t, t)))
            x = [xi + al * ph + om * sh for xi, al, ph, om, sh
                 in zip(x, alpha, phat, omega, shat)]
            r = [si - om * ti for si, om, ti in zip(s, omega, t)]
            rho = rho_new
            it += 1
        return x, it

    def gmres_sharded(matvec, Minv_apply, b):
        """Right-preconditioned restarted GMRES (CGS2 + Givens), every
        reduction a psum — the distributed twin of solve.linear.gmres.
        The Arnoldi basis is distributed: each rank holds its
        (restart+1, N_p*f) rows.  Each Arnoldi step reads its Hessenberg
        column on the host (one sync), where the Givens rotations, the
        ``done`` test and the small triangular solve run in f64, as in the
        single-device solver; the loop structure and the cycle test
        (``~conv & total_it < maxiter & isfinite(rnorm)``, rnorm starting
        at ||b||) are the reference's.

        BiCGStab breaks down under the f32 slab-direct preconditioner on
        the real GMPNP Jacobians (GMRES converges), the same reason the
        single-device path polishes its f32 factorization with f64
        GMRES."""
        shape = b[0].shape
        dtype = b[0].dtype
        nloc = b[0].numel()
        mv = lambda vs: [y.reshape(-1) for y in matvec(
            [v.reshape(shape) for v in vs])]
        pc = lambda vs: [y.reshape(-1) for y in Minv_apply(
            [v.reshape(shape) for v in vs])]
        bflat = [bb.reshape(-1) for bb in b]

        def pvnorm(vs):
            return [torch.sqrt(s) for s in group.psum([v @ v for v in vs])]

        bnorm = float(to_host(pvnorm(bflat)[0]))
        target = max(krylov_tol * bnorm, TINY)
        m = krylov_restart
        x = [torch.zeros(nloc, dtype=dtype, device=d) for d in devs]
        rnorm, total_it, conv = bnorm, 0, False
        while (not conv) and total_it < krylov_maxiter and np.isfinite(rnorm):
            r = [bb - y for bb, y in zip(bflat, mv(x))]
            beta_t = pvnorm(r)
            beta = float(to_host(beta_t[0]))
            V = []
            for p in ranks:
                Vp = torch.zeros((m + 1, nloc), dtype=dtype, device=devs[p])
                Vp[0] = r[p] / torch.clamp_min(beta_t[p], TINY)
                V.append(Vp)
            H = np.zeros((m + 1, m))
            cs = np.zeros(m)
            sn = np.zeros(m)
            g = np.zeros(m + 1)
            g[0] = beta
            done = beta <= target
            k = 0
            for j in range(m):
                if done:
                    break
                w = mv(pc([Vp[j] for Vp in V]))
                # CGS2: rows of V beyond j are zero -> no masking
                h1 = group.psum([Vp @ wp for Vp, wp in zip(V, w)])
                w = [wp - hp @ Vp for wp, hp, Vp in zip(w, h1, V)]
                h2 = group.psum([Vp @ wp for Vp, wp in zip(V, w)])
                w = [wp - hp @ Vp for wp, hp, Vp in zip(w, h2, V)]
                hlast = pvnorm(w)
                for p in ranks:
                    V[p][j + 1] = w[p] / torch.clamp_min(hlast[p], TINY)
                hcol_t = h1[0] + h2[0]
                hcol_t[j + 1] = hlast[0]
                hcol = np.asarray(to_host(hcol_t), np.float64)
                for i in range(j):
                    hi, hip = hcol[i], hcol[i + 1]
                    hcol[i] = cs[i] * hi + sn[i] * hip
                    hcol[i + 1] = -sn[i] * hi + cs[i] * hip
                denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                c = hcol[j] / max(denom, TINY) if denom > 0 else 1.0
                s = hcol[j + 1] / max(denom, TINY) if denom > 0 else 0.0
                hcol[j] = c * hcol[j] + s * hcol[j + 1]
                hcol[j + 1] = 0.0
                cs[j] = c
                sn[j] = s
                gj = g[j]
                g[j] = c * gj
                g[j + 1] = -s * gj
                H[:, j] = hcol[:m + 1]
                done = abs(g[j + 1]) <= target
                k += 1

            # back-substitute H[:k,:k] y = g[:k], identity-padded to m x m
            used = np.arange(m) < k
            Hsq = np.where(used[None, :] & used[:, None], H[:m, :m],
                           np.eye(m))
            gv = np.where(used, g[:m], 0.0)
            y = triangular_solve_upper(Hsq, gv)
            upd = pc([Vp[:m].T @ torch.as_tensor(y, dtype=dtype,
                                                  device=Vp.device)
                      for Vp in V])
            x = [xp + up for xp, up in zip(x, upd)]
            rnorm = float(to_host(pvnorm(
                [bb - y_ for bb, y_ in zip(bflat, mv(x))])[0]))
            total_it += k
            conv = rnorm <= target
        return [xp.reshape(shape) for xp in x], total_it

    def lifted_vals(theta):
        """Per-rank Dirichlet values with the per-step lifts applied."""
        out = []
        for T in R:
            vals = T.bc_vals
            for oh, key in T.lifts:
                vals = vals * (1.0 - oh) + _on(theta[key], T.device) * oh
            out.append(vals)
        return out

    def theta_on_ranks(theta):
        if not isinstance(theta, dict):
            return [theta] * n_dev
        return [{k: _on(v, d) for k, v in theta.items()} for d in devs]

    def step_ranks(us, ups, theta, carry=None):
        th = theta_on_ranks(theta)
        bc_vals = lifted_vals(theta)

        def residual(us_):
            u_ext = _halo(us_)
            up_ext = _halo(ups)
            rs = _spill(local_residual_ext(u_ext, up_ext, th))
            out = []
            for p in ranks:
                T = R[p]
                r = torch.where(T.bc_mask, us_[p] - bc_vals[p], rs[p])
                out.append(torch.where(T.valid[:, None], r, 0.0))
            return out

        u0 = [torch.where(R[p].bc_mask, bc_vals[p], us[p]) for p in ranks]

        def run_newton(u_init, solve_of=None, solve_fixed=None,
                       max_iter=newton_max_iter):
            """Damped Newton from ``u_init`` with DOLFIN-parity
            acceptance against u_init's own entry residual
            (rn < atol OR rn < rtol * n0)."""
            r = residual(u_init)
            n0 = float(to_host(_pnorm(r)[0]))
            conv = lambda rn: (rn < newton_atol) or (rn < newton_rtol * n0)
            u, rn, itn, lin = u_init, n0, 0, 0
            while not conv(rn) and itn < max_iter:
                solve = (solve_fixed if solve_fixed is not None
                         else solve_of(u))
                du, klin = solve(r)
                u = [ui - relaxation * di for ui, di in zip(u, du)]
                r = residual(u)
                rn = float(to_host(_pnorm(r)[0]))
                itn += 1
                lin += klin
            return u, rn, itn, lin, conv(rn)

        def jacobian_at(u):
            u_ext = _halo(u)
            up_ext = _halo(ups)
            return local_jacobian(u_ext, up_ext, th)

        def linear_solve_at(u):
            """Assemble the local Jacobian at ``u`` and return the sharded
            linear solver r -> (du, krylov_iters)."""
            J_e, J_f = jacobian_at(u)
            mv = make_matvec(J_e, J_f)
            Minv = diag_blocks_reduced(J_e, J_f)
            if pp is not None:
                prep = build_spike_prep(J_e, J_f, Minv)
                return lambda rr: gmres_sharded(
                    mv, lambda r2: spike_apply(prep, r2), rr)
            Minv_apply = lambda rr: [(Mi @ ri[:, :, None])[:, :, 0]
                                     for Mi, ri in zip(Minv, rr)]
            return lambda rr: bicgstab_sharded(mv, Minv_apply, rr)

        if refresh != "carried":
            if refresh == "step":
                u, rn, iters, lin, conv = run_newton(
                    u0, solve_fixed=linear_solve_at(u0))
            else:
                u, rn, iters, lin, conv = run_newton(
                    u0, solve_of=linear_solve_at)
            return u, (iters, conv, rn, lin)

        # ---- refresh='carried': the distributed carried-factor chord
        # Newton (solve.timeloop.make_carried_step semantics).  The chord
        # attempt runs against the CARRIED Jacobian + SPIKE factorization
        # (``us`` may be a predictor-extrapolated start; u0 projects it
        # onto the Dirichlet values); on non-convergence the step
        # re-solves with exact Newton from the SAFE previous state and
        # refreshes the carry at the accepted state.
        carry_dev, carry_rep = carry
        J_e_c, J_f_c, prep_c = carry_join(carry_dev, carry_rep)
        mv_c = make_matvec(J_e_c, J_f_c)
        u1, rn1, it1, lin1, conv1 = run_newton(
            u0,
            solve_fixed=lambda rr: gmres_sharded(
                mv_c, lambda r2: spike_apply(prep_c, r2), rr),
            max_iter=min(chord_max_iter, newton_max_iter))

        def build_carry_at(u):
            J_e2, J_f2 = jacobian_at(u)
            Dinv2 = diag_blocks_reduced(J_e2, J_f2)
            return carry_split(J_e2, J_f2,
                               build_spike_prep(J_e2, J_f2, Dinv2))

        if not conv1:
            u0_safe = [torch.where(R[p].bc_mask, bc_vals[p], ups[p])
                       for p in ranks]
            u, rn, iters, lin, conv = run_newton(
                u0_safe, solve_of=linear_solve_at)
            carry_used = build_carry_at(u)
        else:
            u, rn, iters, lin, conv = u1, rn1, it1, lin1, conv1
            carry_used = (carry_dev, carry_rep)
        # proactive refresh for the NEXT step when the stale factor made
        # this (converged) step slow; the fresh branch already refreshed
        if conv1 and it1 > refresh_iters:
            carry_new = build_carry_at(u)
        else:
            carry_new = carry_used
        return u, (iters, conv, rn, lin), carry_new

    if refresh != "carried":
        return step_ranks, group

    def prep_init(u_shard, up_shard, theta):
        """Assemble + factor the chord state at the (projected) start
        state."""
        th = theta_on_ranks(theta)
        bc_vals = lifted_vals(theta)
        u0 = [torch.where(R[p].bc_mask, bc_vals[p], u_shard[p])
              for p in ranks]
        u_ext = _halo(u0)
        up_ext = _halo(up_shard)
        J_e, J_f = local_jacobian(u_ext, up_ext, th)
        Dinv = diag_blocks_reduced(J_e, J_f)
        return carry_split(J_e, J_f, build_spike_prep(J_e, J_f, Dinv))

    return step_ranks, prep_init, group


def _stack_stats(stats):
    """Per-step stats tuples -> a tuple of numpy arrays over steps."""
    return tuple(np.asarray(col) for col in zip(*stats))


def make_sharded_transient(
    plan: ZShardPlan,
    form,
    mesh_devices,
    n_steps: int,
    theta_of_carry: Optional[Callable] = None,
    theta: Optional[dict] = None,
    record_stride: Optional[int] = None,
    **step_kwargs,
):
    """Multi-step sharded transient: a loop of the sharded implicit step.

    theta_of_carry(carry, i) -> theta computes per-step scalars from the
    GLOBAL solution (carry = (u, extra), u the (n_dev*N_p, f) plan-order
    array on rank 0's device) — e.g. the Sechenov CO2 Dirichlet value from
    solution medians — mirroring the single-device run_transient
    protocol; pass a static ``theta`` instead for frozen coefficients.
    Per-step Dirichlet value updates enter via ``bc_lifts`` (see
    make_sharded_step).

    Returns (run, group) with ``run(u0, extra0=0.0, step_offset=0) ->
    ((u_final, extra), stats)``: u0 and u_final per-rank blocks, stats a
    tuple of numpy arrays over steps (iters, converged, resnorm,
    lin_iters).  ``extra0`` and ``step_offset`` let a chunked checkpoint
    resume pass the restored carry scalar and the absolute step index, so
    theta sees the same values as an unchunked run.

    ``record_stride=k`` additionally records the (plan-order) solution
    every k-th step (k must divide n_steps); the return becomes
    ``((u_final, extra), (u_hist, stats_strided))`` with u_hist of shape
    (n_steps//k, n_dev*N_p, f) on rank 0's device, and the stats then
    also every k-th step's.

    ``max_retries=K`` (default 0) adds divergence-triggered dt halving —
    the distributed form of timeloop.make_retrying_step.  A non-converged
    step is retried from the SAFE previous state with ``theta['dt']``
    halved, up to K times; the per-step stats tuple gains a fifth element
    ``dt_scale`` (the accepted halving factor — callers tracking absolute
    time must accumulate dt*dt_scale).
    """
    refresh = step_kwargs.get("refresh", "iter")
    chord_predict = step_kwargs.pop("chord_predict", True)
    max_retries = step_kwargs.pop("max_retries", 0)
    if record_stride is not None:
        if record_stride < 1:
            raise ValueError(f"record_stride must be >= 1, got "
                             f"{record_stride}")
        if n_steps % record_stride:
            raise ValueError(f"record_stride {record_stride} must divide "
                             f"n_steps {n_steps}")

    if theta_of_carry is None:
        _theta = dict(theta or {})
        theta_of_carry = lambda carry, i: _theta

    def _dt_of(th):
        if isinstance(th, dict) and "dt" in th:
            return float(to_host(th["dt"]))
        return 1.0

    def _halved(th, k):
        th_k = dict(th)
        th_k["dt"] = _dt_of(th) * 0.5 ** k
        return th_k

    def _drive(body, c0, u_of):
        """Run ``body(c, i) -> (c_new, stats)`` over n_steps; with
        record_stride, keep (u_of(c), stats) every k-th step."""
        c, stats, hist = c0, [], []
        for i in range(n_steps):
            c, st = body(c, i)
            if record_stride is None or (i + 1) % record_stride == 0:
                stats.append(st)
                if record_stride is not None:
                    hist.append(u_of(c))
        ys = _stack_stats(stats)
        if record_stride is not None:
            ys = (torch.stack(hist), ys)
        return c, ys

    if refresh == "carried":
        # distributed carried-factor chord Newton: the local Jacobian
        # blocks + SPIKE factorization ride the carry (refreshed lazily
        # inside the step), and the decay-aware predictor of
        # solve.timeloop.make_carried_step runs here
        step_raw, prep_init, group = make_sharded_step(
            plan, form, mesh_devices, **step_kwargs)

        def pnorm_host(xs):
            return float(np.sqrt(to_host(group.psum(
                [torch.sum(x * x) for x in xs])[0])))

        def run(u0_shard, extra0=0.0, step_offset=0):
            off = int(step_offset)
            ex0 = float(np.asarray(extra0))
            th0 = theta_of_carry((group.unshard(u0_shard), ex0), off)
            chord0 = prep_init(u0_shard, u0_shard, th0)

            def body(c, i):
                u, extra, chord, du, dt_prev, nrm_prev = c
                th = theta_of_carry((group.unshard(u), extra), i + off)
                nrm_du = pnorm_host(du)
                if chord_predict:
                    # rho = observed increment decay (see timeloop.
                    # ChordCarry); du = 0 at init predicts u itself
                    rho = nrm_du / max(nrm_prev, 1e-300) if nrm_prev > 0 \
                        else 0.0
                    ratio = _dt_of(th) / dt_prev if dt_prev > 0 else 0.0
                    factor = min(max(rho * ratio, 0.0), 1.5)
                    u_start = [ui + factor * di for ui, di in zip(u, du)]
                else:
                    u_start = u
                u_new, stats, chord = step_raw(u_start, u, th, chord)
                if max_retries > 0:
                    k = 0
                    while not stats[1] and k < max_retries:
                        # retry from the safe previous state, no
                        # predictor.  The chord carry is REBUILT at the
                        # halved dt first: the carried factorization
                        # embeds dt, so a chord attempt against the
                        # un-halved factor is near-guaranteed to miss
                        th_k = _halved(th, k + 1)
                        ch_k = prep_init(u, u, th_k)
                        u_new, stats, chord = step_raw(u, u, th_k, ch_k)
                        k += 1
                    stats = (*stats, 0.5 ** k)
                du_new = [a - b for a, b in zip(u_new, u)]
                return ((u_new, extra, chord, du_new, _dt_of(th), nrm_du),
                        stats)

            zeros = [torch.zeros_like(x) for x in u0_shard]
            c, ys = _drive(body, (u0_shard, ex0, chord0, zeros, 0.0, 0.0),
                           u_of=lambda c: group.unshard(c[0]))
            return (c[0], c[1]), ys

        return run, group

    step_raw, group = make_sharded_step(
        plan, form, mesh_devices, **step_kwargs)

    def run(u0_shard, extra0=0.0, step_offset=0):
        off = int(step_offset)

        def body(c, i):
            u, extra = c
            th = theta_of_carry((group.unshard(u), extra), i + off)
            u_new, stats = step_raw(u, u, th)
            if max_retries > 0:
                k = 0
                while not stats[1] and k < max_retries:
                    u_new, stats = step_raw(u, u, _halved(th, k + 1))
                    k += 1
                stats = (*stats, 0.5 ** k)
            return (u_new, extra), stats

        return _drive(body, (u0_shard, float(np.asarray(extra0))),
                      u_of=lambda c: group.unshard(c[0]))

    return run, group


def make_sharded_pore_transient(
    prog,
    mesh_devices,
    n_steps: Optional[int] = None,
    forms=None,
    **kwargs,
):
    """Production sharded 3D pore transient from a built Pore3DProgram:
    z-slab domain decomposition + per-rank slab-direct preconditioning +
    the moving Sechenov CO2 Dirichlet BC as an arithmetic lift.

    ``forms`` (one WeakForm per rank) is needed only when the ranks span
    devices other than ``prog.device`` (the form's constants live on its
    device); by default every rank uses ``prog.form``.

    Returns (run, u0, plan) with ``run(u0) -> ((u_final, extra),
    stats)``; u0 holds the per-rank blocks of the initial state and
    ``u_final`` is (N, f) in the ORIGINAL mesh vertex order, on rank 0's
    device (the plan z-sorts shipped meshes internally; ``run``
    globalizes the final state back).  With ``record_stride=k`` the stats
    become ``(u_hist, stats)`` where u_hist is (n_steps//k, N, f) in the
    original vertex order.
    """
    cfg = prog.config
    nf = cfg.n_fields
    ns = len(cfg.species)
    N = prog.space.num_vertices
    n_dev = len(mesh_devices)
    n = prog.num_steps if n_steps is None else n_steps

    mask = prog.bc.mask.cpu().numpy()
    vals = prog.bc.values.cpu().numpy()
    plan = ZShardPlan.build(prog.mesh, nf, n_dev, mask, vals,
                            quad_degree=cfg.quad_degree)

    oh = np.zeros((N, nf))
    oh[prog.s1_verts, prog.idx["CO2"]] = 1.0
    oh = plan.localize(oh)

    def theta_of_carry(carry, i):
        # u[:N] holds every true vertex (padding rows are the tail of the
        # last rank); the Sechenov update only takes per-field medians,
        # which are permutation-invariant, so plan order is fine
        u, _ = carry
        return prog._theta_of_carry((u[:N], None), i)

    kwargs.setdefault("relaxation", cfg.newton.relaxation)
    kwargs.setdefault("newton_max_iter", cfg.newton.max_iter)
    kwargs.setdefault("newton_rtol", cfg.newton.rtol)
    kwargs.setdefault("newton_atol", cfg.newton.atol)
    run_pad, group = make_sharded_transient(
        plan, prog.form if forms is None else forms, mesh_devices, n,
        theta_of_carry=theta_of_carry,
        bc_lifts=[(oh, "co2_s1")],
        **kwargs)

    u0 = np.ones((N, nf))
    if cfg.physics == "GMPNP":
        u0[:, ns] = 0.0
    u0 = group.shard(torch.as_tensor(plan.localize(u0)))
    perm = torch.as_tensor(plan.perm, dtype=torch.int64,
                           device=group.devices[0])

    def globalize(u_pad):
        out = torch.empty((N,) + tuple(u_pad.shape[1:]), dtype=u_pad.dtype,
                          device=u_pad.device)
        out[perm] = u_pad[:N]
        return out

    def run(u0_shard, extra0=0.0, step_offset=0):
        (u_fin, extra), ys = run_pad(u0_shard, extra0, step_offset)
        if kwargs.get("record_stride") is not None:
            u_hist_pad, stats = ys
            ys = (torch.stack([globalize(r) for r in u_hist_pad]), stats)
        return (globalize(group.unshard(u_fin)), extra), ys

    return run, u0, plan
