"""Z-slab block-banded direct solver (the MUMPS replacement).

Port of ``gmpnp_tpu/solve/slab.py``.  Vertices are ordered along the pore
axis (z); with contiguous slabs of ``m_v >= bandwidth`` vertices the coupled
system is block tridiagonal in (m_v * n_fields)-sized dense blocks.  The
BlockELL Jacobian is gathered into those bands slab by slab, factored in
f32 by block-Thomas forward elimination (a Python loop over the S slabs),
and used as the preconditioner of GMRES on the block-row-equilibrated
system: f64 GMRES polishes exact-Newton directions (``slab_apply``), all-f32
GMRES gives the carried-mode chord directions (``slab_apply_f32``), whose
matvec is the hand-written block-ELL kernel (``ops.ell_spmv``).

All f32 matrix products here run in full f32 (no TF32): the solver
builders call :func:`full_f32_precision`, the counterpart of the reference's
``Precision.HIGHEST``.  Every m x m inverse keeps the reference's one
Newton-Schulz refinement pass.

``slab_mode='cr'`` replaces the Thomas scan by slab-granular block cyclic
reduction (``slab_factor_cr``): ceil(log2 S) levels of batched m x m
inverses instead of S sequential ones.

``slab_prepare`` and ``slab_prepare_lanes`` run in ``linear.factor``
spans, the applies and ``slab_direct_solve`` in ``linear.solve`` spans
(``utils.profiling``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL
from gmpnp_tpu_torch.ops.ell_spmv import ell_spmv
from gmpnp_tpu_torch.solve.smallblock import block_inv
from gmpnp_tpu_torch.utils.profiling import span


def full_f32_precision() -> None:
    """f32 matmuls in full f32 (no TF32) — process-wide PyTorch settings,
    set where a solver is built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _inv_refined(A: torch.Tensor, steps: int = 1) -> torch.Tensor:
    """Batched (..., m, m) inverse: torch.linalg.inv + Newton-Schulz."""
    X = torch.linalg.inv(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    for _ in range(steps):
        X = X @ (2.0 * eye - A @ X)
    return X


@dataclass(frozen=True)
class SlabPlan:
    """Host-side static tables for the slab relayout.

    perm[new] = old vertex id (ascending z); the padded tail maps to a
    sentinel row.  ``gidx`` maps every entry of the dense band tensor
    (S, m, 3m) to an element of the flattened (padded) BlockELL value
    array, or to the trailing zero sentinel.
    """

    S: int                  # number of slabs
    m_v: int                # vertices per slab
    f: int                  # fields per vertex
    N: int                  # true vertex count
    bandwidth: int          # adjacency bandwidth under the ordering
    perm: np.ndarray        # (S*m_v,) old vertex id per new position (pad: N)
    iperm: np.ndarray       # (N,) new position per old vertex id
    # block-level gather map: band block (s, i, j3) <- ELL block n*K + k
    # (sentinel N*K -> zero block).  Block granularity keeps the table at
    # ~(S*m_v*3*m_v)*4 bytes — f*f=81x smaller than a scalar-level map,
    # small enough to keep resident on the device.
    bidx: np.ndarray        # (S, m_v, 3*m_v) int32
    pad_eye: Tuple[np.ndarray, np.ndarray, np.ndarray]  # identity rows (s,i,j)
    # device copies of perm/iperm/bidx, keyed by device (filled on use)
    _dev: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def m(self) -> int:
        return self.m_v * self.f

    @staticmethod
    def build(adj: np.ndarray, order_coord: np.ndarray, n_fields: int,
              diag_slot: np.ndarray,
              max_slabs: Optional[int] = None) -> "SlabPlan":
        """adj: (N, K) padded sorted neighbor table (fem.FemSpace.adj);
        order_coord: (N,) coordinate to sort by (z for the pore, x for 1D);
        diag_slot: (N,) position of the self entry in each adjacency row."""
        adj = np.asarray(adj)
        N, K = adj.shape
        f = n_fields

        perm_n = np.argsort(np.asarray(order_coord), kind="stable")
        iperm = np.empty(N, dtype=np.int64)
        iperm[perm_n] = np.arange(N)

        bw = int(np.abs(iperm[adj] - iperm[np.arange(N)][:, None]).max())
        m_v = max(bw, 1)
        if max_slabs is not None:
            m_v = max(m_v, -(-N // max_slabs))
        S = max(-(-N // m_v), 1)
        # even out slab sizes — but never below the bandwidth, or in-band
        # couplings would be silently dropped by the |band|<=1 filter
        # below (latent here, bit the sharded precond at N_p=162/bw=36,
        # probes/probe_r3_j.py)
        m_v = max(-(-N // S), bw, 1)
        S = -(-N // m_v)
        N_pad = S * m_v
        m = m_v * f

        perm = np.concatenate(
            [perm_n, np.full(N_pad - N, N, dtype=np.int64)])

        # --- block gather map: band block (s, i, (b+1)*m_v + pj) <- ELL
        #     block n*K + k for n = perm[s*m_v+i], j = adj[n, k],
        #     b = slab(j) - s, pj = pos(j) in its slab.
        bidx = np.full((S, m_v, 3 * m_v), N * K, dtype=np.int64)
        nn = np.arange(N)
        s_of = iperm // m_v            # (N,)
        p_of = iperm % m_v
        diag_slot = np.asarray(diag_slot)
        for k in range(K):
            nj = adj[:, k]
            # skip padded duplicate self-slots (zero blocks aliasing the
            # diagonal): only the true diag_slot entry carries the diagonal
            keep = (nj != nn) | (k == diag_slot)
            band = s_of[nj] - s_of
            keep &= np.abs(band) <= 1   # guaranteed by m_v >= bw
            idx = np.nonzero(keep)[0]
            if len(idx) == 0:
                continue
            bidx[s_of[idx], p_of[idx],
                 (band[idx] + 1) * m_v + p_of[nj[idx]]] = idx * K + k

        # identity rows for the padded tail
        pad_pos = np.arange(N, N_pad)
        ps = pad_pos // m_v
        pi = (pad_pos % m_v)[:, None] * f + np.arange(f)[None, :]
        ps = np.repeat(ps, f)
        pi = pi.reshape(-1)
        pj = m + pi  # diagonal band, same in-block index

        return SlabPlan(
            S=S, m_v=m_v, f=f, N=N, bandwidth=bw,
            perm=perm, iperm=iperm,
            bidx=bidx.astype(np.int32),
            pad_eye=(ps.astype(np.int32), pi.astype(np.int32),
                     pj.astype(np.int32)))

    def _index(self, device) -> dict:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = {name: torch.as_tensor(getattr(self, name), dtype=torch.int64,
                                       device=device)
                 for name in ("perm", "iperm", "bidx")}
            self._dev[key] = t
        return t

    # -- vector relayout ---------------------------------------------------

    def to_slabs(self, x: torch.Tensor) -> torch.Tensor:
        """(N, f) -> (S, m) in slab ordering (padded tail = 0)."""
        xp = torch.cat([x, torch.zeros((1, self.f), dtype=x.dtype,
                                       device=x.device)], dim=0)
        return xp[self._index(x.device)["perm"]].reshape(self.S, self.m)

    def from_slabs(self, xs: torch.Tensor) -> torch.Tensor:
        """(S, m) -> (N, f) in original vertex ordering."""
        flat = xs.reshape(self.S * self.m_v, self.f)
        return flat[self._index(xs.device)["iperm"]]

    def to_slabs_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """(V, N, f) -> (V, S, m), ``to_slabs`` of every lane."""
        V = x.shape[0]
        xp = torch.cat([x, torch.zeros((V, 1, self.f), dtype=x.dtype,
                                       device=x.device)], dim=1)
        return xp[:, self._index(x.device)["perm"]].reshape(V, self.S,
                                                            self.m)

    def from_slabs_lanes(self, xs: torch.Tensor) -> torch.Tensor:
        """(V, S, m) -> (V, N, f), ``from_slabs`` of every lane."""
        V = xs.shape[0]
        flat = xs.reshape(V, self.S * self.m_v, self.f)
        return flat[:, self._index(xs.device)["iperm"]]

    def bands(self, ell: BlockELL, dtype=torch.float32):
        """Relayout a BlockELL matrix into (lower, diag, upper) dense bands
        of shape (S, m, m) each, in ``dtype`` (tests; the factorization
        gathers slab by slab, see ``_band_of_slab_fn``)."""
        N, K, f, _ = ell.shape4
        dev = ell.flat.device
        blk = ell.blocks4().to(dtype).reshape(N * K, f, f)
        blk = torch.cat([blk, torch.zeros((1, f, f), dtype=dtype,
                                          device=dev)], dim=0)
        B4 = blk[self._index(dev)["bidx"]]          # (S, m_v, 3m_v, f, f)
        m = self.m
        B = B4.permute(0, 1, 3, 2, 4).reshape(self.S, m, 3 * m)
        ps, pi, pj = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                      for a in self.pad_eye)
        if len(ps):
            B[ps, pi, pj] = 1.0
        return B[:, :, :m], B[:, :, m:2 * m], B[:, :, 2 * m:]


class SlabFactors(NamedTuple):
    Dinv: torch.Tensor   # (S, m, m) inverses of the eliminated diagonals
    Cp: torch.Tensor     # (S, m, m) Dinv @ upper
    Al: torch.Tensor     # (S, m, m) original lower band


def _band_of_slab_fn(ell: BlockELL, plan: SlabPlan, dtype=torch.float32):
    """Closure s -> (lower, diag, upper) bands of slab ``s``, each (m, m),
    gathered from the BlockELL blocks by the plan's block map."""
    N, K, f, _ = ell.shape4
    m, m_v = plan.m, plan.m_v
    dev = ell.flat.device
    blk = ell.blocks4().to(dtype).reshape(N * K, f, f)
    blk = torch.cat([blk, torch.zeros((1, f, f), dtype=dtype, device=dev)],
                    dim=0)
    bidx = plan._index(dev)["bidx"]               # (S, m_v, 3m_v)
    # identity rows (diagonal band) for the padded tail of the last slab
    eye_band = torch.cat(
        [torch.zeros((m, m), dtype=dtype, device=dev),
         torch.eye(m, dtype=dtype, device=dev),
         torch.zeros((m, m), dtype=dtype, device=dev)], dim=1)   # (m, 3m)

    def band_of_slab(s: int):
        B4 = blk[bidx[s]]                         # (m_v, 3m_v, f, f)
        B = B4.permute(0, 2, 1, 3).reshape(m, 3 * m)
        n_pad = (s + 1) * m_v - plan.N            # padded rows of this slab
        if n_pad > 0:
            B = B.clone()
            B[m - n_pad * f:] = eye_band[m - n_pad * f:]
        return B[:, :m], B[:, m:2 * m], B[:, 2 * m:]

    return band_of_slab


def slab_factor_fused(ell: BlockELL, plan: SlabPlan,
                      dtype=torch.float32) -> SlabFactors:
    """Block-Thomas forward elimination with the band gather per slab: S
    sequential steps of two m x m products and one refined m x m
    inverse."""
    m, S = plan.m, plan.S
    band_of_slab = _band_of_slab_fn(ell, plan, dtype)
    Cp_prev = torch.zeros((m, m), dtype=dtype, device=ell.flat.device)
    Dinvs, Cps, Als = [], [], []
    for s in range(S):
        A, Bd, C = band_of_slab(s)
        denom = Bd - A @ Cp_prev
        Dinv = _inv_refined(denom)
        Cp_prev = Dinv @ C
        Dinvs.append(Dinv)
        Cps.append(Cp_prev)
        Als.append(A)
    return SlabFactors(Dinv=torch.stack(Dinvs), Cp=torch.stack(Cps),
                       Al=torch.stack(Als))


def _band_of_slab_lanes_fn(ell: BlockELL, plan: SlabPlan,
                           dtype=torch.float32):
    """``_band_of_slab_fn`` of a lane-batched BlockELL: s -> (lower, diag,
    upper) of slab ``s`` in every lane, each (V, m, m)."""
    V = ell.lanes
    N, K, f, _ = ell.shape4
    m, m_v = plan.m, plan.m_v
    dev = ell.flat.device
    blk = ell.flat.reshape(V, N, f, K, f).transpose(2, 3).to(dtype)
    blk = torch.cat([blk.reshape(V, N * K, f, f),
                     torch.zeros((V, 1, f, f), dtype=dtype, device=dev)],
                    dim=1)
    bidx = plan._index(dev)["bidx"]
    eye_band = torch.cat(
        [torch.zeros((m, m), dtype=dtype, device=dev),
         torch.eye(m, dtype=dtype, device=dev),
         torch.zeros((m, m), dtype=dtype, device=dev)], dim=1)

    def band_of_slab(s: int):
        B4 = blk[:, bidx[s]]                      # (V, m_v, 3m_v, f, f)
        B = B4.permute(0, 1, 3, 2, 4).reshape(V, m, 3 * m)
        n_pad = (s + 1) * m_v - plan.N
        if n_pad > 0:
            B = B.clone()
            B[:, m - n_pad * f:] = eye_band[m - n_pad * f:]
        return B[:, :, :m], B[:, :, m:2 * m], B[:, :, 2 * m:]

    return band_of_slab


def _inv_refined_lanes(A: torch.Tensor) -> torch.Tensor:
    """``_inv_refined`` of each lane's (m, m) block of A (V, m, m), one
    inverse call per lane: on the H100 one batched ``torch.linalg.inv`` of
    three 918 x 918 f32 blocks takes 2.1x the time of three single calls
    (``python3 chip_smoke.py --profile``), so the lanes take the
    single-lane call and its Newton-Schulz pass, lane by lane."""
    return torch.stack([_inv_refined(a) for a in A])


def slab_factor_fused_lanes(ell: BlockELL, plan: SlabPlan,
                            dtype=torch.float32) -> SlabFactors:
    """``slab_factor_fused`` of V lanes: the same S sequential steps, the
    band gathers and products of each one batched call over the lanes, the
    refined m x m inverses one per lane (``_inv_refined_lanes``), in full
    f32 under ``full_f32_precision``.  Factors are (V, S, m, m)."""
    V, m, S = ell.lanes, plan.m, plan.S
    band_of_slab = _band_of_slab_lanes_fn(ell, plan, dtype)
    Cp_prev = torch.zeros((V, m, m), dtype=dtype, device=ell.flat.device)
    Dinvs, Cps, Als = [], [], []
    for s in range(S):
        A, Bd, C = band_of_slab(s)
        Dinv = _inv_refined_lanes(Bd - A @ Cp_prev)
        Cp_prev = Dinv @ C
        Dinvs.append(Dinv)
        Cps.append(Cp_prev)
        Als.append(A)
    return SlabFactors(Dinv=torch.stack(Dinvs, 1), Cp=torch.stack(Cps, 1),
                       Al=torch.stack(Als, 1))


def slab_solve_lanes(factors: SlabFactors, d: torch.Tensor) -> torch.Tensor:
    """``slab_solve`` of V lanes: factors (V, S, m, m), d (V, S, m)."""
    Dinvs, Cps, Al = factors
    S = d.shape[1]
    dp = torch.zeros((d.shape[0], d.shape[2], 1), dtype=d.dtype,
                     device=d.device)
    dps = []
    for s in range(S):
        dp = Dinvs[:, s] @ (d[:, s, :, None] - Al[:, s] @ dp)
        dps.append(dp)
    x = torch.zeros_like(dp)
    xs = [None] * S
    for s in range(S - 1, -1, -1):
        x = dps[s] - Cps[:, s] @ x
        xs[s] = x
    return torch.stack(xs, 1)[..., 0]


def slab_factor(lower: torch.Tensor, diag: torch.Tensor,
                upper: torch.Tensor) -> SlabFactors:
    """Block-Thomas forward elimination of given (S, m, m) bands (the
    unfused form of ``slab_factor_fused``)."""
    m = diag.shape[1]
    Cp_prev = torch.zeros((m, m), dtype=diag.dtype, device=diag.device)
    Dinvs, Cps = [], []
    for A, Bd, C in zip(lower, diag, upper):
        Dinv = _inv_refined(Bd - A @ Cp_prev)
        Cp_prev = Dinv @ C
        Dinvs.append(Dinv)
        Cps.append(Cp_prev)
    return SlabFactors(Dinv=torch.stack(Dinvs), Cp=torch.stack(Cps),
                       Al=lower)


def slab_solve(factors: SlabFactors, d: torch.Tensor) -> torch.Tensor:
    """Solve with precomputed factors; d, result: (S, m) — or (S, m, k)
    for k simultaneous right-hand sides.  A forward and a backward sweep of
    matrix-(multi)vector products."""
    Dinvs, Cps, Al = factors
    S = d.shape[0]
    dp = torch.zeros(d.shape[1:], dtype=d.dtype, device=d.device)
    dps = []
    for s in range(S):
        dp = Dinvs[s] @ (d[s] - Al[s] @ dp)
        dps.append(dp)
    x = torch.zeros_like(dp)
    xs = [None] * S
    for s in range(S - 1, -1, -1):
        x = dps[s] - Cps[s] @ x
        xs[s] = x
    return torch.stack(xs)


class CRLevel(NamedTuple):
    """One elimination level of the slab-granular block cyclic reduction.

    Odd-position slabs of this level are eliminated; even positions form
    the next (coarser) level.  ``L``/``U`` act on the even positions in
    the downward RHS pass; ``invBo``/``Ao``/``Co`` reconstruct the odd
    solutions in the upward pass."""

    invBo: torch.Tensor   # (n_odd, m, m) inverses of the odd diagonals
    L: torch.Tensor       # (n_even, m, m) A_even @ invBo[left]  (row 0 = 0)
    U: torch.Tensor       # (n_even, m, m) C_even @ invBo[right] (pad = 0)
    Ao: torch.Tensor      # (n_odd, m, m) original odd lower band
    Co: torch.Tensor      # (n_odd, m, m) original odd upper band


class CRFactors(NamedTuple):
    levels: tuple           # fine-to-coarse CRLevel records
    root_inv: torch.Tensor  # (m, m) inverse of the final single block


def _cr_level(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """One block-cyclic-reduction elimination step on (S, m, m) bands.

    Returns the level record plus the (ceil(S/2), m, m) bands of the
    Schur complement on the even positions; the level's inversions are
    one batched call.  Odd S is padded to even with a decoupled identity
    row (A=C=0, B=I) at the tail, and odd/even positions are split by a
    reshape, as in the reference."""
    S, m = A.shape[0], A.shape[1]
    if S % 2 == 1:   # pad: x_pad = d_pad, fully decoupled
        eye = torch.eye(m, dtype=A.dtype, device=A.device)[None]
        zpad = torch.zeros((1, m, m), dtype=A.dtype, device=A.device)
        A = torch.cat([A, zpad])
        B = torch.cat([B, eye])
        C = torch.cat([C, zpad])
        S += 1
    h = S // 2
    Ae, Ao = A.reshape(h, 2, m, m).unbind(1)
    Be, Bo = B.reshape(h, 2, m, m).unbind(1)
    Ce, Co = C.reshape(h, 2, m, m).unbind(1)
    invBo = _inv_refined(Bo)
    zero = torch.zeros((1, m, m), dtype=A.dtype, device=A.device)

    # L_j = A[2j] @ invBo[j-1]  (j >= 1; slab 0 has no left neighbor)
    L = torch.cat([zero, Ae[1:] @ invBo[:h - 1]])
    # U_j = C[2j] @ invBo[j]    (the padded tail's Ce row is zero)
    U = Ce @ invBo

    Co_prev = torch.cat([zero, Co[:h - 1]])       # C[2j-1]
    B2 = Be - L @ Co_prev - U @ Ao
    A2 = -torch.cat([zero, L[1:] @ Ao[:h - 1]])
    C2 = -(U @ Co)
    return CRLevel(invBo=invBo, L=L, U=U, Ao=Ao, Co=Co), (A2, B2, C2)


def slab_factor_cr(lower: torch.Tensor, diag: torch.Tensor,
                   upper: torch.Tensor) -> CRFactors:
    """Block cyclic reduction over slabs: ceil(log2 S) levels of batched
    m x m inversions and matmuls instead of block-Thomas's S sequential
    inversions (~3x the matmul FLOPs)."""
    levels = []
    A, B, C = lower, diag, upper
    while A.shape[0] > 1:
        lvl, (A, B, C) = _cr_level(A, B, C)
        levels.append(lvl)
    return CRFactors(levels=tuple(levels), root_inv=_inv_refined(B[0]))


def slab_factor_cr_fused(ell: BlockELL, plan: SlabPlan,
                         dtype=torch.float32) -> CRFactors:
    """Band relayout (per-slab gather, see ``_band_of_slab_fn``) followed
    by the cyclic-reduction factorization."""
    band_of_slab = _band_of_slab_fn(ell, plan, dtype)
    lo, di, up = (torch.stack(b) for b in
                  zip(*(band_of_slab(s) for s in range(plan.S))))
    return slab_factor_cr(lo, di, up)


def slab_solve_cr(factors: CRFactors, d: torch.Tensor) -> torch.Tensor:
    """Solve with a CR factorization; d, result: (S, m) or (S, m, k).
    2*ceil(log2 S) batched stages."""
    vec = d.dim() == 2
    if vec:
        d = d[..., None]
    stack = []
    for lvl in factors.levels:
        S_l = d.shape[0]
        if S_l % 2 == 1:
            d = torch.cat([d, torch.zeros((1,) + tuple(d.shape[1:]),
                                          dtype=d.dtype, device=d.device)])
        h = d.shape[0] // 2
        de, do = d.reshape(h, 2, *d.shape[1:]).unbind(1)
        zero = torch.zeros((1,) + tuple(d.shape[1:]), dtype=d.dtype,
                           device=d.device)
        do_prev = torch.cat([zero, do[:h - 1]])
        stack.append((do, S_l))
        d = de - lvl.L @ do_prev - lvl.U @ do
    x = (factors.root_inv @ d[0])[None]           # (1, m, k)
    for lvl, (do, S_l) in zip(reversed(factors.levels), reversed(stack)):
        h = do.shape[0]
        zero = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
        xe_next = torch.cat([x[1:], zero])
        xo = lvl.invBo @ (do - lvl.Ao @ x - lvl.Co @ xe_next)
        x = torch.stack([x, xo], dim=1).reshape(2 * h, *x.shape[1:])
        if S_l % 2 == 1:
            x = x[:S_l]
    return x[..., 0] if vec else x


def _cr_level_lanes(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """``_cr_level`` of V lanes: bands (V, S, m, m); the level's products
    one batched call over the lanes, its refined inverses one call per
    lane (``_inv_refined_lanes``), each lane's as the single lane's."""
    V, S, m = A.shape[0], A.shape[1], A.shape[2]
    if S % 2 == 1:
        eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(V, 1, m, m)
        zpad = torch.zeros((V, 1, m, m), dtype=A.dtype, device=A.device)
        A = torch.cat([A, zpad], 1)
        B = torch.cat([B, eye], 1)
        C = torch.cat([C, zpad], 1)
        S += 1
    h = S // 2
    Ae, Ao = A.reshape(V, h, 2, m, m).unbind(2)
    Be, Bo = B.reshape(V, h, 2, m, m).unbind(2)
    Ce, Co = C.reshape(V, h, 2, m, m).unbind(2)
    invBo = _inv_refined_lanes(Bo)
    zero = torch.zeros((V, 1, m, m), dtype=A.dtype, device=A.device)
    L = torch.cat([zero, Ae[:, 1:] @ invBo[:, :h - 1]], 1)
    U = Ce @ invBo
    Co_prev = torch.cat([zero, Co[:, :h - 1]], 1)
    B2 = Be - L @ Co_prev - U @ Ao
    A2 = -torch.cat([zero, L[:, 1:] @ Ao[:, :h - 1]], 1)
    C2 = -(U @ Co)
    return CRLevel(invBo=invBo, L=L, U=U, Ao=Ao, Co=Co), (A2, B2, C2)


def slab_factor_cr_fused_lanes(ell: BlockELL, plan: SlabPlan,
                               dtype=torch.float32) -> CRFactors:
    """``slab_factor_cr_fused`` of V lanes: every factor gains the lane
    axis ((V, h, m, m) per level, ``root_inv`` (V, m, m))."""
    band_of_slab = _band_of_slab_lanes_fn(ell, plan, dtype)
    A, B, C = (torch.stack(b, 1) for b in
               zip(*(band_of_slab(s) for s in range(plan.S))))
    levels = []
    while A.shape[1] > 1:
        lvl, (A, B, C) = _cr_level_lanes(A, B, C)
        levels.append(lvl)
    return CRFactors(levels=tuple(levels),
                     root_inv=_inv_refined_lanes(B[:, 0]))


def _mm_lanes(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` of V lanes, A (V, h, m, m), x (V, h, m, k): one batched
    product, but lane by lane where h == 1, where the single-lane call
    (a batch of one) takes another product."""
    if A.shape[1] > 1:
        return A @ x
    return torch.stack([a @ b for a, b in zip(A, x)])


def slab_solve_cr_lanes(factors: CRFactors, d: torch.Tensor) -> torch.Tensor:
    """``slab_solve_cr`` of V lanes: d (V, S, m) -> (V, S, m)."""
    V = d.shape[0]
    d = d[..., None]
    stack = []
    for lvl in factors.levels:
        S_l = d.shape[1]
        if S_l % 2 == 1:
            d = torch.cat([d, torch.zeros((V, 1) + tuple(d.shape[2:]),
                                          dtype=d.dtype, device=d.device)], 1)
        h = d.shape[1] // 2
        de, do = d.reshape(V, h, 2, *d.shape[2:]).unbind(2)
        zero = torch.zeros((V, 1) + tuple(d.shape[2:]), dtype=d.dtype,
                           device=d.device)
        do_prev = torch.cat([zero, do[:, :h - 1]], 1)
        stack.append((do, S_l))
        d = de - _mm_lanes(lvl.L, do_prev) - _mm_lanes(lvl.U, do)
    # the root solve lane by lane, ``slab_solve_cr``'s own product
    x = torch.stack([ri @ dl for ri, dl in zip(factors.root_inv,
                                               d[:, 0])])[:, None]
    for lvl, (do, S_l) in zip(reversed(factors.levels), reversed(stack)):
        h = do.shape[1]
        zero = torch.zeros((V, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                           device=x.device)
        xe_next = torch.cat([x[:, 1:], zero], 1)
        xo = _mm_lanes(lvl.invBo, do - _mm_lanes(lvl.Ao, x)
                       - _mm_lanes(lvl.Co, xe_next))
        x = torch.stack([x, xo], dim=2).reshape(V, 2 * h, *x.shape[2:])
        if S_l % 2 == 1:
            x = x[:, :S_l]
    return x[..., 0]


def _solver_of(factors):
    return slab_solve_cr if isinstance(factors, CRFactors) else slab_solve


class SlabSolveResult(NamedTuple):
    x: torch.Tensor
    resnorm: float
    iters: int                # GMRES iterations used
    converged: bool


class SlabPrepared(NamedTuple):
    """Equilibrated system + f32 factorization, reusable across solves
    (refresh='step' within a time step, 'carried' across steps)."""
    ell_eq: BlockELL          # equilibrated matrix (f64)
    Dinv0: torch.Tensor       # (N, f, f) block-row scaling
    factors: object           # f32 SlabFactors (Thomas) or CRFactors


@span("linear.factor")
def slab_prepare(ell: BlockELL, plan: SlabPlan,
                 mode: str = "thomas") -> SlabPrepared:
    """Equilibrate in f64, relayout to bands, factor in f32.

    mode='thomas': sequential block-Thomas (S sequential m x m
    inversions); mode='cr': slab-granular block cyclic reduction (batched
    inversions, ceil(log2 S) levels) — see slab_factor_cr."""
    Dinv0 = block_inv(ell.diag_blocks())
    ell_eq = ell.scale_rows(Dinv0)
    factor = slab_factor_cr_fused if mode == "cr" else slab_factor_fused
    return SlabPrepared(ell_eq=ell_eq, Dinv0=Dinv0,
                        factors=factor(ell_eq, plan))


@span("linear.factor")
def slab_prepare_lanes(ell: BlockELL, plan: SlabPlan,
                       mode: str = "thomas") -> SlabPrepared:
    """``slab_prepare`` of a lane-batched BlockELL: per-lane f64
    equilibration, the f32 factorization of every lane at once (``mode``
    'thomas' or 'cr'), and the equilibrated matrices laid out for the
    kernel's lane axis (``ops.ell_spmv.lane_aligned``: every lane's matrix
    on a 16-byte boundary)."""
    from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned

    Dinv0 = block_inv(ell.diag_blocks())
    ell_eq = ell.scale_rows(Dinv0)
    ell_eq = BlockELL(ell_eq.adj, lane_aligned(ell_eq.flat),
                      ell_eq.diag_slot)
    factor = (slab_factor_cr_fused_lanes if mode == "cr"
              else slab_factor_fused_lanes)
    return SlabPrepared(ell_eq=ell_eq, Dinv0=Dinv0,
                        factors=factor(ell_eq, plan))


@span("linear.solve")
def slab_apply_lanes(
    prep: SlabPrepared,
    rhs: torch.Tensor,
    plan: SlabPlan,
    tol: float = 1.0e-8,
    max_refine: int = 40,
    active=None,
) -> SlabSolveResult:
    """``slab_apply`` of V lanes (from ``slab_prepare_lanes``): rhs
    (V, N, f); f64 GMRES over lanes (``gmres_lanes``: each lane stops on
    its own) whose matvec is one launch of the kernel's lane axis, and the
    f32 banded solve of every lane.  ``active`` (V,) bool leaves the other
    lanes out.  ``resnorm``, ``iters`` and ``converged`` are (V,) arrays."""
    from gmpnp_tpu_torch.solve.linear import gmres_lanes

    out_dtype = rhs.dtype
    b = torch.einsum("vnfg,vng->vnf", prep.Dinv0, rhs)

    solver = (slab_solve_cr_lanes if isinstance(prep.factors, CRFactors)
              else slab_solve_lanes)

    def solve32(r64):
        ds = plan.to_slabs_lanes(r64.to(torch.float32))
        xs = solver(prep.factors, ds)
        return plan.from_slabs_lanes(xs).to(out_dtype)

    res = gmres_lanes(prep.ell_eq.matvec, b, Minv=solve32, tol=tol,
                      restart=min(max_refine, 30), maxiter=max_refine,
                      active=active)
    return SlabSolveResult(x=res.x, resnorm=res.resnorm, iters=res.iters,
                           converged=res.converged)


@span("linear.solve")
def slab_apply(
    prep: SlabPrepared,
    rhs: torch.Tensor,
    plan: SlabPlan,
    tol: float = 1.0e-8,
    max_refine: int = 40,
) -> SlabSolveResult:
    """Solve ``ell @ x = rhs`` with a prepared factorization: f64 GMRES on
    the equilibrated system (matvec ``BlockELL.matvec``, the f64 kernel on
    CUDA), preconditioned by the f32 banded solve."""
    from gmpnp_tpu_torch.solve.linear import gmres

    out_dtype = rhs.dtype
    b = torch.einsum("nfg,ng->nf", prep.Dinv0, rhs)
    solver = _solver_of(prep.factors)

    def solve32(r64):
        ds = plan.to_slabs(r64.to(torch.float32))
        xs = solver(prep.factors, ds)
        return plan.from_slabs(xs).to(out_dtype)

    res = gmres(prep.ell_eq.matvec, b, Minv=solve32, tol=tol,
                restart=min(max_refine, 30), maxiter=max_refine)
    return SlabSolveResult(x=res.x, resnorm=res.resnorm, iters=res.iters,
                           converged=res.converged)


@span("linear.solve")
def slab_apply_f32(
    prep: SlabPrepared,
    rhs: torch.Tensor,
    plan: SlabPlan,
    tol: float = 1.0e-5,
    max_refine: int = 16,
) -> SlabSolveResult:
    """Chord-direction solve of ``ell @ x = rhs`` in native f32.

    The carried-mode chord directions (LinearConfig.refresh='carried',
    chord_dtype='f32') do not need slab_apply's f64 polish: their error is
    dominated by Jacobian staleness, and Newton certifies convergence on the
    true f64 residual.  The whole preconditioned GMRES runs in f32: the f32
    banded solve, the hand-written block-ELL kernel (``ops.ell_spmv``) as
    the matvec, and f32 CGS2/Givens.

    The f32 cast of the carried matrix happens once per call, outside the
    GMRES loop; each GMRES iteration is one kernel launch plus the banded
    solve.
    """
    from gmpnp_tpu_torch.solve.linear import gmres

    out_dtype = rhs.dtype
    Dinv32 = prep.Dinv0.to(torch.float32)
    b = torch.einsum("nfg,ng->nf", Dinv32, rhs.to(torch.float32))
    # hoisted once per call: the f32 copy the kernel reads
    flat32 = prep.ell_eq.flat.to(torch.float32).contiguous()
    adj = prep.ell_eq.adj
    solver = _solver_of(prep.factors)

    def mv(x32):
        return ell_spmv(flat32, adj, x32)

    def pc(r32):
        return plan.from_slabs(solver(prep.factors, plan.to_slabs(r32)))

    res = gmres(mv, b, Minv=pc, tol=tol,
                restart=min(max_refine, 16), maxiter=max_refine)
    return SlabSolveResult(x=res.x.to(out_dtype), resnorm=res.resnorm,
                           iters=res.iters, converged=res.converged)


@span("linear.solve")
def slab_direct_solve(
    ell: BlockELL,
    rhs: torch.Tensor,
    plan: SlabPlan,
    tol: float = 1.0e-8,
    max_refine: int = 40,
    mode: str = "thomas",
) -> SlabSolveResult:
    """Mixed-precision direct solve of ``ell @ x = rhs``: f64 block-row
    equilibration, f32 band factorization (``mode`` 'thomas' or 'cr'), f64
    GMRES preconditioned by the f32 solve (``iters`` counts GMRES
    iterations)."""
    return slab_apply(slab_prepare(ell, plan, mode=mode), rhs, plan,
                      tol=tol, max_refine=max_refine)
