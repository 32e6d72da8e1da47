"""Numerical state from numpy arrays to port objects on a chosen device.

The system has no learned weights; what moves between ``gmpnp_tpu`` and
this port is numerical state — an assembled Jacobian, a slab or CR
factorization, Dirichlet data, the carried chord state.  These functions
take numpy arrays as the reference hands them out (``np.asarray`` of its
arrays) and build the port's objects from them.
"""

from __future__ import annotations

import numpy as np
import torch

from gmpnp_tpu_torch.fem.assembly import BlockELL
from gmpnp_tpu_torch.fem.dirichlet import DirichletBC
from gmpnp_tpu_torch.solve.linear import CRFactors, _CRLevel
from gmpnp_tpu_torch.solve.slab import SlabFactors, SlabPrepared
from gmpnp_tpu_torch.solve.timeloop import ChordCarry


def _float(a, device, dtype=None) -> torch.Tensor:
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.float32 if a.dtype == np.float32 else torch.float64
    return torch.tensor(a, dtype=dtype, device=device)


def blockell_from_numpy(adj, flat, diag_slot, device="cpu") -> BlockELL:
    """BlockELL from (N, K) adjacency, (N, f, K*f) values (dtype kept:
    float32 stays float32, anything else becomes float64) and (N,)
    diagonal slots."""
    return BlockELL(
        adj=torch.tensor(np.asarray(adj), dtype=torch.int32, device=device),
        flat=_float(flat, device),
        diag_slot=torch.tensor(np.asarray(diag_slot), dtype=torch.int64,
                               device=device))


def slab_prepared_from_numpy(adj, flat, diag_slot, Dinv0, Dinv, Cp, Al,
                             device="cpu") -> SlabPrepared:
    """SlabPrepared from the equilibrated matrix (adj, flat, diag_slot), its
    (N, f, f) block-row scaling Dinv0 and the f32 Thomas factors
    (Dinv, Cp, Al), each (S, m, m)."""
    return SlabPrepared(
        ell_eq=blockell_from_numpy(adj, flat, diag_slot, device),
        Dinv0=_float(Dinv0, device, torch.float64),
        factors=SlabFactors(*(_float(a, device, torch.float32)
                              for a in (Dinv, Cp, Al))))


def cr_factors_from_numpy(levels, Binv_top, device="cpu") -> CRFactors:
    """CRFactors from a block-CR factorization as numpy arrays: ``levels``
    a sequence of (alpha, gamma, A_od, C_od, Binv_od) tuples, each (h, f,
    f), and the (f, f) ``Binv_top`` (dtype kept, as in
    blockell_from_numpy)."""
    return CRFactors(
        levels=tuple(_CRLevel(*(_float(a, device) for a in lev))
                     for lev in levels),
        Binv_top=_float(Binv_top, device))


def dirichlet_from_numpy(mask, values, device="cpu") -> DirichletBC:
    """DirichletBC from an (N, f) bool mask and (N, f) values."""
    return DirichletBC(
        torch.tensor(np.asarray(mask, dtype=bool), device=device),
        _float(values, device, torch.float64))


def chord_carry_from_numpy(prep, du, dt_prev, du_nrm_prev,
                           device="cpu") -> ChordCarry:
    """ChordCarry from a SlabPrepared or CRFactors (see
    slab_prepared_from_numpy, cr_factors_from_numpy), the (N, f) increment
    du and the scalars dt_prev and du_nrm_prev."""
    return ChordCarry(prep=prep, du=_float(du, device, torch.float64),
                      dt_prev=float(np.asarray(dt_prev)),
                      du_nrm_prev=float(np.asarray(du_nrm_prev)))


def shard_carry_from_numpy(carry_dev, carry_rep, devices):
    """The sharded carried chord state (``parallel.shard``'s
    ``prep_init`` output) from the reference's ``(carry_dev, carry_rep)``
    as numpy arrays: every ``carry_dev`` leaf with a leading n_dev axis
    (row p is rank p's), every ``carry_rep`` leaf replicated.  Returns
    ``(dev, rep)``, per rank a tuple of its own leaves on ``devices[p]``
    and a tuple of the replicated ones (dtypes kept, as in
    blockell_from_numpy)."""
    devices = [torch.device(d) for d in devices]
    dev = [tuple(_float(np.asarray(a)[p], d) for a in carry_dev)
           for p, d in enumerate(devices)]
    rep = [tuple(_float(a, d) for a in carry_rep) for d in devices]
    return dev, rep
