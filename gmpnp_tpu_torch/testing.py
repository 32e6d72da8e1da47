"""Parity harness: relative-L2 comparators, read-only golden files, and the
inputs and sequential reference the kernel checks share.

The goldens under ``tests/goldens/`` were written by the reference package.
The port only reads them: :class:`GoldenFile` here never writes, and a
missing golden is an error, not a pass.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    """Relative L2 difference ||a-b|| / ||b|| (the BASELINE.json parity
    metric)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.linalg.norm(b.reshape(-1))
    if denom == 0:
        return float(np.linalg.norm(a.reshape(-1)))
    return float(np.linalg.norm((a - b).reshape(-1)) / denom)


def field_summary(u: np.ndarray, names) -> Dict[str, Dict[str, float]]:
    """Compact per-field fingerprint of a (N, f) state: robust scalars that
    pin down the solution without storing the full field."""
    u = np.asarray(u)
    out = {}
    for i, nm in enumerate(names):
        col = u[:, i]
        out[nm] = {
            "min": float(col.min()),
            "max": float(col.max()),
            "mean": float(col.mean()),
            "l2": float(np.linalg.norm(col)),
            "first": float(col[0]),
            "last": float(col[-1]),
        }
    return out


class GoldenFile:
    """A golden snapshot, read only: ``check`` compares every recorded
    scalar at the given relative tolerance and raises FileNotFoundError
    when the file is missing."""

    def __init__(self, path: str, rtol: float = 1e-8, atol: float = 1e-10):
        self.path = path
        self.rtol = rtol
        self.atol = atol

    def check(self, data: Dict) -> Optional[str]:
        """Returns None on match, else a message describing the first
        mismatch."""
        if not os.path.exists(self.path):
            raise FileNotFoundError(f"golden file missing: {self.path}")
        with open(self.path) as f:
            ref = json.load(f)
        return self._compare("", data, ref)

    def _compare(self, prefix, got, ref):
        if isinstance(ref, dict):
            if not isinstance(got, dict):
                return f"{prefix}: type changed"
            for k in ref:
                if k not in got:
                    return f"{prefix}.{k}: missing"
                msg = self._compare(f"{prefix}.{k}", got[k], ref[k])
                if msg:
                    return msg
            return None
        if isinstance(ref, float):
            g = float(got)
            if not np.isfinite(g) and not np.isfinite(ref):
                return None
            if abs(g - ref) > self.atol + self.rtol * abs(ref):
                return (f"{prefix}: {g!r} != golden {ref!r} "
                        f"(rtol {self.rtol})")
            return None
        if got != ref:
            return f"{prefix}: {got!r} != golden {ref!r}"
        return None


def guard_blocks(rng: np.random.Generator, n: int, f: int) -> np.ndarray:
    """n seeded (f, f) f64 blocks whose first ten take every branch of
    ``block_inv``: a zero leading pivot (a row swap), tied and all-equal
    column maxima (the first wins), zero and tiny columns (the pivot
    floor), a row beyond RANGE_LIM (the input clamp), an inverse beyond
    it, a repeated row, an all-zero block and a tied negative column."""
    A = rng.normal(size=(max(n, 10), f, f))
    A[0, 0, 0] = 0.0
    A[1, min(1, f - 1), 0] = -A[1, 0, 0]
    A[2, :, 0] = A[2, 0, 0]
    A[3, :, min(2, f - 1)] = 0.0
    A[4, :, min(1, f - 1)] *= 1e-18
    A[5, 0, :] *= 1e20
    A[6] *= 1e-12
    A[7, -1, :] = A[7, 0, :]
    A[8] = 0.0
    A[9, :, f - 1] = -2.0
    return A[:n]


def sequential_segment_sum(values: torch.Tensor, order: torch.Tensor,
                           start: torch.Tensor,
                           end: torch.Tensor) -> torch.Tensor:
    """The sum of each segment in sorted order, left to right from 0.0, as
    the torch loop ``acc = acc + z[table[:, j]]`` over the columns of a
    padded gather table (``solve/amg.py::segment_table``'s layout:
    each row's positions in sorted order, padded with the zero row ``z``
    appends).  values (..., M, d) -> (..., n_dest, d)."""
    counts = (end - start).cpu().numpy()
    width = max(1, int(counts.max(initial=0)))
    j = np.arange(width)[None, :]
    pos = np.minimum(start.cpu().numpy()[:, None] + j, len(order) - 1)
    table = torch.as_tensor(
        np.where(j < counts[:, None], order.cpu().numpy()[pos],
                 values.shape[-2]), device=values.device)
    z = torch.cat([values, values.new_zeros(
        values.shape[:-2] + (1,) + values.shape[-1:])], dim=-2)
    acc = values.new_zeros(values.shape[:-2] + (len(start),)
                           + values.shape[-1:])
    for c in range(width):
        acc = acc + z.index_select(-2, table[:, c])
    return acc


#: segment lengths around the segment-sum kernel's chunks (32 order
#: entries a round on the warp-per-row path, a buffer of 32 on the packed
#: one): empty, one, a chunk less one, a chunk, a chunk and one, several
EDGE_SEGMENT_LENGTHS = (0, 1, 31, 32, 33, 100)


def edge_segment_tables(rng: np.random.Generator, device=None):
    """int64 (order, start, end) of a seeded table whose 13 destination
    rows take each of EDGE_SEGMENT_LENGTHS entries twice and one row 5, in
    a shuffled order, over value rows in a shuffled order (13 rows: not a
    whole number of packed warps at any width)."""
    counts = np.array(EDGE_SEGMENT_LENGTHS * 2 + (5,))
    rng.shuffle(counts)
    dest = np.repeat(np.arange(len(counts)), counts)
    rng.shuffle(dest)
    end = np.cumsum(counts)
    return tuple(torch.as_tensor(t, dtype=torch.int64, device=device)
                 for t in (np.argsort(dest, kind="stable"), end - counts,
                           end))


def pore_states(prog, seed: int, scale: float = 1.0):
    """Seeded states (u, u_prev) of a pore program (``models.pore_3d``), on
    its device, for the element-residual kernel's checks: concentrations
    1 + 0.1 N(0, 1), the GMPNP potential 0.5 N(0, 1); ``scale`` multiplies
    u's concentrations (60 puts the steric denominator under its clip)."""
    rng = np.random.default_rng(seed)
    N, f = prog.space.num_vertices, prog.space.n_fields
    ns = len(prog.config.species)
    u = 1.0 + 0.1 * rng.normal(size=(N, f))
    up = 1.0 + 0.1 * rng.normal(size=(N, f))
    u[:, :ns] *= scale
    u[:, ns:] = 0.5 * rng.normal(size=(N, f - ns))
    up[:, ns:] = 0.5 * rng.normal(size=(N, f - ns))
    return (torch.as_tensor(u, device=prog.device),
            torch.as_tensor(up, device=prog.device))


def tridiag_bands(N: int, f: int, lanes: Optional[int] = None,
                  seed: int = 9, dtype=torch.float64, device=None):
    """Seeded block-tridiagonal bands and a right-hand side for the 1D
    cyclic-reduction checks: (lower, diag, upper, rhs), each (N, f, f) /
    (N, f), or over ``lanes`` (V, N, f, f) / (V, N, f); off-diagonal blocks
    0.2 N(0, 1), diagonal blocks 0.2 N(0, 1) + 3 I (block diagonally
    dominant), lower[0] and upper[N-1] zero."""
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    lower = rng.normal(size=(*lead, N, f, f)) * 0.2
    upper = rng.normal(size=(*lead, N, f, f)) * 0.2
    diag = rng.normal(size=(*lead, N, f, f)) * 0.2 + 3.0 * np.eye(f)
    lower[..., 0, :, :] = 0.0
    upper[..., -1, :, :] = 0.0
    rhs = rng.normal(size=(*lead, N, f))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (lower, diag, upper, rhs))
