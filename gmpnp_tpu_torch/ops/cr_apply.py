"""The 1D block cyclic-reduction apply: the CUDA kernel's wrapper, its plain
version and its launch plan.

Replaces no Pallas kernel: the counterpart is the reference's
``gmpnp_tpu/solve/linear.py::block_tridiag_apply_cr`` (jnp, fused by XLA on
the TPU).  In the port that apply ran as some 300 launch-sized torch
operations (a handful a level, 13 levels down and 13 up at N = 5,991), the
largest share of the carried EDL step's device time; the kernel
(``csrc/cr_apply.cu``) walks the downward sweep, the top solve and the
upward sweep in one launch, one thread-block cluster per lane.  Bound:
bytes, the factor read once (16.05 MB at (5,991, 7) f64, ~4.8 us; ``PERF.md``
section 6).

``cr_apply_reference`` is the plain version, the former eager code of
``solve.linear.block_tridiag_apply_cr``.  The kernel keeps its arithmetic
row for row (each f-term product one FMA chain in a fixed order, so it is
bitwise repeatable and each lane of a lane-batched call gets its
single-lane bits), but not cuBLAS's order of summation.

``cr_plan`` says which levels run over the whole cluster and how many
blocks it has.  ``cr_apply`` launches the kernel for CUDA tensors (or
raises) and runs the plain version for CPU tensors only.  ``LAUNCHES``
counts kernel launches per dtype and ``SHAPE_LAUNCHES`` per (N, f, dtype
name), or per (V, N, f, dtype name) for a launch over lanes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from gmpnp_tpu_torch.ops.block_inv import range_clamp

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float32: 0, torch.float64: 0}
#: kernel launches per (N, f, dtype name) or (V, N, f, dtype name)
SHAPE_LAUNCHES = {}

#: threads a block (csrc/cr_apply.cu: kThreads)
THREADS = 512
#: the widest block row the kernel takes (kMaxF)
MAX_F = 16
#: the most levels (kMaxLevels): 2^24 rows
MAX_LEVELS = 24
#: the most blocks of a cluster (kMaxCluster; over 8 takes the card's
#: non-portable cluster sizes: 16 ran 1.3x faster than 8 at (5,991, 7) f64)
MAX_CLUSTER = 16
#: values of the vectors the one-block levels keep in shared memory
#: (kTailValues): under two passes' rows, 2 (THREADS / 32) (32 // f) f
TAIL_VALUES = 2 * THREADS
#: the tensors of a level, in the kernel's order (csrc/cr_apply.cu:
#: kPerLevel): solve.linear._CRLevel's fields
LEVEL_FIELDS = ("alpha", "gamma", "A_od", "C_od", "Binv_od")


class CRPlan(NamedTuple):
    """How ``cr_apply`` launches the kernel for one (levels, f)."""

    cluster: int         # blocks a lane, a power of two
    tail: int            # levels 0 .. tail-1 run over the cluster
    rows_per_block: int  # rows one block takes in one pass


def cr_plan(levels: int, f: int) -> CRPlan:
    """The cluster split of an apply with ``levels`` levels (M = 2^levels
    rows) of f x f blocks: a block takes (THREADS / 32) * (32 // f) rows a
    pass; the levels with more rows than that (a prefix: level l has M /
    2^(l+1)) run over a cluster of as many blocks as the widest level
    fills, rounded up to a power of two and at most MAX_CLUSTER, each block
    a contiguous share of a level's rows, with a cluster barrier after
    each; the rest, the top solve and their upward levels run in one
    block, their vectors in its shared memory."""
    if not 1 <= f <= MAX_F:
        raise ValueError(f"cr_apply takes 1 <= f <= {MAX_F}, got f={f}")
    if not 0 <= levels <= MAX_LEVELS:
        raise ValueError(f"cr_apply takes 0 <= levels <= {MAX_LEVELS}, got "
                         f"{levels}")
    rows = (THREADS // 32) * (32 // f)
    M = 1 << levels
    tail = sum(1 for lev in range(levels) if M >> (lev + 1) > rows)
    if not tail:
        return CRPlan(1, 0, rows)
    widest = 1 << (-(-(M >> 1) // rows) - 1).bit_length()
    return CRPlan(min(widest, MAX_CLUSTER), tail, rows)


def cr_apply_reference(levels: Sequence, Binv_top: torch.Tensor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: solve with a prepared CR factorization
    (``levels``: per level alpha, gamma, A_od, C_od, Binv_od; see
    ``solve.linear._CRLevel``).  rhs: (N, f) or (V, N, f) in the
    factorization's dtype (padded rows solve to 0 exactly)."""
    # at call time: solve.smallblock imports this package
    from gmpnp_tpu_torch.solve.smallblock import block_mv, lane_by_lane

    lead = rhs.shape[:-2]
    N, f = rhs.shape[-2:]
    M = 2 ** len(levels)
    zv1 = torch.zeros((*lead, 1, f), dtype=rhs.dtype, device=rhs.device)
    D = rhs
    if M > N:
        D = torch.cat([D, zv1.expand(*lead, M - N, f)], -2)

    odd_rhs = []
    for lev in levels:
        D_ev, D_od = D[..., 0::2, :], D[..., 1::2, :]
        odd_rhs.append(D_od)
        D_left = torch.cat([zv1, D_od[..., :-1, :]], -2)
        D = range_clamp(D_ev - block_mv(lev.alpha, D_left)
                        - block_mv(lev.gamma, D_od))

    # the top solve lane by lane: the single lane's matrix-vector call, so
    # that each lane's apply has its bits
    x = lane_by_lane(torch.matmul, bool(lead), Binv_top,
                     D[..., 0, :])[..., None, :]      # (1, f)
    for lev, D_od in zip(reversed(levels), reversed(odd_rhs)):
        x_right = torch.cat([x[..., 1:, :], zv1], -2)
        r_od = range_clamp(D_od - block_mv(lev.A_od, x)
                           - block_mv(lev.C_od, x_right))
        x_odd = range_clamp(block_mv(lev.Binv_od, r_od))
        x = torch.stack([x, x_odd], dim=-2).reshape(
            *lead, 2 * x.shape[-2], f)
    return x[..., :N, :]


def _check_block(name, t, lead, rows, f, rhs):
    """t: (*lead, rows, f, f) (rows None: (*lead, f, f)) in rhs's dtype and
    device, each f x f block contiguous; returns its (lane, row) strides."""
    want = (*lead, f, f) if rows is None else (*lead, rows, f, f)
    if tuple(t.shape) != want:
        raise ValueError(f"cr_apply: {name} has shape {tuple(t.shape)}, "
                         f"want {want}")
    if t.dtype != rhs.dtype:
        raise TypeError(f"cr_apply: {name} is {t.dtype}, rhs {rhs.dtype}")
    if t.device != rhs.device:
        raise ValueError(f"cr_apply: {name} on {t.device}, rhs on "
                         f"{rhs.device}")
    if f > 1 and (t.stride(-1) != 1 or t.stride(-2) != f):
        raise ValueError(f"cr_apply: {name}'s f x f blocks must be "
                         f"contiguous, strides {t.stride()}")
    return (t.stride(0) if lead else 0), (0 if rows is None
                                          else t.stride(-3))


def cr_apply(levels: Sequence, Binv_top: torch.Tensor,
             rhs: torch.Tensor) -> torch.Tensor:
    """x (N, f) or (V, N, f) solving the factored block-tridiagonal system
    for rhs: CUDA tensors launch the kernel on the current stream (one
    launch, every lane; see ``cr_plan``); CPU tensors take the plain
    version."""
    if rhs.device.type == "cpu":
        return cr_apply_reference(levels, Binv_top, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"cr_apply runs on cuda or cpu, got {rhs.device}")
    if rhs.dtype not in LAUNCHES:
        raise TypeError(f"cr_apply takes float32 or float64, got {rhs.dtype}")
    if rhs.dim() not in (2, 3):
        raise ValueError(f"cr_apply wants rhs (N, f) or (V, N, f), got "
                         f"{tuple(rhs.shape)}")
    if not rhs.is_contiguous():
        raise ValueError("cr_apply: rhs must be contiguous")
    lead = tuple(rhs.shape[:-2])
    N, f = rhs.shape[-2:]
    L = len(levels)
    plan = cr_plan(L, f)
    if not 1 <= N <= 2 ** L:
        raise ValueError(f"cr_apply: {L} levels solve 1 to {2 ** L} rows, "
                         f"rhs has {N}")
    V = lead[0] if lead else 1
    if V > 65535:
        raise ValueError(f"cr_apply takes at most 65,535 lanes, got {V}")
    ptrs, strides = [], []
    for lev_i, lev in enumerate(levels):
        h = 2 ** L >> (lev_i + 1)
        for name, t in zip(LEVEL_FIELDS, lev):
            strides.extend(_check_block(f"level {lev_i} {name}", t, lead, h,
                                        f, rhs))
            ptrs.append(t.data_ptr())
    strides.extend(_check_block("Binv_top", Binv_top, lead, None, f, rhs))
    ptrs.append(Binv_top.data_ptr())
    from gmpnp_tpu_torch.ops._build import load_library

    out = torch.empty_like(rhs)
    ws = (torch.empty((V, 2 ** L - 1, f), dtype=rhs.dtype, device=rhs.device)
          if plan.tail else None)
    lib = load_library()
    fn = lib.cr_apply_f32 if rhs.dtype == torch.float32 else lib.cr_apply_f64
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream(rhs.device).cuda_stream
        err = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
                 (ctypes.c_longlong * len(strides))(*strides), L,
                 rhs.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), N, f, V,
                 plan.cluster, plan.tail, stream)
    if err != 0:
        raise RuntimeError(f"cr_apply kernel launch failed: CUDA error {err}")
    LAUNCHES[rhs.dtype] += 1
    key = lead + (N, f, str(rhs.dtype).replace("torch.", ""))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out
