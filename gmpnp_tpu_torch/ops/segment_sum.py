"""Sorted-segment sum of FEM assembly: the CUDA kernel's wrapper, its plain
version and the custom op that carries it through ``torch.func.vmap``.

Replaces ``gmpnp_tpu/fem/assembly.py::_segment_reduce`` (jnp; XLA fuses it
on the TPU): ``out[i] = sum_{j=start[i]}^{end[i]-1} values[order[j]]`` for
values (M, d), or (V, M, d) over the V lanes of a batched sweep, with the
int64 tables of ``fem.assembly._sorted_segment_tables``.

The plain version ``segment_sum_reference`` is the reference's sorted
gather, cumulative sum and prefix difference.  On the card its dim-0 cumsum
of an (M, d) tensor with small d ran one thread per column over all M rows
and took about half the pore's device time; the kernel
(``csrc/segment_sum.cu``) sums each destination row left to right from
0.0, so it is bitwise the sequential sum in sorted order and bitwise
repeatable.  ``segment_plan`` picks its path from the row width: a warp
per row at d > 16 (the Jacobians), ``32 // d`` rows packed into a warp
with a row's values loaded ``depth`` at a time before they are added at d
<= 16 (the residuals).  The two versions round differently: the cumsum's
error is about eps * |prefix| per column (``chip_smoke.py`` phase 3 holds
the kernel to 2 * M * eps * max|prefix|).  Bound: bytes (``PERF.md``
section 6).

``segment_sum`` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors only.  ``segment_sum_op`` is the same
function as the custom op ``gmpnp_tpu_torch::segment_sum``, whose vmap
rule turns a vmapped call into one lane-axis call: ``FemSpace.residual``
and ``jacobian`` call it, and ``residual_lanes`` / ``jacobian_lanes`` run
them under ``vmap``, which a ctypes launch cannot take.  ``LAUNCHES``
counts kernel launches per dtype and ``SHAPE_LAUNCHES`` per (M, n_dest, d,
dtype name), or (V, M, n_dest, d, dtype name) over lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float32: 0, torch.float64: 0}
#: kernel launches per (M, n_dest, d, dtype name) or (V, M, n_dest, d,
#: dtype name), counted at the same place
SHAPE_LAUNCHES = {}

#: the widest row the packed path takes (csrc/segment_sum.cu,
#: kMaxPackedWidth), and the bytes of its per-lane value buffer
MAX_PACKED_WIDTH = 16
_PACKED_BUFFER_BYTES = 256
#: the packed path's buffer depth, the one the kernel is built for (kDepth)
PACKED_DEPTH = 32
#: the kernel's paths
ROW_WARP, PACKED_ROWS = "warp per row", "packed rows"


class SegmentPlan(NamedTuple):
    """How ``segment_sum`` launches the kernel at one (d, type)."""

    path: str            # ROW_WARP or PACKED_ROWS
    rows_per_warp: int   # destination rows one warp sums
    depth: int           # a row's entries loaded before they are added
                         # (packed rows; 0 on the warp-per-row path)


def segment_plan(d: int, itemsize: int) -> SegmentPlan:
    """The kernel's path for rows of d values of ``itemsize`` bytes: up to
    16 columns ``32 // d`` rows share a warp, each lane (row, column)
    loading ``depth`` values of its row before it adds them (at most
    ``_PACKED_BUFFER_BYTES`` of registers, and the depth the kernel is
    built for); wider rows take a warp each, lanes across the columns."""
    if d < 1:
        raise ValueError(f"segment_plan wants d >= 1, got {d}")
    if d > MAX_PACKED_WIDTH:
        return SegmentPlan(ROW_WARP, 1, 0)
    depth = min(PACKED_DEPTH, _PACKED_BUFFER_BYTES // itemsize)
    return SegmentPlan(PACKED_ROWS, 32 // d, depth)


def segment_sum_reference(values: torch.Tensor, order: torch.Tensor,
                          start: torch.Tensor,
                          end: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: per-segment sums via sorted gather +
    cumulative sum + prefix difference along the row axis (-2), the
    reference's formulation.  Segments with start == end yield exact
    zeros.  Over lanes (V, M, d) each lane's columns are summed as one
    lane's are."""
    v = values.index_select(-2, order)
    cum = torch.cumsum(v, dim=-2)
    zero = torch.zeros(v.shape[:-2] + (1, v.shape[-1]), dtype=v.dtype,
                       device=v.device)
    cum = torch.cat([zero, cum], dim=-2)
    return cum.index_select(-2, end) - cum.index_select(-2, start)


def _check(values, order, start, end) -> None:
    if values.dim() not in (2, 3):
        raise ValueError(f"segment_sum wants values (M, d) or (V, M, d), "
                         f"got {tuple(values.shape)}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_sum takes float32 or float64 values, got "
                        f"{values.dtype}")
    for name, t in (("order", order), ("start", start), ("end", end)):
        if t.dim() != 1 or t.dtype != torch.int64:
            raise TypeError(f"segment_sum wants a 1-D int64 {name}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if order.shape[0] != values.shape[-2] or start.shape != end.shape:
        raise ValueError(
            f"segment_sum shape mismatch: values {tuple(values.shape)}, "
            f"order {tuple(order.shape)}, start {tuple(start.shape)}, end "
            f"{tuple(end.shape)}")
    if not (values.device == order.device == start.device == end.device):
        raise ValueError(
            f"segment_sum operands on different devices: {values.device}, "
            f"{order.device}, {start.device}, {end.device}")
    if not all(t.is_contiguous() for t in (values, order, start, end)):
        raise ValueError("segment_sum operands must be contiguous")


def segment_sum(values: torch.Tensor, order: torch.Tensor,
                start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """``out[..., i, :] = sum_{j=start[i]}^{end[i]-1} values[..., order[j],
    :]``.

    values (M, d) or (V, M, d) float32|float64, order (M,), start and end
    (n_dest,) int64, all contiguous on one device -> (n_dest, d) or (V,
    n_dest, d), one launch.  CUDA tensors launch the kernel on the current
    stream; CPU tensors take the plain version."""
    _check(values, order, start, end)
    if values.device.type == "cpu":
        return segment_sum_reference(values, order, start, end)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, got "
                         f"{values.device}")
    from gmpnp_tpu_torch.ops._build import load_library

    lanes = values.shape[0] if values.dim() == 3 else 1
    M, d = values.shape[-2:]
    n_dest = start.shape[0]
    out = torch.empty(values.shape[:-2] + (n_dest, d), dtype=values.dtype,
                      device=values.device)
    if out.numel() == 0:
        return out
    if M >= 2 ** 31:
        raise ValueError(f"segment_sum's kernel takes fewer than 2**31 "
                         f"value rows, got {M}")
    plan = segment_plan(d, values.element_size())
    lib = load_library()
    fn = (lib.segment_sum_f32 if values.dtype == torch.float32
          else lib.segment_sum_f64)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), order.data_ptr(), start.data_ptr(),
                 end.data_ptr(), out.data_ptr(), n_dest, d, lanes, M * d,
                 n_dest * d, plan.rows_per_warp, plan.depth, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[values.dtype] += 1
    key = (M, n_dest, d, str(values.dtype).replace("torch.", ""))
    if values.dim() == 3:
        key = (lanes,) + key
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out


@torch.library.custom_op("gmpnp_tpu_torch::segment_sum", mutates_args=())
def segment_sum_op(values: torch.Tensor, order: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """``segment_sum`` as a custom op, so that ``torch.func.vmap`` over it
    makes one lane-axis call (its vmap rule below)."""
    return segment_sum(values, order, start, end)


@segment_sum_op.register_vmap
def _(info, in_dims, values, order, start, end):
    """vmap over values: the lane axis moved to the front (nested vmaps
    folded into it), one call over all lanes, each lane summed as a
    one-lane call sums it.  The tables are shared by every lane."""
    v_dim, *table_dims = in_dims
    if any(dim is not None for dim in table_dims):
        raise ValueError("segment_sum: vmap over the tables is not "
                         "supported (every lane shares one table)")
    if v_dim is None:
        return segment_sum_op(values, order, start, end), None
    v = values.movedim(v_dim, 0)
    lead = v.shape[:-2]
    out = segment_sum_op(v.reshape((-1,) + tuple(v.shape[-2:])).contiguous(),
                         order, start, end)
    return out.reshape(lead + tuple(out.shape[-2:])), 0
