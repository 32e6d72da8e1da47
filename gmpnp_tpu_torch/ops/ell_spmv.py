"""Block-ELL matvec: the CUDA kernel's wrapper and its plain version.

Replaces ``gmpnp_tpu/ops/ell_spmv.py::ell_block_contract_pallas`` (Pallas,
TPU): ``y[n] = sum_k blocks[n, k] @ x[adj[n, k]]``.  The Pallas kernel took
relaid ``(N, K, f, f)`` blocks and the gathered ``(N, K, f)`` operand, both
built by XLA outside it.  The Hopper kernel (``csrc/ell_spmv.cu``) reads
BlockELL's native ``(N, f, K*f)`` layout and gathers ``x`` itself, so
neither temporary exists.

Bound: bytes.  Each matrix entry is read once for two flops, so the least
time is (flat + adj + x + y) bytes over the H100's 3.35 TB/s: at the 3D pore
main path (N=2,501, K=15, f=9) 12,484,992 B = 3.73 us in f32 and 24,819,924
B = 7.41 us in f64.  At 12-24 MB the product is over before the card's
memory pipeline is full, so the kernel's design is about bytes in flight: one
block per tile of vertices, the tile brought into shared memory by one 1D
bulk copy, ``x[adj]`` gathered once per vertex meanwhile, row sums in
registers and warp shuffles in a fixed order (two launches give the same
bits).  ``launch_plan`` picks the kernel and the tile from f, K and the
type: at f in {5, 7, 9} one warp per vertex with the f row sums in
registers (the 3D pores), at f in {5, 7} with K*f <= 32 one thread per
output row (the 1D meshes, K=3), at any other f one warp per output row.
Any element-aligned contiguous operand is taken: a view whose pointer is
not 16-byte aligned goes through the kernel's element-sized copies.
Measured times and the share of the bound reached: ``PERF.md`` section 6.

Lanes: ``flat`` (V, N, f, K*f) and ``x`` (V, N, f) with one ``adj`` take
one launch for the V lanes of a batched sweep (the reference's vmap of the
Pallas kernel), each lane's result bitwise that of a one-lane launch.
``lane_aligned`` lays lanes out so that each lane's matrix starts on a
16-byte boundary (``lane_copy_paths`` says which copy each lane takes).

``ell_spmv`` launches the kernel for CUDA tensors (or raises) and runs the
plain version ``ell_spmv_reference`` for CPU tensors only.  ``LAUNCHES``
counts kernel launches per dtype and ``SHAPE_LAUNCHES`` per (N, K, f,
dtype name), or per (V, N, K, f, dtype name) for a launch over lanes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float32: 0, torch.float64: 0}
#: kernel launches per (N, K, f, dtype name), counted at the same place
SHAPE_LAUNCHES = {}

#: threads per block in csrc/ell_spmv.cu (kThreads), and its warps
_THREADS = 128
_WARPS = _THREADS // 32
#: shared memory a tile (matrix rows + gathered x) may take, of the 227 KB
#: a block can have on the H100
_SMEM_BUDGET = 200 * 1024
#: the kernel's modes (csrc/ell_spmv.cu, enum Mode): one warp per output
#: row (f at run time), one warp per vertex (f in {5, 7, 9} at compile
#: time), one thread per output row (f in {5, 7}, K*f <= 32)
ROW_WARP, VERTEX_WARP, ROW_THREAD = 0, 1, 2
MODE_NAMES = {ROW_WARP: "warp per row, f at run time",
              VERTEX_WARP: "warp per vertex", ROW_THREAD: "thread per row"}


class LaunchPlan(NamedTuple):
    """How ``ell_spmv`` launches the kernel at one (f, K, type)."""

    mode: int    # ROW_WARP, VERTEX_WARP or ROW_THREAD
    lanes: int   # threads that share one vertex's block row
    tile: int    # vertices per block of 128 threads


def align_vertices(f: int, K: int, itemsize: int) -> int:
    """The fewest consecutive vertices whose block rows (f*K*f values each)
    fill a whole number of 16-byte units: tiles of a multiple of this start
    on 16-byte boundaries when the matrix does."""
    return 16 // math.gcd(f * K * f * itemsize, 16)


def _tile_smem(tile: int, f: int, K: int, itemsize: int) -> int:
    per16 = 16 // itemsize
    rows = -(-tile * f * K * f // per16) * per16
    return (rows + tile * K * f) * itemsize


def _mode(f: int, K: int) -> int:
    if f in (5, 7) and K * f <= 32:
        return ROW_THREAD
    return VERTEX_WARP if f in (5, 7, 9) else ROW_WARP


def tile_vertices(f: int, K: int, itemsize: int) -> int:
    """Vertices per block of the kernel: a multiple of ``align_vertices``,
    the smallest that gives every warp a vertex (a warp per vertex or per
    row) or the largest whose rows the block's threads cover (a thread per
    row).  Falls back to fewer (last of all one, copied element by element)
    where shared memory is short, and raises where even one block row does
    not fit."""
    align = align_vertices(f, K, itemsize)
    if _mode(f, K) == ROW_THREAD:
        most = max(align, _THREADS // f // align * align)
    else:
        most = align * -(-_WARPS // align)
    for tile in (*range(most, 0, -align), 1):
        if _tile_smem(tile, f, K, itemsize) <= _SMEM_BUDGET:
            return tile
    raise ValueError(
        f"ell_spmv: one block row of f={f}, K={K} "
        f"({f * K * f * itemsize} bytes) exceeds the kernel's shared memory")


def launch_plan(f: int, K: int, itemsize: int) -> LaunchPlan:
    """The kernel mode, the threads per vertex and the tile for one shape:
    at the 3D pores (K=15, f=9 or 7) one warp per vertex, 4 vertices a
    block; at the 1D meshes (K=3, f=7 or 5) one thread per output row, 16
    to 24 vertices a block."""
    mode = _mode(f, K)
    lanes = {ROW_WARP: 32 * f, VERTEX_WARP: 32, ROW_THREAD: f}[mode]
    return LaunchPlan(mode, lanes, tile_vertices(f, K, itemsize))


def ell_spmv_reference(flat: torch.Tensor, adj: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``einsum('nrk,nk->nr', flat, x[adj])`` — the
    same op as the reference's non-TPU branch and ``BlockELL.matvec``.
    Over lanes (flat (V, N, f, K*f), x (V, N, f)) the same einsum runs on
    the V*N rows, so each lane's rows are computed as one lane's are."""
    if flat.dim() == 4:
        V, N, f, Kf = flat.shape
        xg = x[:, adj].reshape(V * N, Kf)
        return torch.einsum("nrk,nk->nr", flat.reshape(V * N, f, Kf),
                            xg).reshape(V, N, f)
    N, f, Kf = flat.shape
    xg = x[adj].reshape(N, Kf)
    return torch.einsum("nrk,nk->nr", flat, xg)


def lane_aligned(flat: torch.Tensor) -> torch.Tensor:
    """Lanes ``flat`` (V, N, f, K*f) copied into a buffer whose lane stride
    is a whole number of ``align_vertices`` block rows, so that every
    lane's matrix starts on a 16-byte boundary (the kernel's bulk copies);
    returns the (V, N, f, K*f) view.  A stride that is aligned already, or
    one lane, returns ``flat`` itself."""
    V, N, f, Kf = flat.shape
    align = align_vertices(f, Kf // f, flat.element_size())
    if V == 1 or (N % align == 0 and flat.is_contiguous()):
        return flat
    n_pad = -(-N // align) * align
    buf = torch.empty((V, n_pad, f, Kf), dtype=flat.dtype,
                      device=flat.device)
    buf[:, :N] = flat
    return buf[:, :N]


def lane_copy_paths(flat: torch.Tensor):
    """Per lane of ``flat`` (V, N, f, K*f): 'bulk' where the kernel copies
    its tiles with ``cp.async.bulk`` (the lane's matrix on a 16-byte
    boundary and whole 16-byte tiles), else 'element'."""
    V, N, f, Kf = flat.shape
    size = flat.element_size()
    tile = launch_plan(f, Kf // f, size).tile
    whole = tile * f * Kf * size % 16 == 0
    return ["bulk" if whole and (flat.data_ptr() + v * flat.stride(0) * size)
            % 16 == 0 else "element" for v in range(V)]


def _check(flat: torch.Tensor, adj: torch.Tensor, x: torch.Tensor) -> None:
    lanes = flat.dim() == 4
    if (flat.dim() != x.dim() + 1 or x.dim() not in (2, 3)
            or adj.dim() != 2):
        raise ValueError(
            f"ell_spmv wants flat (N, f, K*f), adj (N, K), x (N, f), or over "
            f"lanes flat (V, N, f, K*f), x (V, N, f); got "
            f"{tuple(flat.shape)}, {tuple(adj.shape)}, {tuple(x.shape)}")
    N, f, Kf = flat.shape[-3:]
    K = adj.shape[1]
    if (adj.shape[0] != N or Kf != K * f
            or tuple(x.shape) != tuple(flat.shape[:-1])):
        raise ValueError(
            f"ell_spmv shape mismatch: flat {tuple(flat.shape)}, "
            f"adj {tuple(adj.shape)}, x {tuple(x.shape)}")
    if flat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ell_spmv takes float32 or float64, got {flat.dtype}")
    if x.dtype != flat.dtype:
        raise TypeError(f"ell_spmv operands differ in dtype: flat "
                        f"{flat.dtype}, x {x.dtype}")
    if adj.dtype != torch.int32:
        raise TypeError(f"ell_spmv wants int32 adj, got {adj.dtype}")
    if not (flat.device == adj.device == x.device):
        raise ValueError(f"ell_spmv operands on different devices: "
                         f"{flat.device}, {adj.device}, {x.device}")
    lane_ok = not lanes or (flat[0].is_contiguous()
                            and flat.stride(0) >= N * f * Kf)
    if not ((flat.is_contiguous() or (lanes and lane_ok))
            and adj.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv operands must be contiguous (over lanes: "
                         "each lane's matrix contiguous, lanes apart by at "
                         "least one matrix)")


def ell_spmv(flat: torch.Tensor, adj: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y[n, r] = sum_k sum_c flat[n, r, k*f + c] * x[adj[n, k], c]``.

    flat (N, f, K*f) float32|float64, adj (N, K) int32, x (N, f) of flat's
    dtype, all contiguous on one device (a view with a storage offset is
    fine) -> y (N, f).  Over lanes: flat (V, N, f, K*f) (each lane
    contiguous; ``lane_aligned`` pads the lane stride), x (V, N, f) ->
    y (V, N, f), one launch.  CUDA tensors launch the kernel on the
    current stream; CPU tensors take the plain version."""
    _check(flat, adj, x)
    if flat.device.type == "cpu":
        return ell_spmv_reference(flat, adj, x)
    if flat.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, got {flat.device}")
    from gmpnp_tpu_torch.ops._build import load_library

    lanes = flat.shape[0] if flat.dim() == 4 else 1
    N, f, Kf = flat.shape[-3:]
    y = torch.empty(x.shape, dtype=flat.dtype, device=flat.device)
    if N == 0 or f == 0:
        return y
    K = Kf // f
    plan = launch_plan(f, K, flat.element_size())
    lib = load_library()
    fn = lib.ell_spmv_f32 if flat.dtype == torch.float32 else lib.ell_spmv_f64
    stride = flat.stride(0) if flat.dim() == 4 else N * f * Kf
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = fn(flat.data_ptr(), adj.data_ptr(), x.data_ptr(), y.data_ptr(),
                 N, K, f, plan.tile, plan.mode, lanes, stride, stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {err}")
    LAUNCHES[flat.dtype] += 1
    key = (N, K, f, str(flat.dtype).replace("torch.", ""))
    if flat.dim() == 4:
        key = (lanes,) + key
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return y


def ell_matvec(ell, x: torch.Tensor) -> torch.Tensor:
    """``ell @ x`` for a BlockELL through the kernel — the counterpart of
    ``gmpnp_tpu/ops/ell_spmv.py::ell_matvec_pallas``."""
    return ell_spmv(ell.flat, ell.adj, x)
