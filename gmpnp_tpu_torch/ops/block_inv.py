"""Batched small-block inverse: the CUDA kernel's wrapper and its plain
version.

Replaces ``gmpnp_tpu/solve/smallblock.py::block_inv`` (jnp written as the
body of a Pallas kernel; XLA fuses its unrolled loop over f on the TPU):
Gauss-Jordan elimination with partial pivoting on (..., f, f) blocks, f <=
16, with the reference's guards: the input and every elimination step
clamped to +-RANGE_LIM, pivots floored at +-RANGE_FLOOR (sign kept, 0
counts as +), the pivot the first maximum of the column.  The reference's
one-hot permutation multiply is a direct row swap, which moves the same
values.

The plain version ``block_inv_reference`` runs the loop over f as torch
ops, about 18 launches per column; the kernel (``csrc/block_inv.cu``)
inverts the whole batch in one launch, one thread per pair of columns of
the augmented matrix and ``blocks_per_warp(f)`` blocks per warp, and
rounds every product, difference and quotient as the plain version's torch
kernels do, so on the card the two are bitwise equal.  Bound: bytes, under
the launch floor at the paths' shapes (``PERF.md`` section 6).

``block_inv`` launches the kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors only.  ``LAUNCHES`` counts kernel launches
per dtype and ``SHAPE_LAUNCHES`` per (batch, f, dtype name).
"""

from __future__ import annotations

import torch

# Exponent-range guard, kept at the reference's values for parity: both
# bounds sit ~1e6+ beyond any legitimate quantity in this framework's scaled
# systems, so healthy solves are numerically unchanged; where a clamp does
# engage, Newton certifies the direction on the true f64 residual.
RANGE_LIM = 1.0e16
RANGE_FLOOR = 1.0e-16
#: the widest block the kernel takes (f threads of one warp, each holding
#: two columns of [A | I])
MAX_F = 16

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float32: 0, torch.float64: 0}
#: kernel launches per (batch, f, dtype name), counted at the same place
SHAPE_LAUNCHES = {}


def blocks_per_warp(f: int) -> int:
    """The blocks one warp of the kernel inverts together: f threads each,
    as many as fit in 32 lanes (fewer blocks per warp ran slower on the
    card at every path shape: ``probes/torch_block_inv_anatomy.py``)."""
    if not 1 <= f <= MAX_F:
        raise ValueError(f"block_inv takes 1 <= f <= {MAX_F}, got f={f}")
    return 32 // f


def range_clamp(x: torch.Tensor, lim: float = RANGE_LIM) -> torch.Tensor:
    """Clamp magnitudes into [-lim, lim]."""
    return torch.clamp(x, -lim, lim)


def _floor_pivot(pivval: torch.Tensor) -> torch.Tensor:
    """Push a ~zero pivot to +-RANGE_FLOOR, keeping its sign (sign(0)
    counts as +).  The floor is made in the pivot's dtype (in f64 the
    reference's exact 1e-16, not float32(1e-16) widened)."""
    floor = torch.full_like(pivval, RANGE_FLOOR)
    floored = torch.where(pivval < 0, -floor, floor)
    return torch.where(pivval.abs() < RANGE_FLOOR, floored, pivval)


def block_inv_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: batched inverse of (..., f, f) via
    Gauss-Jordan with partial pivoting, a loop over f of torch ops."""
    f = A.shape[-1]
    batch = A.shape[:-2]
    eye = torch.eye(f, dtype=A.dtype, device=A.device).expand(A.shape)
    aug = torch.cat([range_clamp(A), eye], dim=-1).reshape(-1, f, 2 * f)
    b = torch.arange(aug.shape[0], device=A.device)

    for k in range(f):
        # partial pivot: first largest |entry| in column k among rows >= k
        p = k + torch.argmax(aug[:, k:, k].abs(), dim=1)
        row_k = aug[b, k]
        row_p = aug[b, p]
        aug = aug.clone()
        aug[b, p] = row_k
        aug[b, k] = row_p
        # normalize pivot row, eliminate everywhere else (floored pivot,
        # clamped row and update — the reference's range guard)
        pivval = _floor_pivot(aug[:, k, k])[:, None, None]
        rowk = range_clamp(aug[:, k:k + 1, :] / pivval)
        factors = aug[:, :, k:k + 1]
        aug = range_clamp(aug - factors * rowk)
        # restore the (zeroed) pivot row as the normalized row
        aug[:, k, :] = rowk[:, 0, :]

    return aug[:, :, f:].reshape(*batch, f, f)


def _check(A: torch.Tensor) -> None:
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"block_inv wants square blocks (..., f, f), got "
                         f"{tuple(A.shape)}")
    if not 1 <= A.shape[-1] <= MAX_F:
        raise ValueError(f"block_inv takes 1 <= f <= {MAX_F}, got f="
                         f"{A.shape[-1]}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_inv takes float32 or float64, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("block_inv's operand must be contiguous")


def block_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of every (f, f) block of A (..., f, f) float32|float64,
    contiguous, 1 <= f <= 16 -> (..., f, f), one launch.  CUDA tensors
    launch the kernel on the current stream; CPU tensors take the plain
    version."""
    _check(A)
    if A.device.type == "cpu":
        return block_inv_reference(A)
    if A.device.type != "cuda":
        raise ValueError(f"block_inv runs on cuda or cpu, got {A.device}")
    from gmpnp_tpu_torch.ops._build import load_library

    f = A.shape[-1]
    batch = A.numel() // (f * f)
    out = torch.empty_like(A)
    if batch == 0:
        return out
    lib = load_library()
    fn = lib.block_inv_f32 if A.dtype == torch.float32 else lib.block_inv_f64
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(A.data_ptr(), out.data_ptr(), batch, f, blocks_per_warp(f),
                 stream)
    if err != 0:
        raise RuntimeError(f"block_inv kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[A.dtype] += 1
    key = (batch, f, str(A.dtype).replace("torch.", ""))
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out
