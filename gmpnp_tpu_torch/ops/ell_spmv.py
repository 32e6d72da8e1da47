"""Block-ELL matvec: the CUDA kernel's wrapper and its plain version.

Replaces ``gmpnp_tpu/ops/ell_spmv.py::ell_block_contract_pallas`` (Pallas,
TPU): ``y[n] = sum_k blocks[n, k] @ x[adj[n, k]]``.  The Pallas kernel took
relaid ``(N, K, f, f)`` blocks and the gathered ``(N, K, f)`` operand, both
built by XLA outside it.  The Hopper kernel (``csrc/ell_spmv.cu``) reads
BlockELL's native ``(N, f, K*f)`` layout and gathers ``x`` itself, so
neither temporary exists.

Bound: bytes.  Each matrix entry is read once for two flops; at the 3D pore
main path (N=2,501, K=15, f=9) the f32 matrix is 2,501*9*135*4 B ~ 12 MB
per product, small enough that launch and load latency, not bandwidth, set
the time.  Fusing the gather into the one pass over the matrix is the
design's answer.

``ell_spmv`` launches the kernel for CUDA tensors (or raises) and runs the
plain version ``ell_spmv_reference`` for CPU tensors only.  ``LAUNCHES``
counts kernel launches per dtype.
"""

from __future__ import annotations

import torch

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float32: 0, torch.float64: 0}


def ell_spmv_reference(flat: torch.Tensor, adj: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``einsum('nrk,nk->nr', flat, x[adj])`` — the
    same op as the reference's non-TPU branch and ``BlockELL.matvec``."""
    N, f, Kf = flat.shape
    xg = x[adj].reshape(N, Kf)
    return torch.einsum("nrk,nk->nr", flat, xg)


def _check(flat: torch.Tensor, adj: torch.Tensor, x: torch.Tensor) -> None:
    if flat.dim() != 3 or adj.dim() != 2 or x.dim() != 2:
        raise ValueError(
            f"ell_spmv wants flat (N, f, K*f), adj (N, K), x (N, f); got "
            f"{tuple(flat.shape)}, {tuple(adj.shape)}, {tuple(x.shape)}")
    N, f, Kf = flat.shape
    K = adj.shape[1]
    if adj.shape[0] != N or Kf != K * f or tuple(x.shape) != (N, f):
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
    if not (flat.is_contiguous() and adj.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv operands must be contiguous")


def ell_spmv(flat: torch.Tensor, adj: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """``y[n, r] = sum_k sum_c flat[n, r, k*f + c] * x[adj[n, k], c]``.

    flat (N, f, K*f) float32|float64, adj (N, K) int32, x (N, f) of flat's
    dtype, all contiguous on one device -> y (N, f).  CUDA tensors launch
    the kernel on the current stream; CPU tensors take the plain version."""
    _check(flat, adj, x)
    if flat.device.type == "cpu":
        return ell_spmv_reference(flat, adj, x)
    if flat.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, got {flat.device}")
    from gmpnp_tpu_torch.ops._build import load_library

    N, f, Kf = flat.shape
    y = torch.empty((N, f), dtype=flat.dtype, device=flat.device)
    if N == 0 or f == 0:
        return y
    lib = load_library()
    fn = lib.ell_spmv_f32 if flat.dtype == torch.float32 else lib.ell_spmv_f64
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = fn(flat.data_ptr(), adj.data_ptr(), x.data_ptr(), y.data_ptr(),
                 N, Kf // f, f, stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {err}")
    LAUNCHES[flat.dtype] += 1
    return y


def ell_matvec(ell, x: torch.Tensor) -> torch.Tensor:
    """``ell @ x`` for a BlockELL through the kernel — the counterpart of
    ``gmpnp_tpu/ops/ell_spmv.py::ell_matvec_pallas``."""
    return ell_spmv(ell.flat, ell.adj, x)
