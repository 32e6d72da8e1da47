"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

Kernels:
- ell_spmv: block-ELL matvec with the neighbour gather fused in
  (``csrc/ell_spmv.cu``, f32 and f64) — the port of
  ``gmpnp_tpu/ops/ell_spmv.py::ell_block_contract_pallas``.  It is the
  matvec of the carried-mode f32 chord GMRES (``solve.slab.slab_apply_f32``)
  and of ``fem.assembly.BlockELL.matvec`` on CUDA tensors: the f64 GMRES
  of the exact slab path, of the 1D ``solve.linear.tridiag_mp_solve`` and
  of the Krylov fallbacks (every AMG level included); over a lane axis
  (one launch for the V lanes of a batched sweep) it is the matvec of
  ``solve.slab.slab_apply_lanes``.
"""

from gmpnp_tpu_torch.ops.ell_spmv import (
    LAUNCHES, SHAPE_LAUNCHES, ell_spmv, ell_spmv_reference)

__all__ = ["LAUNCHES", "SHAPE_LAUNCHES", "ell_spmv", "ell_spmv_reference"]
