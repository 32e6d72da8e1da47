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
  ``solve.slab.slab_apply`` over lanes.
- segment_sum: the sorted-segment sum of FEM assembly
  (``csrc/segment_sum.cu``) — the counterpart of
  ``gmpnp_tpu/fem/assembly.py::_segment_reduce``: every residual and
  Jacobian of ``fem.assembly.FemSpace`` (over lanes through the custom
  op's vmap rule) and the sharded band assembly.
- block_inv: the batched Gauss-Jordan inverse of small blocks with the
  reference's guards (``csrc/block_inv.cu``) — the counterpart of
  ``gmpnp_tpu/solve/smallblock.py::block_inv``: the 1D cyclic reduction,
  the slab and block-Jacobi equilibrations, AMG and the sharded diagonal.
- pore_residual: the element residuals of the 3D pore's volume form on P1
  tetrahedra (``csrc/pore_residual.cu``) — the counterpart of the jnp
  element loop of ``gmpnp_tpu/fem/assembly.py::FemSpace.residual``:
  ``FemSpace.residual`` of a form that carries a
  ``models.pore_3d.PoreVolumeSpec``, on CUDA tensors (over lanes through
  the custom op's vmap rule).
- sechenov: the 3D pore's per-step Sechenov CO2 Dirichlet value from four
  exact medians (``csrc/sechenov.cu``) — the counterpart of the
  ``jnp.median`` and ``co2_saturation_conc`` of
  ``gmpnp_tpu/models/pore_3d.py``'s ``_theta_of_carry``:
  ``models.pore_3d.Pore3DProgram._theta_of_carry`` on CUDA tensors.
- cr_apply: the 1D block cyclic-reduction apply, every level in one
  launch (``csrc/cr_apply.cu``) — the counterpart of
  ``gmpnp_tpu/solve/linear.py::block_tridiag_apply_cr``:
  ``solve.linear.block_tridiag_apply_cr`` on CUDA tensors (the carried 1D
  chord step, the f32 preconditioner of ``tridiag_mp_solve``, over lanes
  too).

``COUNTERS`` maps each kernel's name to its (``LAUNCHES``,
``SHAPE_LAUNCHES``): launches per dtype and per shape, counted where the
kernel is launched.
"""

from gmpnp_tpu_torch.ops.block_inv import LAUNCHES as _BLOCK_INV_LAUNCHES
from gmpnp_tpu_torch.ops.block_inv import SHAPE_LAUNCHES as _BLOCK_INV_SHAPES
from gmpnp_tpu_torch.ops.block_inv import block_inv, block_inv_reference
from gmpnp_tpu_torch.ops.cr_apply import LAUNCHES as _CR_APPLY_LAUNCHES
from gmpnp_tpu_torch.ops.cr_apply import SHAPE_LAUNCHES as _CR_APPLY_SHAPES
from gmpnp_tpu_torch.ops.cr_apply import cr_apply, cr_apply_reference
from gmpnp_tpu_torch.ops.ell_spmv import (
    LAUNCHES, SHAPE_LAUNCHES, ell_spmv, ell_spmv_reference)
from gmpnp_tpu_torch.ops.pore_residual import LAUNCHES as _PORE_LAUNCHES
from gmpnp_tpu_torch.ops.pore_residual import SHAPE_LAUNCHES as _PORE_SHAPES
from gmpnp_tpu_torch.ops.pore_residual import (
    pore_residual, pore_residual_reference)
from gmpnp_tpu_torch.ops.sechenov import LAUNCHES as _SECHENOV_LAUNCHES
from gmpnp_tpu_torch.ops.sechenov import SHAPE_LAUNCHES as _SECHENOV_SHAPES
from gmpnp_tpu_torch.ops.sechenov import (
    SechenovConstants, sechenov_co2, sechenov_co2_reference)
from gmpnp_tpu_torch.ops.segment_sum import LAUNCHES as _SEGMENT_LAUNCHES
from gmpnp_tpu_torch.ops.segment_sum import SHAPE_LAUNCHES as _SEGMENT_SHAPES
from gmpnp_tpu_torch.ops.segment_sum import (
    segment_sum, segment_sum_op, segment_sum_reference)

COUNTERS = {
    "ell_spmv": (LAUNCHES, SHAPE_LAUNCHES),
    "segment_sum": (_SEGMENT_LAUNCHES, _SEGMENT_SHAPES),
    "block_inv": (_BLOCK_INV_LAUNCHES, _BLOCK_INV_SHAPES),
    "pore_residual": (_PORE_LAUNCHES, _PORE_SHAPES),
    "sechenov": (_SECHENOV_LAUNCHES, _SECHENOV_SHAPES),
    "cr_apply": (_CR_APPLY_LAUNCHES, _CR_APPLY_SHAPES),
}

__all__ = ["COUNTERS", "LAUNCHES", "SHAPE_LAUNCHES", "SechenovConstants",
           "block_inv", "block_inv_reference", "cr_apply",
           "cr_apply_reference", "ell_spmv",
           "ell_spmv_reference", "pore_residual", "pore_residual_reference",
           "sechenov_co2", "sechenov_co2_reference", "segment_sum",
           "segment_sum_op", "segment_sum_reference"]
