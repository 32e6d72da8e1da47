"""gmpnp_tpu_torch — the PyTorch + CUDA port of gmpnp_tpu.

The same generalized modified Poisson–Nernst–Planck (GMPNP) framework as
``gmpnp_tpu``, run eagerly in PyTorch on an NVIDIA GPU (Hopper, ``sm_90a``)
or on the CPU.  The layout mirrors ``gmpnp_tpu`` module for module, so the
counterpart of ``gmpnp_tpu/solve/slab.py::slab_apply_f32`` is
``gmpnp_tpu_torch/solve/slab.py::slab_apply_f32``.

This package imports neither ``jax`` nor ``gmpnp_tpu``.  It sets no global
default dtype: every tensor it creates names its ``dtype`` and ``device``.
Host-side numpy modules (constants, config, mesh, bulk chemistry, writers)
are copies of the reference's; the native mesh library (``native/``) is
shared with it.

Layout
------
- ``constants``, ``config`` : parameter sets and YAML config loading (numpy)
- ``chem``   : buffer kinetics and Henry/Sechenov solubility on tensors
- ``mesh``   : meshes, generators, marking (numpy; shared native library)
- ``fem``    : P1 assembly into block-ELL (``torch.func`` Jacobians), BCs
- ``ops``    : hand-written CUDA kernels with their plain PyTorch versions
- ``solve``  : small-block inverses, 1D block-tridiagonal solvers, GMRES
               and BiCGStab with block-Jacobi / SSOR / AMG preconditioners,
               z-slab direct solver (Thomas and cyclic reduction), Newton,
               time loop
- ``models`` : the 3D pore (GMPNP and reaction-diffusion), the 1D EDL and
               the 1D reaction-diffusion models
- ``parallel``: voltage and cation sweeps; z-slab domain decomposition
               over a line of ranks (halo exchange, distributed SPIKE)
- ``io``     : npz/metadata/VTK writers, checkpoint/resume
- ``utils``  : step logger, phase timer, ``torch.profiler`` traces
- ``cli``    : command-line entry points
"""

__version__ = "0.1.0"
