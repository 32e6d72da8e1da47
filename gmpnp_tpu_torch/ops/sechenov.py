"""The 3D pore's Sechenov CO2 Dirichlet value: the CUDA kernel's wrapper,
its plain version and the layout of its constants.

Replaces no Pallas kernel: the counterpart is the reference's per-step
update (``gmpnp_tpu/models/pore_3d.py``, ``_theta_of_carry``: ``jnp.median``
of four fields and ``chem/henry.py::co2_saturation_conc``, fused by XLA on
the TPU).  In the port that update runs as four ``torch.sort`` calls and
some 40 launch-sized scalar operations a step; the kernel
(``csrc/sechenov.cu``) takes the four exact medians by radix select, one
block each in one cluster, and evaluates the Sechenov value in the same
launch.  Bound: latency, a launch and a few short passes (``PERF.md``
section 6).

``SechenovConstants`` holds what the value needs besides u, as ``build``
computes it once (``models.pore_3d``); ``pack`` lays it out as the kernel
reads it.  ``sechenov_co2_reference`` is the plain version, the one place
the formula is written: ``median`` and the operations of
``chem.henry.co2_saturation_conc``, in its order.  The kernel mirrors it
operation for operation, as each rounds on the card.

``sechenov_co2`` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors only.  ``LAUNCHES`` counts kernel
launches per dtype and ``SHAPE_LAUNCHES`` per (N, f, dtype name).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float64: 0}
#: kernel launches per (N, f, dtype name), counted at the same place
SHAPE_LAUNCHES = {}

#: the medians the kernel takes, one block each (csrc/sechenov.cu:
#: kColumns), and the doubles of its constants (kConsts)
N_COLUMNS = 4
N_CONSTS = 3 * N_COLUMNS + 3
#: the column lengths the kernel takes (its counts are 32-bit)
MAX_ROWS = 2 ** 31 - 1


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of a 1-D tensor that averages the two middle values on even
    length — ``jnp.median``'s 'midpoint' rule, (lo + hi) * 0.5.
    (``torch.median`` returns the lower middle value instead.)"""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


@dataclass(frozen=True)
class SechenovConstants:
    """The Sechenov value's constants: the four fields whose medians it
    takes (OH, HCO3, CO32, then the cation with ``gmpnp``, else H, the
    cation following by electroneutrality), their bulk concentrations
    ``bc0``, ``h`` = h_ion + h_CO2 of OH, HCO3, CO32 and the cation, ``A`` =
    fugacity_CO2 * K_H * 1000 and the CO2 bulk concentration ``bc0_CO2``,
    all host floats as ``co2_saturation_conc`` computes them."""

    fields: tuple
    bc0: tuple
    h: tuple
    gmpnp: bool
    A: float
    bc0_CO2: float

    def __post_init__(self):
        if not (len(self.fields) == len(self.bc0) == len(self.h)
                == N_COLUMNS):
            raise ValueError(f"SechenovConstants: {N_COLUMNS} fields, "
                             f"bulk concentrations and h values, got "
                             f"{self.fields}, {self.bc0}, {self.h}")

    def pack(self) -> tuple:
        """The N_CONSTS floats the kernel reads: fields, bc0, h, the GMPNP
        flag, A, bc0_CO2."""
        return tuple(float(v) for v in (
            *self.fields, *self.bc0, *self.h, int(self.gmpnp), self.A,
            self.bc0_CO2))

    @functools.cached_property
    def packed(self):
        """``pack()`` as the C array the launch passes (host memory)."""
        return (ctypes.c_double * N_CONSTS)(*self.pack())


def sechenov_co2_reference(u: torch.Tensor,
                           consts: SechenovConstants) -> torch.Tensor:
    """Plain PyTorch version: the Sechenov-corrected CO2 saturation over its
    bulk value, 0-d, from the medians of u (N, f) — ``median`` and
    ``chem.henry.co2_saturation_conc``'s operations in its order
    (concentrations in kmol/m^3 in the salting-out sum)."""
    conc = [median(u[:, i]) * b for i, b in zip(consts.fields, consts.bc0)]
    if not consts.gmpnp:
        oh, hco3, co32, h = conc
        conc[3] = hco3 + 2 * co32 + oh - h
    sechenov = 0.0
    for h_ion, c in zip(consts.h, conc):
        sechenov = sechenov + h_ion * (c / 1000.0)
    return consts.A * 10.0 ** (-sechenov) / consts.bc0_CO2


def sechenov_co2(u: torch.Tensor, consts: SechenovConstants,
                 medians: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Sechenov CO2 Dirichlet value (0-d float64) from u (N, f): CUDA
    tensors launch the kernel on the current stream, which also writes the
    four medians into ``medians`` (4,) float64 when given (the kernel
    only); CPU tensors take the plain version."""
    if u.device.type == "cpu":
        if medians is not None:
            raise ValueError("sechenov_co2: only the kernel writes medians")
        return sechenov_co2_reference(u, consts)
    if u.device.type != "cuda":
        raise ValueError(f"sechenov_co2 runs on cuda or cpu, got {u.device}")
    if u.dim() != 2 or not 1 <= u.shape[0] <= MAX_ROWS:
        raise ValueError(f"sechenov_co2 wants u (N, f) with 1 <= N <= "
                         f"{MAX_ROWS}, got {tuple(u.shape)}")
    if u.dtype != torch.float64:
        raise TypeError(f"sechenov_co2 takes float64, got {u.dtype}")
    if not u.is_contiguous():
        raise ValueError("sechenov_co2: u must be contiguous")
    N, f = u.shape
    if not all(0 <= i < f for i in consts.fields):
        raise ValueError(f"sechenov_co2: fields {consts.fields} outside "
                         f"u's {f}")
    if medians is not None and (
            medians.shape != (N_COLUMNS,) or medians.dtype != torch.float64
            or medians.device != u.device or not medians.is_contiguous()):
        raise ValueError(f"sechenov_co2: medians want ({N_COLUMNS},) "
                         f"float64 on {u.device}")
    from gmpnp_tpu_torch.ops._build import load_library

    out = torch.empty((), dtype=torch.float64, device=u.device)
    lib = load_library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.sechenov_co2_f64(
            u.data_ptr(), out.data_ptr(),
            None if medians is None else medians.data_ptr(), N, f,
            consts.packed, stream)
    if err != 0:
        raise RuntimeError(f"sechenov kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[torch.float64] += 1
    key = (N, f, "float64")
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out
