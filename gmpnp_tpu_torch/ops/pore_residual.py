"""Element residuals of the 3D pore's volume form: the CUDA kernel's
wrapper, its plain version, the layout of its constants and the custom op
that carries the kernel through ``torch.func.vmap``.

Replaces no Pallas kernel: the counterpart is the jnp element residual of
``gmpnp_tpu/fem/assembly.py`` (``FemSpace._local_volume_residual`` under
``vmap``, fused by XLA on the TPU).  In the port that path runs as
``torch.func`` ops, about 75 device operations per call on the card, most
of them tiny batched f64 matrix products; the kernel
(``csrc/pore_residual.cu``) computes the element residuals r (C, 4, f) of
P1 tetrahedra in one launch, a thread per (element, field), each summing
its quadrature points in a fixed order (bitwise repeatable).  Bound: bytes,
under a launch (``PERF.md`` section 6).

The integrand and its constants are the model's
(``models.pore_3d.PoreVolumeSpec``: ``volume``, ``constants``);
``pack_constants`` lays the constants out as the kernel reads them.
``pore_residual_reference`` is the plain version: ``FemSpace``'s element
loop (``fem.assembly.element_volume_residual``, vmapped over elements)
over the spec's ``volume``.

``pore_residual`` launches the kernel for CUDA tensors (or raises) and runs
the plain version for CPU tensors only.  ``pore_residual_op`` is the
launch as the custom op ``gmpnp_tpu_torch::pore_volume_residual``, whose
vmap rule turns a vmapped call (``FemSpace.residual_lanes``) into one
lane-axis launch.  ``LAUNCHES`` counts kernel launches per dtype and
``SHAPE_LAUNCHES`` per (C, Q, f, dtype name), or (V, C, Q, f, dtype name)
over lanes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.func import vmap

#: kernel launches per dtype, counted where the kernel is launched
LAUNCHES = {torch.float64: 0}
#: kernel launches per (C, Q, f, dtype name) or (V, C, Q, f, dtype name),
#: counted at the same place
SHAPE_LAUNCHES = {}

#: the fields and quadrature points the kernel takes
#: (csrc/pore_residual.cu: kMinFields, kMaxFields, kMaxQ)
MIN_FIELDS = 7
MAX_FIELDS = 16
MAX_POINTS = 16
#: the kernel's constants, its enum's layout: a header of small integers,
#: the scalars, then one row of MAX_FIELDS per per-species table
_HEADER = ("f", "ns", "gmpnp", "clip_on", "H", "OH", "HCO3", "CO32", "CO2",
           "cat", "proton")
_SCALARS = ("kw1", "kw2", "ka1", "ka2", "kb1", "kb2", "q", "steric_clip",
            "w_cat", "C0_cat", "w_H", "C0_H", "eps_rel")
_TABLES = ("z", "scale_vol", "c0", "scale_R", "zc0")
N_CONSTS = len(_HEADER) + len(_SCALARS) + len(_TABLES) * MAX_FIELDS


def pack_constants(values: dict) -> tuple:
    """The N_CONSTS floats the kernel reads, from ``values`` keyed by the
    names of ``_HEADER``, ``_SCALARS`` and ``_TABLES`` (a table holds one
    entry per species, padded with zeros)."""
    out = [float(values[k]) for k in _HEADER + _SCALARS]
    for k in _TABLES:
        t = values[k]
        out += [float(v) for v in t] + [0.0] * (MAX_FIELDS - len(t))
    return tuple(out)


def pore_residual_reference(u, u_prev, dt, cells, gradN, vols, Nq, wq,
                            spec) -> torch.Tensor:
    """Plain PyTorch version: ``FemSpace``'s element loop over
    ``spec.volume``, vmapped over elements, the operations of
    ``FemSpace.residual``'s volume term of the pore's form.  u, u_prev
    (N, f) -> (C, 4, f); ``dt`` a float or a 0-d tensor."""
    # imported here: fem.assembly imports this module
    from gmpnp_tpu_torch.fem.assembly import element_volume_residual

    theta = {"dt": dt}
    return vmap(lambda ue, upe, g, v: element_volume_residual(
        spec.volume, ue, upe, g, v, Nq, wq, None, theta))(
            u[cells], u_prev[cells], gradN, vols)


def pore_residual(u, u_prev, dt, cells, gradN, vols, Nq, wq,
                  spec) -> torch.Tensor:
    """Element residuals (C, 4, f) of the pore's volume form at u, u_prev
    (N, f) float64, with the space's tables: cells (C, 4) int64, gradN (C,
    4, 3), vols (C,), the quadrature's Nq (Q, 4) and wq (Q,); ``spec`` a
    ``models.pore_3d.PoreVolumeSpec``.  ``dt`` is a host scalar or a 0-d
    tensor (per lane under ``vmap``).  CUDA tensors launch the kernel on
    the current stream (under ``vmap``, one launch for all lanes); CPU
    tensors take the plain version."""
    if u.device.type == "cpu":
        return pore_residual_reference(u, u_prev, dt, cells, gradN, vols,
                                       Nq, wq, spec)
    if u.device.type != "cuda":
        raise ValueError(f"pore_residual runs on cuda or cpu, got "
                         f"{u.device}")
    if u.shape[-1] != spec.n_fields:
        raise ValueError(f"pore_residual: the spec has {spec.n_fields} "
                         f"fields, u {tuple(u.shape)}")
    if isinstance(dt, torch.Tensor):
        dt_lanes, dt_value = dt.to(device=u.device, dtype=torch.float64), 0.0
    else:
        dt_lanes, dt_value = None, float(dt)
    return pore_residual_op(u.contiguous(), u_prev.contiguous(), dt_lanes,
                            dt_value, cells, gradN, vols, Nq, wq,
                            spec.constants(u.device))


def _check(u, u_prev, dt_lanes, cells, gradN, vols, Nq, wq, consts) -> None:
    if u.dim() < 2 or u.shape != u_prev.shape:
        raise ValueError(f"pore_residual wants u and u_prev (..., N, f) of "
                         f"one shape, got {tuple(u.shape)} and "
                         f"{tuple(u_prev.shape)}")
    C = cells.shape[0]
    Q = Nq.shape[0]
    shapes = ((cells, (C, 4)), (gradN, (C, 4, 3)), (vols, (C,)),
              (Nq, (Q, 4)), (wq, (Q,)), (consts, (N_CONSTS,)))
    if dt_lanes is not None:
        shapes += ((dt_lanes, tuple(u.shape[:-2])),)
    for name, (t, shape) in zip(
            ("cells", "gradN", "vols", "Nq", "wq", "consts", "dt"), shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"pore_residual: {name} {tuple(t.shape)}, want "
                             f"{shape}")
    floats = [u, u_prev, gradN, vols, Nq, wq, consts] + (
        [] if dt_lanes is None else [dt_lanes])
    if cells.dtype != torch.int64 or any(t.dtype != torch.float64
                                         for t in floats):
        raise TypeError("pore_residual takes float64 states and tables and "
                        "int64 cells")
    every = floats + [cells]
    if any(t.device != u.device for t in every):
        raise ValueError("pore_residual operands on different devices")
    if not all(t.is_contiguous() for t in every):
        raise ValueError("pore_residual operands must be contiguous")
    if (not MIN_FIELDS <= u.shape[-1] <= MAX_FIELDS
            or not 1 <= Q <= MAX_POINTS):
        raise ValueError(f"pore_residual takes {MIN_FIELDS}..{MAX_FIELDS} "
                         f"fields and 1..{MAX_POINTS} points, got "
                         f"f={u.shape[-1]}, Q={Q}")


def _launch(u, u_prev, dt_lanes, dt_value, cells, gradN, vols, Nq, wq,
            consts) -> torch.Tensor:
    """One kernel launch over the lanes of u (..., N, f)."""
    _check(u, u_prev, dt_lanes, cells, gradN, vols, Nq, wq, consts)
    if u.device.type != "cuda":
        raise ValueError(f"the pore residual kernel runs on cuda, got "
                         f"{u.device}")
    from gmpnp_tpu_torch.ops._build import load_library

    lead = tuple(u.shape[:-2])
    lanes = math.prod(lead)
    N, f = u.shape[-2:]
    C, Q = cells.shape[0], Nq.shape[0]
    out = torch.empty(lead + (C, 4, f), dtype=torch.float64, device=u.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.pore_volume_residual_f64(
            u.data_ptr(), u_prev.data_ptr(),
            None if dt_lanes is None else dt_lanes.data_ptr(), dt_value,
            cells.data_ptr(), gradN.data_ptr(), vols.data_ptr(),
            Nq.data_ptr(), wq.data_ptr(), consts.data_ptr(), out.data_ptr(),
            C, Q, f, lanes, N * f, C * 4 * f, stream)
    if err != 0:
        raise RuntimeError(f"pore residual kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES[torch.float64] += 1
    key = (C, Q, f, "float64")
    if lead:
        key = (lanes,) + key
    SHAPE_LAUNCHES[key] = SHAPE_LAUNCHES.get(key, 0) + 1
    return out


@torch.library.custom_op("gmpnp_tpu_torch::pore_volume_residual",
                         mutates_args=())
def pore_residual_op(u: torch.Tensor, u_prev: torch.Tensor,
                     dt_lanes: Optional[torch.Tensor], dt_value: float,
                     cells: torch.Tensor, gradN: torch.Tensor,
                     vols: torch.Tensor, Nq: torch.Tensor, wq: torch.Tensor,
                     consts: torch.Tensor) -> torch.Tensor:
    """The kernel's launch as a custom op, so that ``torch.func.vmap`` over
    it makes one lane-axis launch (its vmap rule below): u, u_prev (...,
    N, f), ``dt_lanes`` None (``dt_value`` for every lane) or of u's
    leading shape, ``consts`` = the spec's ``constants``."""
    return _launch(u, u_prev, dt_lanes, dt_value, cells, gradN, vols, Nq,
                   wq, consts)


@pore_residual_op.register_vmap
def _(info, in_dims, u, u_prev, dt_lanes, dt_value, cells, gradN, vols, Nq,
      wq, consts):
    """vmap over the states and dt: the lane axis moved to the front (an
    unbatched operand expanded to it; nested vmaps add leading axes), one
    launch over all lanes, each lane computed as a one-lane launch computes
    it.  The tables are shared by every lane."""
    u_dim, up_dim, dt_dim, _, *table_dims = in_dims
    if any(dim is not None for dim in table_dims):
        raise ValueError("pore_residual: vmap over the tables is not "
                         "supported (every lane shares one mesh)")

    def front(t, dim):
        t = (t.movedim(dim, 0) if dim is not None
             else t.expand((info.batch_size,) + tuple(t.shape)))
        return t.contiguous()

    dt = None if dt_lanes is None else front(dt_lanes, dt_dim)
    return pore_residual_op(front(u, u_dim), front(u_prev, up_dim), dt,
                            dt_value, cells, gradN, vols, Nq, wq, consts), 0
