"""Port vs reference: batched sweep lanes under the pore model's Krylov
kinds (GMRES and BiCGStab under block-Jacobi, multicolor SSOR and AMG, f32
and f64), each Newton iteration one lane-batched linear solve
(``solve.timeloop.make_linear_solver_lanes``).  The slab solver's cyclic
reduction, the dense solver and the 1D kinds are held in
tests/test_torch_sweep_batched.py.

The reference's vmapped sweeps (``chunk`` >= lanes) of two kinds are read
from ``goldens/torch_sweep_kinds.json`` (their XLA compiles take minutes
on one CPU core); ``PYTHONPATH=. python tests/test_torch_sweep_kinds.py``
rewrites that file from ``gmpnp_tpu``.

The (2, 8) pore, lanes -0.5 and -1.0 V, one cold-start step staged at
1e-3 of the schedule's dt (``dt_first_scale``, the pore's staged first
step): at the full dt f32 BiCGStab + block-Jacobi breaks down and Newton
spends its 50 iterations unconverged, in both packages.

Tolerances, each with its reason:
- each batched lane against the same lane run with ``chunk=0``: 1e-10
  with the same Newton and Krylov counts, f32 kinds included.  On the CPU
  each lane of a batched solve takes its single-lane solve's arithmetic
  (the lane-axis block-ELL product, ``block_inv`` and the Krylov
  reductions lane by lane), so the lanes agree to the last digits; on the
  card batched f32 products round otherwise, and ``chip_smoke.py`` holds
  f32 kinds to 1e-4 with Newton counts within 1;
- each batched lane against the reference's vmapped lane: f64 GMRES +
  AMG within 1e-7 (tests/test_parallel.py's bar between the reference's
  vmap and chunk modes) with Newton counts within 1; f32 BiCGStab +
  block-Jacobi within 1e-4 with Newton counts within 1 (f32 BiCGStab's
  iterates leave the reference's after a few iterations by rounding,
  tests/test_torch_krylov.py, so Newton stops at another point inside its
  tolerance 1e-4).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.models import pore_3d  # noqa: E402
from gmpnp_tpu_torch.parallel import sweep  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "torch_sweep_kinds.json")
VOLTS = [-0.5, -1.0]

#: kind -> LinearConfig fields of its sweep
KINDS = {
    "bicgstab_block_jacobi_f32": dict(kind="bicgstab", precond="block_jacobi",
                                      solve_dtype="f32", tol=1e-5,
                                      maxiter=2000),
    "gmres_amg_f64": dict(kind="gmres", precond="amg", tol=1e-8,
                          maxiter=1000),
    "gmres_block_jacobi_f32": dict(kind="gmres", precond="block_jacobi",
                                   solve_dtype="f32", tol=1e-5, maxiter=600),
    "bicgstab_ssor_f64": dict(kind="bicgstab", precond="ssor", tol=1e-6,
                              maxiter=2000),
}
#: the kinds whose reference sweep the golden holds, with (rtol, Newton gap)
REFERENCE_BARS = {"bicgstab_block_jacobi_f32": (1e-4, 1),
                  "gmres_amg_f64": (1e-7, 1)}


def _cfg(kind, mod=pore_3d):
    cfg = mod.Pore3DConfig(mesh_resolution=(2, 8), dt_first_scale=1e-3)
    return dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, **KINDS[kind]))


def write_golden():
    from gmpnp_tpu.models import pore_3d as jp3
    from gmpnp_tpu.parallel import sweep as jsweep

    out = {}
    for kind in REFERENCE_BARS:
        u, st = jsweep.run_pore_voltage_sweep(_cfg(kind, jp3), VOLTS,
                                              n_steps=1, chunk=len(VOLTS))
        out[kind] = {"final": np.asarray(u)[:, -1].tolist(),
                     "newton_iters": np.asarray(st.newton_iters).tolist(),
                     "converged": np.asarray(st.converged).tolist()}
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


def _run(kind, chunk):
    info = {}
    u, st = sweep.run_pore_voltage_sweep(_cfg(kind), VOLTS, n_steps=1,
                                         chunk=chunk, device="cpu",
                                         info=info)
    assert info["chunk"] == chunk
    return u, st


@pytest.mark.parametrize("kind", list(KINDS))
def test_batched_kind_matches_chunk0(kind):
    u, st = _run(kind, len(VOLTS))
    u0, st0 = _run(kind, 0)
    assert st.converged.all() and st0.converged.all()
    np.testing.assert_allclose(u.numpy(), u0.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(st.newton_iters, st0.newton_iters)
    np.testing.assert_array_equal(st.linear_iters, st0.linear_iters)
    assert (st.linear_iters > 0).all()
    if kind in REFERENCE_BARS:
        with open(GOLDEN) as fh:
            ref = json.load(fh)[kind]
        bar, gap = REFERENCE_BARS[kind]
        np.testing.assert_allclose(u[:, -1].numpy(),
                                   np.asarray(ref["final"]), rtol=bar,
                                   atol=bar)
        assert (np.abs(st.newton_iters - np.asarray(ref["newton_iters"]))
                <= gap).all()
        np.testing.assert_array_equal(st.converged, ref["converged"])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
    print(f"wrote {GOLDEN}")
