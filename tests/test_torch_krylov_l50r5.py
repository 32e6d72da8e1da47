"""Port vs reference: f64 GMRES with multicolor SSOR or AMG on the
L=50 nm, R=5 nm pore's raw cold-start system (N=2,501, 22,509 unknowns),
the system on which the port's f64 Krylov fallbacks spend their 3,000
iterations without converging on the card.

The reference's residual histories are read from
``goldens/torch_krylov_l50r5.json``; ``python
tests/test_torch_krylov_l50r5.py`` rewrites that file from ``gmpnp_tpu``
(~1 min on one CPU core).  Each history is the true relative residual
||b - A x|| / ||b|| (recomputed in f64) after k = 30, 60, 120 and 210
iterations of GMRES(30) at tol 1e-12, one run per k (restarted GMRES with
maxiter a multiple of the restart makes the same cycles as the first k
iterations of a longer run).

The finding: the reference stagnates where the port does.  With SSOR
both packages stall at a true relative residual of 1.78e-6 by iteration
120 (the port's 3,000-iteration card run ends at 1.78e-6 too); with AMG
both stall at 2.1-2.3e-5 (the card: 2.35e-5).  No port fault: the raw
f64 system (block rows ~1e8 apart in scale) is beyond these two
preconditioners in both packages.

Tolerances, each with its reason:
- SSOR: the port's history within 1e-6 relative of the reference's (the
  port assembles its own system, ~1e-13 from the reference's; on the
  reference's own system the histories agree to 1e-10);
- AMG: within a factor 1.5 of the reference's at 120 and 210 iterations,
  where both have stalled (its coarsest level is an f32 LU whose factors
  differ between the two LAPACKs by f32 rounding,
  tests/test_torch_krylov.py; measured 0.94-1.0x).  Before the stall the
  AMG history is erratic: at 60 iterations the port lies 0.58x (on the
  reference's own system) to 2.8x (on its own) from the reference;
- both: unconverged at the chip runs' tol (true residual above 1e-6) after
  210 iterations, as the reference is.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "torch_krylov_l50r5.json")
ITERS = (30, 60, 120, 210)
PORE = {"L": 50e-9, "R": 5e-9}


def _true_rel(flat, adj, b, x):
    Ax = np.einsum("nrk,nk->nr", flat, x[adj].reshape(len(adj), -1))
    return float(np.linalg.norm(b - Ax) / np.linalg.norm(b))


def write_golden():
    import jax
    import jax.numpy as jnp
    from gmpnp_tpu.models import pore_3d as jp3
    from gmpnp_tpu.solve import amg as jamg
    from gmpnp_tpu.solve import linear as jlin

    prog = jp3.build(jp3.Pore3DConfig(**PORE))
    cfg = prog.config
    N, nf = prog.space.num_vertices, cfg.n_fields
    u0 = jnp.ones((N, nf)).at[:, len(cfg.species)].set(0.0)
    theta = prog._theta_of_carry((u0, jnp.asarray(0.0)), jnp.asarray(0))
    bc = prog._bc_of_theta(theta)
    u = bc.project(u0)
    ell = bc.apply_to_jacobian(prog.space.jacobian(prog.form, u, u0, theta))
    r = bc.apply_to_residual(prog.space.residual(prog.form, u, u0, theta), u)
    b = np.asarray(r)
    flat, adj = np.asarray(ell.flat), np.asarray(ell.adj)
    pcs = {"ssor": jlin.multicolor_ssor_preconditioner(ell,
                                                        prog.space.colors),
           "amg": jamg.amg_preconditioner(
               ell, jamg.AMGPlan.build(np.asarray(prog.space.adj), nf))}
    out = {"N": N, "iters": list(ITERS)}
    for name, pc in pcs.items():
        out[name] = []
        for k in ITERS:
            res = jax.jit(lambda v: jlin.gmres(
                ell.matvec, v, Minv=pc, tol=1e-12, restart=30,
                maxiter=k))(jnp.asarray(b))
            out[name].append(_true_rel(flat, adj, b, np.asarray(res.x)))
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def system():
    """The port's own cold-start system at L50R5 (as chip_smoke.py's
    Krylov phase assembles it)."""
    from gmpnp_tpu_torch.models import pore_3d

    torch.set_num_threads(1)
    prog = pore_3d.build(pore_3d.Pore3DConfig(**PORE), device="cpu")
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    bc = prog._bc_of_theta(theta)
    u = bc.project(u0)
    ell = bc.apply_to_jacobian(prog.space.jacobian(prog.form, u, u0, theta))
    r = bc.apply_to_residual(prog.space.residual(prog.form, u, u0, theta), u)
    return prog, ell, r


@pytest.mark.parametrize("precond", ["ssor", "amg"])
def test_f64_krylov_stagnates_as_the_reference_does(system, precond):
    from gmpnp_tpu_torch.solve import amg, linear

    prog, ell, r = system
    with open(GOLDEN) as fh:
        ref = json.load(fh)
    assert ref["N"] == prog.space.num_vertices
    pc = (linear.multicolor_ssor_preconditioner(ell, prog.space.colors)
          if precond == "ssor" else amg.amg_preconditioner(
              ell, amg.AMGPlan.build(np.asarray(prog.space.adj), 9)))
    flat, adj, b = (ell.flat.numpy(), ell.adj.numpy(), r.numpy())
    got = []
    for k in (120, 210):
        res = linear.gmres(ell.matvec, r, Minv=pc, tol=1e-12, restart=30,
                           maxiter=k)
        got.append(_true_rel(flat, adj, b, res.x.numpy()))
    want = [ref[precond][ITERS.index(k)] for k in (120, 210)]
    print(f"{precond}: port {got}, reference {want} at 120 / 210 "
          f"iterations")
    if precond == "ssor":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        assert all(w / 1.5 <= g <= w * 1.5 for g, w in zip(got, want))
    assert got[-1] > 1e-6 and want[-1] > 1e-6


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
    print(f"wrote {GOLDEN}")
