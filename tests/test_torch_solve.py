"""Port vs reference: GMRES, the z-slab factorization and applies, and one
Newton step of the GMPNP pore.

Tolerances, each with its reason:
- GMRES x: 1e-10 (f64, tol 1e-12 solves) and 1e-5 (f32, tol 1e-6 solves)
  relative L2 — the Krylov tolerance each side is held to;
- slab factors: the f64 equilibration 1e-13; the f32 factors are held to
  their defining relations (f32 inverses of bands whose Schur complements
  grow ill-conditioned along the elimination differ between LAPACKs by
  cond x eps_f32 — 3e-2 on the last slab here): each slab's
  ||denom Dinv - I|| within 2x the reference's own, Cp = Dinv C to 1e-5;
- slab_apply: 1e-8 relative L2 to the dense solve and to the reference
  (the BASELINE bar, tests/test_slab.py::test_newton_step_slab_vs_dense_1e8);
- slab_apply_f32: 1e-5 relative L2 to the reference on a well-conditioned
  system (the f32 GMRES tolerance floor); on the pore Jacobian the same
  iteration count and 1e-3 to the exact solve, the reference's own bar
  (tests/test_slab.py::test_slab_apply_f32_direction_quality);
- Newton step: identical iteration counts; state 1e-8 per field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.fem.assembly import BlockELL as JBlockELL  # noqa: E402
from gmpnp_tpu.models import pore_3d as jp3  # noqa: E402
from gmpnp_tpu.solve import slab as jslab  # noqa: E402
from gmpnp_tpu.solve.linear import dense_solve as jdense  # noqa: E402
from gmpnp_tpu.solve.linear import gmres as jgmres  # noqa: E402
from gmpnp_tpu.solve.timeloop import LinearConfig as JLin  # noqa: E402
from gmpnp_tpu.solve.timeloop import make_implicit_step as jstep  # noqa: E402
from gmpnp_tpu_torch.interop import (  # noqa: E402
    blockell_from_numpy,
    slab_prepared_from_numpy,
)
from gmpnp_tpu_torch.models import pore_3d as tp3  # noqa: E402
from gmpnp_tpu_torch.solve import slab as tslab  # noqa: E402
from gmpnp_tpu_torch.solve.linear import dense_solve as tdense  # noqa: E402
from gmpnp_tpu_torch.solve.linear import gmres as tgmres  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import LinearConfig as TLin  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import make_implicit_step as tstep  # noqa: E402
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

RES = (2, 10)


@pytest.fixture(scope="module")
def pore():
    """Both programs, and the reference's BC-applied Jacobian and residual
    at the first step's start state."""
    jprog = jp3.build(jp3.Pore3DConfig(mesh_resolution=RES))
    tprog = tp3.build(tp3.Pore3DConfig(mesh_resolution=RES), device="cpu")
    ns = len(jprog.config.species)
    u0 = jnp.ones((jprog.space.num_vertices, jprog.config.n_fields))
    u0 = u0.at[:, ns].set(0.0)
    theta = jprog._theta_of_carry((u0, 0.0), 0)
    bc = jprog._bc_of_theta(theta)
    u = bc.project(u0)
    J = jax.jit(lambda a: bc.apply_to_jacobian(
        jprog.space.jacobian(jprog.form, a, u0, theta)))(u)
    r = jax.jit(lambda a: bc.apply_to_residual(
        jprog.space.residual(jprog.form, a, u0, theta), a))(u)
    plan = jslab.SlabPlan.build(
        np.asarray(jprog.space.adj), np.asarray(jprog.space.points)[:, -1],
        jprog.config.n_fields, np.asarray(jprog.space.diag_slot))
    tplan = tslab.SlabPlan.build(
        np.asarray(jprog.space.adj), np.asarray(jprog.space.points)[:, -1],
        jprog.config.n_fields, np.asarray(jprog.space.diag_slot))
    tJ = blockell_from_numpy(np.asarray(J.adj), np.asarray(J.flat),
                             np.asarray(J.diag_slot))
    return dict(jprog=jprog, tprog=tprog, J=J, r=r, plan=plan, tplan=tplan,
                tJ=tJ, tr=torch.tensor(np.asarray(r)), u0=u0, theta=theta)


def _system(dtype, seed):
    rng = np.random.default_rng(seed)
    N, K, f = 120, 6, 3
    adj = np.sort(rng.integers(0, N, size=(N, K)), axis=1).astype(np.int32)
    adj[:, 0] = np.arange(N)
    blocks = (rng.normal(size=(N, K, f, f)) * 0.1).astype(dtype)
    blocks[:, 0] += 2.0 * np.eye(f, dtype=dtype)
    jell = JBlockELL.from_blocks(jnp.asarray(adj), jnp.asarray(blocks),
                                 jnp.zeros(N, jnp.int32))
    tell = blockell_from_numpy(adj, np.asarray(jell.flat), np.zeros(N))
    b = rng.normal(size=(N, f)).astype(dtype)
    return jell, tell, b


@pytest.mark.parametrize("dtype,tol,xtol", [(np.float64, 1e-12, 1e-10),
                                            (np.float32, 1e-6, 1e-5)])
def test_gmres_matches_reference(dtype, tol, xtol):
    jell, tell, b = _system(dtype, 21)
    jres = jgmres(jell.matvec, jnp.asarray(b), tol=tol, restart=8,
                  maxiter=200)
    tres = tgmres(tell.matvec, torch.as_tensor(b), tol=tol, restart=8,
                  maxiter=200)
    assert bool(jres.converged) and tres.converged
    assert tres.iters == int(jres.iters)
    assert tres.x.dtype == torch.float32 if dtype == np.float32 else True
    assert rel_l2(tres.x.numpy(), np.asarray(jres.x)) <= xtol


def test_slab_prepare_matches_reference(pore):
    jprep = jslab.slab_prepare(pore["J"], pore["plan"])
    tprep = tslab.slab_prepare(pore["tJ"], pore["tplan"])
    assert rel_l2(tprep.Dinv0.numpy(), np.asarray(jprep.Dinv0)) <= 1e-13
    assert rel_l2(tprep.ell_eq.flat.numpy(),
                  np.asarray(jprep.ell_eq.flat)) <= 1e-13
    assert tprep.factors.Dinv.dtype == torch.float32
    # the f32 bands of f64 matrices that agree to 1e-13
    assert rel_l2(tprep.factors.Al.numpy(),
                  np.asarray(jprep.factors.Al)) <= 1e-7
    lo, di, up = (b.numpy() for b in pore["tplan"].bands(
        tprep.ell_eq, dtype=torch.float64))
    eye = np.eye(di.shape[1])

    def slab_residuals(Dinv, Cp):
        out = []
        for s in range(len(di)):
            denom = di[s] - (lo[s] @ Cp[s - 1] if s else 0.0)
            out.append(np.linalg.norm(denom @ Dinv[s] - eye))
            assert rel_l2(Cp[s], Dinv[s] @ up[s]) <= 1e-5
        return np.asarray(out)

    got = slab_residuals(*(a.double().numpy() for a in tprep.factors[:2]))
    ref = slab_residuals(*(np.asarray(a, np.float64)
                           for a in jprep.factors[:2]))
    assert np.all(got <= 2.0 * ref + 1e-6), (got, ref)


def test_slab_apply_matches_dense_and_reference(pore):
    J, r, tJ, tr = pore["J"], pore["r"], pore["tJ"], pore["tr"]
    jprep = jslab.slab_prepare(J, pore["plan"])
    jx = np.asarray(jslab.slab_apply(jprep, r, pore["plan"], tol=1e-12,
                                     max_refine=60).x)
    tprep = tslab.slab_prepare(tJ, pore["tplan"])
    tres = tslab.slab_apply(tprep, tr, pore["tplan"], tol=1e-12,
                            max_refine=60)
    assert tres.converged
    x_dense = tdense(tJ, tr).numpy()
    assert rel_l2(x_dense, np.asarray(jdense(J, r))) <= 1e-8
    assert rel_l2(tres.x.numpy(), x_dense) <= 1e-8
    assert rel_l2(tres.x.numpy(), jx) <= 1e-8


def _chord_solves(J, r, plan, tplan):
    """slab_apply_f32 in both packages on the reference's own
    factorization (fed through interop): only the f32 GMRES and the matvec
    differ."""
    jprep = jslab.slab_prepare(J, plan)
    jres = jslab.slab_apply_f32(jprep, r, plan, tol=1e-6)
    tprep = slab_prepared_from_numpy(
        *(np.asarray(a) for a in (jprep.ell_eq.adj, jprep.ell_eq.flat,
                                  jprep.ell_eq.diag_slot, jprep.Dinv0,
                                  jprep.factors.Dinv, jprep.factors.Cp,
                                  jprep.factors.Al)))
    tres = tslab.slab_apply_f32(tprep, torch.tensor(np.asarray(r)), tplan,
                                tol=1e-6)
    assert tres.x.dtype == torch.float64
    assert tres.converged == bool(jres.converged)
    assert tres.iters == int(jres.iters)
    return tres.x.numpy(), np.asarray(jres.x)


def test_slab_apply_f32_matches_reference(pore):
    # well conditioned: the pore sparsity with diagonally dominant blocks
    rng = np.random.default_rng(17)
    J = pore["J"]
    N, K, f, _ = J.shape4
    blocks = rng.normal(size=(N, K, f, f)) * 0.02
    blocks[np.arange(N), np.asarray(J.diag_slot)] += np.eye(f)
    Jw = JBlockELL.from_blocks(J.adj, jnp.asarray(blocks), J.diag_slot)
    rw = jnp.asarray(rng.normal(size=(N, f)))
    x_t, x_j = _chord_solves(Jw, rw, pore["plan"], pore["tplan"])
    assert rel_l2(x_t, x_j) <= 1e-5
    # the pore's cold-start Jacobian
    x_t, x_j = _chord_solves(J, pore["r"], pore["plan"], pore["tplan"])
    x_ref = tdense(pore["tJ"], pore["tr"]).numpy()
    assert rel_l2(x_t, x_ref) <= 1e-3


def test_newton_step_matches_reference_and_dense(pore):
    """One implicit step: slab_direct Newton takes the reference's
    iterations, and its state agrees with the dense-direct Newton step
    per field (the analog of test_newton_step_slab_vs_dense_1e8)."""
    jprog, tprog = pore["jprog"], pore["tprog"]
    cfg = jprog.config
    lin = dict(kind="slab_direct", tol=1e-12, max_refine=60)
    js = jax.jit(jstep(jprog.space, jprog.form, cfg.newton, JLin(**lin),
                       bc_of_theta=jprog._bc_of_theta))
    ju, jst = js(pore["u0"], pore["theta"])
    tu0 = tprog.initial_state()
    tth = tprog._theta_of_carry((tu0, 0.0), 0)
    tu, tst = tstep(tprog.space, tprog.form, cfg.newton, TLin(**lin),
                    bc_of_theta=tprog._bc_of_theta)(tu0, tth)
    td, tdst = tstep(tprog.space, tprog.form, cfg.newton, TLin(kind="dense"),
                     bc_of_theta=tprog._bc_of_theta)(tu0, tth)
    assert tst.converged and tdst.converged
    assert tst.newton_iters == int(jst.newton_iters)
    a, b, c = tu.numpy(), td.numpy(), np.asarray(ju)
    for f in range(cfg.n_fields):
        assert rel_l2(a[:, f], b[:, f]) <= 1e-8, f
        assert rel_l2(a[:, f], c[:, f]) <= 1e-8, f


@pytest.mark.parametrize("opts", [
    {},
    {"carry_residual": False},
    {"backtracking": 2},
    {"backtracking": 2, "bt_growth": 4.0},
    {"stall_atol": 1e-3, "atol": 1e-300, "rtol": 1e-300, "max_iter": 12},
    {"du_max": 0.05},
], ids=["default", "no_carry", "armijo", "growth", "stall", "du_max"])
def test_newton_solve_options_match_reference(opts):
    """newton_solve's options on a small nonlinear system (a coupled
    elementwise cubic, dense direct steps): the same iteration count,
    convergence flag and solution as the reference."""
    from gmpnp_tpu.solve.newton import newton_solve as jnewton
    from gmpnp_tpu_torch.solve.newton import newton_solve as tnewton

    rng = np.random.default_rng(3)
    n = 12
    A = np.eye(n) * 3.0 + 0.2 * rng.normal(size=(n, n))
    c = rng.normal(size=n)
    kw = dict(rtol=1e-10, atol=1e-12, relaxation=0.9)
    kw.update(opts)

    def jres(u):
        return A @ u + u ** 3 - c

    def jlin(u, r):
        return jnp.linalg.solve(A + 3.0 * jnp.diag(u ** 2), r), 0

    At, ct = torch.tensor(A), torch.tensor(c)

    def tres(u):
        return At @ u + u ** 3 - ct

    def tlin(u, r):
        return torch.linalg.solve(At + 3.0 * torch.diag(u ** 2), r), 0

    u0 = 2.0 + rng.normal(size=n)
    jr = jnewton(jres, jlin, jnp.asarray(u0), **kw)
    tr = tnewton(tres, tlin, torch.tensor(u0), **kw)
    assert tr.iterations == int(jr.iterations)
    assert tr.converged == bool(jr.converged)
    assert rel_l2(tr.u.numpy(), np.asarray(jr.u)) <= 1e-12


def test_carried_step_from_reference_carry(pore):
    """One carried-mode step of the port, started from the reference's own
    ChordCarry (factorization and increment carried over through interop),
    takes the reference's Newton iterations and lands within the f32-chord
    band of its state."""
    from gmpnp_tpu.solve.timeloop import make_carried_step as jcarried
    from gmpnp_tpu_torch.interop import chord_carry_from_numpy
    from gmpnp_tpu_torch.solve.timeloop import make_carried_step as tcarried

    jprog, tprog = pore["jprog"], pore["tprog"]
    cfg = jprog.config
    lin = dict(kind="slab_direct", tol=1e-6, refresh="carried")
    jstep_c, jinit = jcarried(jprog.space, jprog.form, cfg.newton,
                              JLin(**lin), bc_of_theta=jprog._bc_of_theta)
    u0, theta = pore["u0"], pore["theta"]
    jcarry = jax.jit(jinit)(u0, theta)
    ju, jst, _ = jax.jit(jstep_c)(u0, theta, jcarry)

    p = jcarry.prep
    tprep = slab_prepared_from_numpy(
        *(np.asarray(a) for a in (p.ell_eq.adj, p.ell_eq.flat,
                                  p.ell_eq.diag_slot, p.Dinv0,
                                  p.factors.Dinv, p.factors.Cp,
                                  p.factors.Al)))
    tcarry = chord_carry_from_numpy(tprep, np.asarray(jcarry.du),
                                    np.asarray(jcarry.dt_prev),
                                    np.asarray(jcarry.du_nrm_prev))
    tstep_c, _ = tcarried(tprog.space, tprog.form, cfg.newton, TLin(**lin),
                          bc_of_theta=tprog._bc_of_theta)
    tu0 = tprog.initial_state()
    tu, tst, tcarry2 = tstep_c(tu0, tprog._theta_of_carry((tu0, 0.0), 0),
                               tcarry)
    assert tst.converged and bool(jst.converged)
    assert tst.newton_iters == int(jst.newton_iters)
    assert rel_l2(tu.numpy(), np.asarray(ju)) <= 1e-6
    assert tcarry2.du_nrm_prev == float(np.linalg.norm(np.asarray(jcarry.du)))
