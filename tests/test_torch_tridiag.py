"""Port vs reference: the 1D block-tridiagonal solvers — band extraction,
block Thomas, block cyclic reduction (fused, and factor + apply),
``tridiag_mp_solve`` and the 1D linear kinds of the time loop.

Tolerances, each with its reason:
- band extraction: exact (the same gather of the same values);
- f64 Thomas / CR / factor + apply on random diagonally dominant systems:
  1e-12 relative L2 (the same algebra; only the order of the small matmuls'
  sums differs);
- f32 factor + apply: 1e-5 relative L2 (f32 rounding, cond ~ 2);
- ``tridiag_mp_solve`` on the real EDL Jacobian of tests/test_solve.py's
  dense-oracle test (L_n = 1 um, N = 1,091, 1-norm condition 3.6e9,
  printed) at tol 5e-13: the same GMRES iterations, and x within 1e-9.
  Both packages take 9 iterations for every tol from 2e-13 to 1.6e-12;
  5e-13 sits in the middle of that plateau.  At this condition the f64
  direct solves themselves disagree by ~1e-10 (the all-f64 CR against a
  pivoted sparse LU, printed), and each package lands ~2e-10 from the LU
  solve, so the bar sits above that floor.  At the reference test's tol
  1e-10 the packages stop after 5-7 iterations, depending on how the f32
  CR preconditioner rounds (torch and XLA, jitted or not, order the f32
  sums of the small matmuls differently), all converged, and land 1e-8 to
  1e-5 from the LU solve; the test prints iterations, final residuals
  and distances and asserts no bar on them (ROADMAP queue 3 item 1);
- one Newton step of the EDL model through each 1D kind: the same Newton
  iterations; states within 1e-8 (Thomas, the f64 CR oracle) and 1e-6
  (mixed precision, GMRES to 1e-8 on a system of condition 3.6e9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.fem.assembly import BlockELL as JBlockELL  # noqa: E402
from gmpnp_tpu.solve import linear as jlin  # noqa: E402
from gmpnp_tpu_torch.interop import (  # noqa: E402
    blockell_from_numpy,
    cr_factors_from_numpy,
)
from gmpnp_tpu_torch.models import edl_1d as tedl  # noqa: E402
from gmpnp_tpu_torch.solve import linear as tlin  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import LinearConfig as TLin  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import make_implicit_step  # noqa: E402
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

CASES = [(N, f) for N in (1, 2, 23, 64) for f in (3, 5, 7)]


def _chain_system(N, f, seed, dtype=np.float64):
    """A random diagonally dominant block-tridiagonal system stored as the
    BlockELL of a 1D chain mesh (sorted neighbors, padded with the row
    vertex), with its bands and a right-hand side."""
    rng = np.random.default_rng(seed)
    lower = rng.normal(size=(N, f, f)) * 0.2
    upper = rng.normal(size=(N, f, f)) * 0.2
    diag = rng.normal(size=(N, f, f)) * 0.2 + 3.0 * np.eye(f)
    lower[0] = 0.0
    upper[-1] = 0.0
    rhs = rng.normal(size=(N, f))
    K = min(3, N)
    adj = np.zeros((N, K), np.int32)
    blocks = np.zeros((N, K, f, f))
    diag_slot = np.zeros(N, np.int32)
    for n in range(N):
        nbrs = [m for m in (n - 1, n, n + 1) if 0 <= m < N]
        nbrs += [n] * (K - len(nbrs))
        adj[n] = nbrs
        diag_slot[n] = nbrs.index(n)
        band = {n - 1: lower[n], n: diag[n], n + 1: upper[n]}
        for k, m in enumerate(nbrs):
            if k == nbrs.index(m):    # padded slots keep zero blocks
                blocks[n, k] = band[m]
    flat = np.asarray(JBlockELL.from_blocks(
        jnp.asarray(adj), jnp.asarray(blocks), jnp.asarray(diag_slot)).flat)
    bands = [a.astype(dtype) for a in (lower, diag, upper, rhs)]
    return (adj, flat, diag_slot), bands


@pytest.fixture(scope="module")
def jax_thomas():
    """The reference's block-Thomas solve, jitted once per shape (its
    cyclic reductions take 3-11 s of XLA compile per shape on the CPU, so
    the grid is held to the reference's exact oracle and one shape below
    to the reference's own CR)."""
    return jax.jit(jlin.block_tridiag_solve_thomas)


@pytest.mark.parametrize("N,f", CASES)
def test_solvers_match_reference(N, f, jax_thomas):
    (adj, flat, slot), (lo, di, up, rhs) = _chain_system(N, f, 10 * N + f)
    jell = JBlockELL(jnp.asarray(adj), jnp.asarray(flat), jnp.asarray(slot))
    tell = blockell_from_numpy(adj, flat, slot)
    for got, ref, band in zip(tlin.block_tridiag_from_ell(tell),
                              jlin.block_tridiag_from_ell(jell),
                              (lo, di, up)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), band)

    x_ref = np.asarray(jax_thomas(*(jnp.asarray(a)
                                    for a in (lo, di, up, rhs))))
    T = [torch.tensor(a) for a in (lo, di, up, rhs)]
    got = {
        "thomas": tlin.block_tridiag_solve_thomas(*T),
        "cr": tlin.block_tridiag_solve_cr(*T),
        "factor_apply": tlin.block_tridiag_apply_cr(
            tlin.block_tridiag_factor_cr(*T[:3]), T[3]),
    }
    for name, x in got.items():
        assert x.dtype == torch.float64, name
        assert rel_l2(x.numpy(), x_ref) <= 1e-12, name

    # an f32 factorization of the same system (rounded to f32)
    T32 = [t.to(torch.float32) for t in T]
    fac32 = tlin.block_tridiag_factor_cr(*T32[:3])
    assert all(a.dtype == torch.float32 for lev in fac32.levels for a in lev)
    x32 = tlin.block_tridiag_apply_cr(fac32, T32[3])
    assert x32.dtype == torch.float32
    assert rel_l2(x32.numpy(), x_ref) <= 1e-5


def test_cr_matches_reference_cr():
    """N = 23 (padded to 32 with identity rows), f = 3: the port's fused
    CR and factor + apply against the reference's factor + apply, in f64
    and f32, and the reference's f32 factors through interop."""
    _, bands = _chain_system(23, 3, 7)
    J = [jnp.asarray(a) for a in bands]
    T = [torch.tensor(a) for a in bands]

    @jax.jit
    def ref(lo, di, up, rhs):
        fac32 = jlin.block_tridiag_factor_cr(
            *(b.astype(jnp.float32) for b in (lo, di, up)))
        return (jlin.block_tridiag_apply_cr(
                    jlin.block_tridiag_factor_cr(lo, di, up), rhs),
                fac32,
                jlin.block_tridiag_apply_cr(fac32, rhs.astype(jnp.float32)))

    x_fa, jfac32, x32 = ref(*J)
    assert rel_l2(tlin.block_tridiag_solve_cr(*T).numpy(),
                  np.asarray(x_fa)) <= 1e-12
    assert rel_l2(tlin.block_tridiag_apply_cr(
        tlin.block_tridiag_factor_cr(*T[:3]), T[3]).numpy(),
        np.asarray(x_fa)) <= 1e-12
    T32 = [t.to(torch.float32) for t in T]
    tfac32 = tlin.block_tridiag_factor_cr(*T32[:3])
    assert len(tfac32.levels) == len(jfac32.levels) == 5
    assert rel_l2(tlin.block_tridiag_apply_cr(tfac32, T32[3]).numpy(),
                  np.asarray(x32)) <= 1e-5
    via = cr_factors_from_numpy(
        [tuple(np.asarray(a) for a in lev) for lev in jfac32.levels],
        np.asarray(jfac32.Binv_top))
    assert via.Binv_top.dtype == torch.float32
    assert rel_l2(tlin.block_tridiag_apply_cr(via, T32[3]).numpy(),
                  np.asarray(x32)) <= 1e-6


@pytest.fixture(scope="module")
def edl_system():
    """The BC-applied EDL Jacobian and residual of tests/test_solve.py's
    ``test_tridiag_mp_solve_vs_dense_edl_jacobian`` (the cold start at L_n =
    1 um, N = 1,091, f = 7, proton-current fraction 0.001; assembled by the
    port, whose EDL Jacobian tests/test_torch_1d.py holds to the reference
    at 1e-12), on both sides, with a sparse LU of the matrix (scipy's
    SuperLU, partial pivoting) as the direct f64 oracle."""
    from scipy.sparse.linalg import splu

    prog = tedl.build(tedl.EDL1DConfig(L_n=1.0e-6, dry_run=True),
                      device="cpu")
    u0 = prog.initial_state()
    u = prog.bc.project(u0)
    theta = prog._theta_of_carry((u, 0.001), 0)
    tell = prog.bc.apply_to_jacobian(
        prog.space.jacobian(prog.form, u, u0, theta))
    tr = prog.bc.apply_to_residual(
        prog.space.residual(prog.form, u, u0, theta), u)
    jell = JBlockELL(*(jnp.asarray(a.numpy())
                       for a in (tell.adj, tell.flat, tell.diag_slot)))
    A = _sparse(tell)
    lu = splu(A)
    return dict(jell=jell, jr=jnp.asarray(tr.numpy()), tell=tell, tr=tr,
                A=A, lu=lu,
                x_exact=lu.solve(tr.numpy().ravel()).reshape(tr.shape))


def _sparse(ell):
    """A BlockELL matrix as a scipy CSC matrix (padded slots add zeros)."""
    import scipy.sparse as sps

    N, K, f, _ = ell.shape4
    b = ell.blocks4().numpy()                          # (N, K, f, f)
    rows = (np.arange(N)[:, None, None, None] * f
            + np.arange(f)[None, None, :, None])
    cols = (ell.adj.numpy().astype(np.int64)[:, :, None, None] * f
            + np.arange(f)[None, None, None, :])
    return sps.csc_matrix((b.ravel(), (np.broadcast_to(rows, b.shape).ravel(),
                                       np.broadcast_to(cols, b.shape).ravel())),
                          shape=(N * f, N * f))


def _cond1_estimate(A, lu):
    """The 1-norm condition number: ||A||_1 times scipy's estimate of
    ||A^-1||_1 through the LU."""
    from scipy.sparse.linalg import LinearOperator, onenormest

    inv = LinearOperator(A.shape, matvec=lu.solve,
                         rmatvec=lambda v: lu.solve(v, trans="T"))
    return abs(A).sum(axis=0).max() * onenormest(inv)


def test_tridiag_mp_solve_matches_reference(edl_system):
    """At tol 5e-13 the same GMRES iterations and x within 1e-9.  Printed
    for the edges of the plateau around it and for the reference test's
    tol 1e-10 (tests/test_solve.py): iterations, final residuals and
    distances to the LU solve, with the Jacobian's condition number and
    the all-f64 CR solve's distance to the LU solve."""
    jmp = jax.jit(lambda ell, r, tol: jlin.tridiag_mp_solve(
        ell, r, tol=tol, max_refine=40))
    x_exact = edl_system["x_exact"]
    x_cr = tlin.block_tridiag_solve_cr(
        *tlin.block_tridiag_from_ell(edl_system["tell"]),
        edl_system["tr"]).numpy()
    cond = _cond1_estimate(edl_system["A"], edl_system["lu"])
    print(f"EDL cold-start Jacobian, N*f = {x_exact.size}: 1-norm "
          f"condition number {cond:.3e}; the all-f64 CR solve lies "
          f"{rel_l2(x_cr, x_exact):.3e} from the LU solve")
    out = {}
    for tol in (2e-13, 5e-13, 1.6e-12, 1e-10):
        jres = jmp(edl_system["jell"], edl_system["jr"], tol)
        tres = tlin.tridiag_mp_solve(edl_system["tell"], edl_system["tr"],
                                     tol=tol, max_refine=40)
        assert bool(jres.converged) and tres.converged
        x_t, x_j = tres.x.numpy(), np.asarray(jres.x)
        print(f"tol {tol}: GMRES iterations port {tres.iters} reference "
              f"{int(jres.iters)}; final residual port {tres.resnorm:.3e} "
              f"reference {float(jres.resnorm):.3e}; port vs reference "
              f"{rel_l2(x_t, x_j):.3e}; vs the LU solve: port "
              f"{rel_l2(x_t, x_exact):.3e}, reference "
              f"{rel_l2(x_j, x_exact):.3e}")
        out[tol] = (tres, jres)
    tres, jres = out[5e-13]
    assert tres.x.dtype == torch.float64
    assert tres.iters == int(jres.iters)
    assert rel_l2(tres.x.numpy(), np.asarray(jres.x)) <= 1e-9


@pytest.mark.parametrize("kind,solve_dtype,tol", [
    ("tridiag_thomas", "f64", 1e-8), ("tridiag_cr", "f32", 1e-6)])
def test_edl_newton_step_through_each_1d_kind(kind, solve_dtype, tol):
    """One cold-start EDL step with each 1D kind against the default
    all-f64 CR: the same Newton iterations and states."""
    prog = tedl.build(tedl.EDL1DConfig(L_n=1.0e-6, dry_run=True),
                      device="cpu")
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    out = {}
    for lin in (TLin(), TLin(kind=kind, solve_dtype=solve_dtype)):
        step = make_implicit_step(prog.space, prog.form, prog.config.newton,
                                  lin, bc_of_theta=lambda th: prog.bc)
        u, st = step(u0, theta)
        assert st.converged
        out[lin.kind, lin.solve_dtype] = (st.newton_iters, u.numpy(),
                                          st.linear_iters)
    (it_ref, u_ref, _), (it, u, lin_iters) = out.values()
    assert it == it_ref
    assert rel_l2(u, u_ref) <= tol
    assert (lin_iters > 0) == (solve_dtype == "f32")


def test_carried_step_rejects_other_kinds():
    from gmpnp_tpu_torch.solve.timeloop import make_carried_step

    prog = tedl.build(tedl.EDL1DConfig(L_n=1.0e-6), device="cpu")
    with pytest.raises(ValueError, match="direct kind"):
        make_carried_step(prog.space, prog.form, prog.config.newton,
                          dataclasses.replace(prog.config.linear,
                                              kind="tridiag_thomas",
                                              refresh="carried"),
                          bc_of_theta=lambda th: prog.bc)
