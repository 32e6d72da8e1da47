"""The lane axis of the port's batched sweeps, module by module: each lane
function against V calls of its single-lane counterpart on the same
seeded inputs.

Tolerances, each with its reason:
- the block-ELL plain twin, ``block_inv``, the Dirichlet blends, the
  assembly and the Newton loop over lanes: exactly equal to the
  single-lane calls (the same operations, lane by lane);
- the 1D CR solve, factor and apply over lanes: 1e-13 relative (a lane's
  small products are batched with the other lanes' and may round
  otherwise);
- GMRES over lanes: x within 1e-12 relative and the same iteration count
  per lane (CGS2 as batched products);
- the slab factor and solve over lanes: the f32 banded solve within 1e-5
  relative of the single lane's (f32 products batched otherwise), and the
  f64 GMRES solutions within 1e-9 relative (the linear tolerance 1e-12 on
  a system of condition ~1e3); the slab's cyclic reduction over lanes:
  factors and solve exactly equal (its level products are batched as the
  single lane's are, its root products taken lane by lane);
- the 1D block-Thomas solve over lanes: 1e-12 relative (its small
  products batched); ``tridiag_mp_solve`` over lanes: 1e-13 relative and
  the same GMRES count per lane;
- the preconditioners over lanes (block-Jacobi, multicolor SSOR, AMG: the
  Galerkin levels, the V-cycle) and BiCGStab, GMRES and the dense solve
  over lanes: exactly equal per lane, iteration counts included (each lane
  takes its single-lane arithmetic; the Krylov reductions lane by lane),
  but for the batched dense LU (1e-12 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch import sync  # noqa: E402
from gmpnp_tpu_torch.fem.assembly import BlockELL  # noqa: E402
from gmpnp_tpu_torch.fem.dirichlet import DirichletBC  # noqa: E402
from gmpnp_tpu_torch.models import edl_1d, pore_3d  # noqa: E402
from gmpnp_tpu_torch.ops.ell_spmv import (  # noqa: E402
    ell_spmv,
    ell_spmv_reference,
    lane_aligned,
    lane_copy_paths,
)
from gmpnp_tpu_torch.solve import linear, slab  # noqa: E402
from gmpnp_tpu_torch.solve.newton import (  # noqa: E402
    newton_solve,
    newton_solve_lanes,
)
from gmpnp_tpu_torch.solve.smallblock import RANGE_LIM, block_inv  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import (  # noqa: E402
    lane_theta,
    stack_lane_theta,
)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("V,N,K,f", [(3, 61, 15, 9), (2, 37, 3, 7),
                                     (3, 5, 7, 3)])
def test_lane_twin_equals_single_lane_calls(V, N, K, f, dtype):
    rng = np.random.default_rng(11)
    adj = torch.as_tensor(rng.integers(0, N, size=(N, K)).astype(np.int32))
    flat = torch.as_tensor(rng.normal(size=(V, N, f, K * f)), dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(V, N, f)), dtype=dtype)
    want = torch.stack([ell_spmv_reference(flat[v], adj, x[v])
                        for v in range(V)])
    assert torch.equal(ell_spmv_reference(flat, adj, x), want)
    # the wrapper's CPU route and the lane-aligned layout (padded lane
    # stride, each lane on a 16-byte boundary) give the same values
    aligned = lane_aligned(flat)
    assert torch.equal(aligned, flat)
    assert aligned.stride(0) * dtype.itemsize % 16 == 0
    assert set(lane_copy_paths(aligned)) == {"bulk"}
    assert torch.equal(ell_spmv(aligned, adj, x), want)
    with pytest.raises(ValueError, match="shape"):
        ell_spmv(flat, adj, x[:, :-1])


def test_lane_copy_paths_name_misaligned_lanes():
    """(2,501, 15, 9) in f32: a lane is 2,501 block rows of 4,860 bytes,
    no multiple of 16, so lanes 1 and 2 of a contiguous (3, N, f, K*f)
    tensor miss a 16-byte boundary; ``lane_aligned`` pads the stride."""
    flat = torch.zeros((3, 2501, 9, 135), dtype=torch.float32)
    assert lane_copy_paths(flat) == ["bulk", "element", "element"]
    assert lane_copy_paths(lane_aligned(flat)) == ["bulk"] * 3


def test_block_inv_over_lanes_keeps_guards_per_lane():
    """block_inv flattens any leading dims: a lane axis inverts every
    lane's blocks as the lane alone would, with the pivot floor (a zero
    block) and the RANGE_LIM clamp (a block of 1e20 entries) per lane."""
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(size=(3, 6, 7, 7)))
    A[1, 2] = 0.0
    A[2, 4] = 1e20 * torch.as_tensor(rng.normal(size=(7, 7)))
    got = block_inv(A)
    for v in range(3):
        assert torch.equal(got[v], block_inv(A[v]))
    assert float(got.abs().max()) <= RANGE_LIM


def _tridiag_lanes(V, N, f, seed=7):
    rng = np.random.default_rng(seed)
    lo = torch.as_tensor(rng.normal(size=(V, N, f, f)) * 0.3)
    up = torch.as_tensor(rng.normal(size=(V, N, f, f)) * 0.3)
    di = torch.as_tensor(rng.normal(size=(V, N, f, f))
                         + 4.0 * np.eye(f)[None, None])
    lo[:, 0] = 0.0
    up[:, -1] = 0.0
    rhs = torch.as_tensor(rng.normal(size=(V, N, f)))
    return lo, di, up, rhs


def test_cr_over_lanes_matches_single_lanes():
    lo, di, up, rhs = _tridiag_lanes(3, 37, 7)
    x = linear.block_tridiag_solve_cr_lanes(lo, di, up, rhs)
    fac = linear.block_tridiag_factor_cr_lanes(lo, di, up)
    xa = linear.block_tridiag_apply_cr_lanes(fac, rhs)
    for v in range(3):
        want = linear.block_tridiag_solve_cr(lo[v], di[v], up[v], rhs[v])
        assert _rel(x[v], want) <= 1e-13
        fv = linear.block_tridiag_factor_cr(lo[v], di[v], up[v])
        assert _rel(xa[v], linear.block_tridiag_apply_cr(fv, rhs[v])) <= 1e-13


def test_tridiag_from_lane_ell_matches_single():
    rng = np.random.default_rng(2)
    V, N, f = 2, 9, 5
    adj = np.stack([np.clip(np.arange(N) + d, 0, N - 1)
                    for d in (-1, 0, 1)], 1).astype(np.int32)
    flat = torch.as_tensor(rng.normal(size=(V, N, f, 3 * f)))
    diag_slot = torch.as_tensor(np.where(np.arange(N) == 0, 0, 1))
    ell = BlockELL(torch.as_tensor(adj), flat, diag_slot)
    bands = linear.block_tridiag_from_ell_lanes(ell)
    for v in range(V):
        one = linear.block_tridiag_from_ell(
            BlockELL(ell.adj, flat[v], diag_slot))
        for a, b in zip(bands, one):
            assert torch.equal(a[v], b)


def test_gmres_over_lanes_matches_single_lanes():
    """Per-lane Arnoldi, rotations and stopping: each lane as ``gmres``
    alone (its own iteration count, a lane that hits maxiter unconverged,
    a lane left out by ``active``), with one host read per Arnoldi column
    for all lanes."""
    rng = np.random.default_rng(9)
    V, n = 4, 40
    A = torch.as_tensor(rng.normal(size=(V, n, n)) * 0.2
                        + np.eye(n)[None] * np.array([2, 3, 5, 1.1])[:, None,
                                                                       None])
    b = torch.as_tensor(rng.normal(size=(V, n)))
    Dinv = torch.linalg.inv(torch.diagonal(A, dim1=1, dim2=2)[..., None]
                            * torch.eye(n))
    mv = lambda x: torch.einsum("vij,vj->vi", A, x)
    pc = lambda x: torch.einsum("vij,vj->vi", Dinv, x)
    active = np.array([True, True, True, False])
    kw = dict(tol=1e-10, restart=6, maxiter=30)
    r0 = sync.READS
    res = linear.gmres_lanes(mv, b, Minv=pc, active=active, **kw)
    reads = sync.READS - r0
    for v in range(3):
        one = linear.gmres(lambda x: A[v] @ x, b[v],
                           Minv=lambda x: Dinv[v] @ x, **kw)
        assert res.iters[v] == one.iters
        assert res.converged[v] == one.converged
        assert _rel(res.x[v], one.x) <= 1e-12
    assert res.iters[3] == 0 and float(res.x[3].abs().max()) == 0.0
    # the bnorm read, then per cycle one beta, one column per Arnoldi
    # step and one true residual: the most-iterating lane's count
    cycles = -(-int(res.iters.max()) // kw["restart"])
    assert reads == 1 + int(res.iters.max()) + 2 * cycles


@pytest.fixture(scope="module")
def pore_lanes():
    """The (2, 8) pore's cold-start Jacobian and residual at -0.5 and
    -1.5 V (the sweep's arithmetic BC), as lanes."""
    prog = pore_3d.build(pore_3d.Pore3DConfig(mesh_resolution=(2, 8)),
                         device="cpu")
    u0 = prog.initial_state()
    ths = []
    for volt in (-0.5, -1.5):
        th = prog._theta_of_carry((u0, 0.0), 0)
        th["voltage"] = volt
        ths.append(th)
    theta = stack_lane_theta(ths, "cpu")
    bc = prog.bc.arith().set_value_arith(
        prog.s1_verts, prog.idx["CO2"], theta["co2_s1"])
    U = bc.project(u0.expand(2, *u0.shape))
    ell = bc.apply_to_jacobian(prog.space.jacobian_lanes(
        prog.form, U, U, theta))
    r = bc.apply_to_residual(prog.space.residual_lanes(
        prog.form, U, U, theta), U)
    return prog, bc, U, theta, ell, r


def test_assembly_and_bc_over_lanes_equal_single_lanes(pore_lanes):
    prog, bc, U, theta, ell, r = pore_lanes
    sp, form = prog.space, prog.form
    for v in range(2):
        th = lane_theta(theta, v)
        bcv = bc._replace(values=bc.values[v])
        want_r = bcv.apply_to_residual(sp.residual(form, U[v], U[v], th),
                                       U[v])
        assert torch.equal(r[v], want_r)
        want_J = bcv.apply_to_jacobian(sp.jacobian(form, U[v], U[v], th))
        assert torch.equal(ell.flat[v], want_J.flat)
        assert torch.equal(ell.diag_blocks()[v], want_J.diag_blocks())
        # a (V,) value blends one value per lane, as a scalar does alone
        one = prog.bc.arith().set_value_arith(
            prog.s1_verts, prog.idx["CO2"], th["co2_s1"])
        assert torch.equal(bc.values[v], one.values)
        assert torch.equal(bc.project(U)[v], one.project(U[v]))


def test_slab_over_lanes_matches_single_lanes(pore_lanes):
    prog, bc, U, theta, ell, r = pore_lanes
    plan = slab.SlabPlan.build(
        np.asarray(prog.space.adj), np.asarray(prog.space.points)[:, -1],
        prog.space.n_fields, np.asarray(prog.space.diag_slot))
    prep = slab.slab_prepare_lanes(ell, plan)
    res = slab.slab_apply_lanes(prep, r, plan, tol=1e-12, max_refine=40)
    d = plan.to_slabs_lanes(r.to(torch.float32))
    z = plan.from_slabs_lanes(slab.slab_solve_lanes(prep.factors, d))
    for v in range(2):
        one_ell = BlockELL(ell.adj, ell.flat[v], ell.diag_slot)
        p1 = slab.slab_prepare(one_ell, plan)
        assert torch.equal(prep.ell_eq.flat[v], p1.ell_eq.flat)
        z1 = plan.from_slabs(slab.slab_solve(
            p1.factors, plan.to_slabs(r[v].to(torch.float32))))
        assert _rel(z[v], z1) <= 1e-5
        one = slab.slab_apply(p1, r[v], plan, tol=1e-12, max_refine=40)
        assert res.converged[v] and one.converged
        assert _rel(res.x[v], one.x) <= 1e-9


def test_newton_over_lanes_matches_single_lanes():
    """Lanes that converge after different iteration counts, one that
    needs backtracking trials, one that stops at max_iter: each lane's
    iterate, counts and flags are those of ``newton_solve`` alone."""
    a = torch.tensor([2.0, 30.0, 1e-3, 700.0], dtype=torch.float64)

    def res_l(u):
        return u ** 3 - a[:, None]

    def lin_l(u, r, active):
        return r / (3.0 * u ** 2), np.ones(len(a), np.int64)

    for kw in (dict(), dict(backtracking=4, bt_growth=1.5),
               dict(backtracking=3), dict(stall_atol=1e-2, stall_iters=2)):
        u0 = torch.ones((4, 1), dtype=torch.float64)
        got = newton_solve_lanes(res_l, lin_l, u0, rtol=1e-12, atol=1e-12,
                                 max_iter=12, **kw)
        for v in range(4):
            one = newton_solve(lambda u: u ** 3 - a[v],
                               lambda u, r: (r / (3.0 * u ** 2), 1),
                               u0[v], rtol=1e-12, atol=1e-12, max_iter=12,
                               **kw)
            assert torch.equal(got.u[v], one.u)
            assert got.iterations[v] == one.iterations
            assert got.linear_iters[v] == one.linear_iters
            assert bool(got.converged[v]) == one.converged
            assert got.residual_norm[v] == one.residual_norm
        assert len(set(got.iterations.tolist())) > 1


def test_stack_lane_theta():
    ths = [{"dt": 0.5, "J": 1.0, "c": torch.tensor(2.0)},
           {"dt": 0.5, "J": 3.0, "c": torch.tensor(4.0)}]
    th = stack_lane_theta(ths, "cpu")
    assert th["dt"] == 0.5
    assert th["J"].tolist() == [1.0, 3.0] and th["c"].tolist() == [2.0, 4.0]
    assert lane_theta(th, 1) == {"dt": 0.5, "J": 3.0, "c": 4.0}


def test_lane_jacobian_rows_of_dirichlet_bc():
    rng = np.random.default_rng(3)
    N, f, K, V = 12, 4, 3, 2
    mask = torch.as_tensor(rng.random((N, f)) < 0.4)
    bc = DirichletBC(mask, torch.as_tensor(rng.normal(size=(N, f))))
    adj = torch.as_tensor(np.stack([np.arange(N)] * K, 1).astype(np.int32))
    ell = BlockELL(adj, torch.as_tensor(rng.normal(size=(V, N, f, K * f))),
                   torch.as_tensor(rng.integers(0, K, size=N)))
    got = bc.apply_to_jacobian(ell).flat
    for v in range(V):
        one = bc.apply_to_jacobian(BlockELL(adj, ell.flat[v],
                                            ell.diag_slot)).flat
        assert torch.equal(got[v], one)


def test_edl_lane_theta_per_lane_fluxes():
    """Per-lane tensors in theta (the EDL's proton-current controller gives
    each lane its own fluxes) reach the form lane by lane."""
    prog = edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6), device="cpu")
    u0 = prog.initial_state()
    ths = [prog._theta_of_carry((u0, chf), 0) for chf in (0.0, 0.3)]
    theta = stack_lane_theta(ths, "cpu")
    assert isinstance(theta["J_H"], torch.Tensor)
    U = u0.expand(2, *u0.shape)
    r = prog.space.residual_lanes(prog.form, U, U, theta)
    J = prog.space.jacobian_lanes(prog.form, U, U, theta).flat
    for v in range(2):
        assert torch.equal(r[v], prog.space.residual(prog.form, u0, u0,
                                                     ths[v]))
        assert torch.equal(J[v], prog.space.jacobian(prog.form, u0, u0,
                                                     ths[v]).flat)
    assert not torch.equal(r[0], r[1])


def test_thomas_over_lanes_matches_single_lanes():
    lo, di, up, rhs = _tridiag_lanes(3, 37, 7)
    x = linear.block_tridiag_solve_thomas_lanes(lo, di, up, rhs)
    for v in range(3):
        want = linear.block_tridiag_solve_thomas(lo[v], di[v], up[v], rhs[v])
        assert _rel(x[v], want) <= 1e-12


def test_tridiag_mp_solve_over_lanes_matches_single_lanes():
    """Three EDL lanes at three voltages (the sweep's Dirichlet blend) at
    the cold start: each lane's f32 CR preconditioned GMRES as the lane
    alone, its iteration count included; a lane left out by ``active``
    takes no iteration."""
    prog = edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6), device="cpu")
    left = np.unique(prog.mesh.facets[prog.mesh.facet_markers
                                      == 1].reshape(-1))
    u0 = prog.initial_state()
    ths = []
    for volt in (-0.5, -1.0, -2.0):
        th = prog._theta_of_carry((u0, 0.0), 0)
        th["voltage"] = volt
        ths.append(th)
    theta = stack_lane_theta(ths, "cpu")
    bc = prog.bc.arith().set_value_arith(left, edl_1d.P, theta["voltage"])
    U = bc.project(u0.expand(3, *u0.shape))
    Up = u0.expand(3, *u0.shape)
    ell = bc.apply_to_jacobian(prog.space.jacobian_lanes(prog.form, U, Up,
                                                         theta))
    r = bc.apply_to_residual(prog.space.residual_lanes(prog.form, U, Up,
                                                       theta), U)
    active = np.array([True, False, True])
    res = linear.tridiag_mp_solve_lanes(ell, r, tol=1e-10, active=active)
    assert res.iters[1] == 0 and float(res.x[1].abs().max()) == 0.0
    for v in (0, 2):
        one = linear.tridiag_mp_solve(BlockELL(ell.adj, ell.flat[v],
                                               ell.diag_slot), r[v],
                                      tol=1e-10)
        assert res.iters[v] == one.iters > 0
        assert res.converged[v] and one.converged
        assert _rel(res.x[v], one.x) <= 1e-13


def _pc_pairs(prog, ell):
    """(name, lane preconditioner, single-lane preconditioners)."""
    from gmpnp_tpu_torch.solve import amg

    one = [BlockELL(ell.adj, ell.flat[v], ell.diag_slot)
           for v in range(ell.lanes)]
    colors = prog.space.colors
    plan = amg.AMGPlan.build(np.asarray(prog.space.adj), prog.space.n_fields)
    return one, [
        ("block_jacobi", linear.block_jacobi_preconditioner_lanes(ell),
         [linear.block_jacobi_preconditioner(o) for o in one]),
        ("ssor", linear.multicolor_ssor_preconditioner_lanes(ell, colors,
                                                             sweeps=2),
         [linear.multicolor_ssor_preconditioner(o, colors, sweeps=2)
          for o in one]),
        ("amg", amg.amg_preconditioner_lanes(ell, plan),
         [amg.amg_preconditioner(o, plan) for o in one]),
    ]


def test_preconditioners_and_krylov_over_lanes_match_single_lanes(
        pore_lanes):
    """Each preconditioner's apply, and GMRES and BiCGStab under it, over
    two pore lanes: exactly each lane's single-lane result, iteration
    counts included; BiCGStab reads one (V,) predicate per iteration."""
    prog, bc, U, theta, ell, r = pore_lanes
    one, pcs = _pc_pairs(prog, ell)
    for name, pl, ps in pcs:
        z = pl(r)
        for v in range(2):
            assert torch.equal(z[v], ps[v](r[v])), name
        r0 = sync.READS
        bi = linear.bicgstab_lanes(ell.matvec, r, Minv=pl, tol=1e-8,
                                   maxiter=300)
        bi_reads = sync.READS - r0
        gm = linear.gmres_lanes(ell.matvec, r, Minv=pl, tol=1e-8,
                                maxiter=300)
        single_reads = []
        for v in range(2):
            for res, fn in ((bi, linear.bicgstab), (gm, linear.gmres)):
                r0 = sync.READS
                want = fn(one[v].matvec, r[v], Minv=ps[v], tol=1e-8,
                          maxiter=300)
                if fn is linear.bicgstab:
                    single_reads.append(sync.READS - r0)
                assert res.iters[v] == want.iters, (name, fn.__name__)
                assert res.converged[v] == want.converged
                assert torch.equal(res.x[v], want.x), (name, fn.__name__)
        # the reads of the lane that iterates longest alone
        assert bi_reads == single_reads[int(np.argmax(bi.iters))]


def test_bicgstab_over_lanes_freezes_stopped_lanes():
    """Lanes that stop after different iterations, at maxiter or not at
    all (``active``): each lane's x and count are its single-lane solve's
    (small dense systems, as ``gmres_lanes``' test)."""
    rng = np.random.default_rng(9)
    V, n = 4, 40
    A = torch.as_tensor(rng.normal(size=(V, n, n)) * 0.2
                        + np.eye(n)[None] * np.array([2, 3, 5, 1.1])[:, None,
                                                                       None])
    b = torch.as_tensor(rng.normal(size=(V, n)))
    mv = lambda x: torch.einsum("vij,vj->vi", A, x)
    active = np.array([True, True, True, False])
    res = linear.bicgstab_lanes(mv, b, tol=1e-10, maxiter=12, active=active)
    counts = []
    for v in range(3):
        one = linear.bicgstab(lambda x: A[v] @ x, b[v], tol=1e-10,
                              maxiter=12)
        counts.append(one.iters)
        assert res.iters[v] == one.iters
        assert res.converged[v] == one.converged
        assert _rel(res.x[v], one.x) <= 1e-12
    assert len(set(counts)) > 1 and max(counts) == 12
    assert res.iters[3] == 0 and float(res.x[3].abs().max()) == 0.0
    assert not res.converged[3]


def test_amg_levels_over_lanes_match_single_lanes(pore_lanes):
    """The Galerkin coarse operators, block-diagonal inverses and coarsest
    LU of every lane, from one plan and tables shared by the lanes."""
    from gmpnp_tpu_torch.solve import amg

    prog, bc, U, theta, ell, r = pore_lanes
    plan = amg.AMGPlan.build(np.asarray(prog.space.adj), prog.space.n_fields)
    vals = amg.amg_prepare_lanes(ell, plan)
    for v in range(2):
        one = amg.amg_prepare(BlockELL(ell.adj, ell.flat[v], ell.diag_slot),
                              plan)
        for lv, lo in zip(vals.levels, one.levels):
            assert torch.equal(lv.ell.flat[v], lo.ell.flat)
            assert torch.equal(lv.Dinv[v], lo.Dinv)
        assert torch.equal(vals.coarsest_lu[v][0], one.coarsest_lu[0])
        assert torch.equal(vals.coarsest_lu[v][1], one.coarsest_lu[1])


def test_slab_cr_over_lanes_matches_single_lanes(pore_lanes):
    prog, bc, U, theta, ell, r = pore_lanes
    plan = slab.SlabPlan.build(
        np.asarray(prog.space.adj), np.asarray(prog.space.points)[:, -1],
        prog.space.n_fields, np.asarray(prog.space.diag_slot))
    prep = slab.slab_prepare_lanes(ell, plan, mode="cr")
    res = slab.slab_apply_lanes(prep, r, plan, tol=1e-12, max_refine=40)
    d = plan.to_slabs_lanes(r.to(torch.float32))
    z = slab.slab_solve_cr_lanes(prep.factors, d)
    for v in range(2):
        p1 = slab.slab_prepare(BlockELL(ell.adj, ell.flat[v], ell.diag_slot),
                               plan, mode="cr")
        for lv, lo in zip(prep.factors.levels, p1.factors.levels):
            for a, b in zip(lv, lo):
                assert torch.equal(a[v], b)
        assert torch.equal(prep.factors.root_inv[v], p1.factors.root_inv)
        assert torch.equal(z[v], slab.slab_solve_cr(
            p1.factors, plan.to_slabs(r[v].to(torch.float32))))
        one = slab.slab_apply(p1, r[v], plan, tol=1e-12, max_refine=40)
        assert res.iters[v] == one.iters
        assert torch.equal(res.x[v], one.x)


def test_dense_over_lanes_matches_single_lanes(pore_lanes):
    prog, bc, U, theta, ell, r = pore_lanes
    x = linear.dense_solve_lanes(ell, r)
    dense = ell.to_dense()
    for v in range(2):
        one = BlockELL(ell.adj, ell.flat[v], ell.diag_slot)
        assert torch.equal(dense[v], one.to_dense())
        assert _rel(x[v], linear.dense_solve(one, r[v])) <= 1e-12
