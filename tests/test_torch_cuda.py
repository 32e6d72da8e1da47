"""The port on a CUDA card: each kernel against its plain version (the
block-ELL matvec, the sorted-segment sum, the batched block inverse, the
pore's element residuals and its Sechenov value, the 1D cyclic-reduction
apply (bitwise repeatable, each lane its single-lane bits), bitwise where the
kernel's rounding is the plain version's; a whole carried pore episode
through the Sechenov kernel bit for bit its plain version's), the 1D cyclic reduction on the card against the CPU, a
short transient on the card against the same transient on the CPU, and
the Krylov fallbacks: the AMG Galerkin product and the SSOR
preconditioner bitwise repeatable on the card, and the four Krylov solves
card against CPU.

These tests need a card and skip without one.  They import neither jax nor
gmpnp_tpu, so they run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: the kernel in f32 1e-5 and in f64 1e-12 relative L2 (another
summation order; the pore residual kernel per field, also FMA
contraction); the CR factor + apply in f64 1e-12 and in f32 1e-5
(another summation order in the small matmuls), the CR apply kernel
against its plain version 1e-13 / 1e-5 (the same); card vs CPU states 1e-6
relative L2 (the f32-chord band: the chord directions are f32 GMRES
solves); Krylov solves card vs CPU: the same converged flag, iterations
within 10% (another summation order in every dot product) and x within
1e-6 (f64) / 1e-3 (f32, tol 1e-5 on a system of condition ~1e3).  Two
launches on the same operands are bitwise equal (the kernel's order of
summation is fixed).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.ops import LAUNCHES, ell_spmv, ell_spmv_reference  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
# the pore's shapes for GMPNP (f=9) and reaction-diffusion (f=7), an edge
# shape, the 1D models' (L_n = 50 um) for the EDL (f=7) and
# reaction-diffusion (f=5) models, and the AMG coarse level of the
# L=50 nm, R=5 nm pore
@pytest.mark.parametrize("N,K,f", [(2501, 15, 9), (1000, 7, 3),
                                   (2501, 15, 7), (5991, 3, 7),
                                   (5991, 3, 5), (98, 15, 9)])
def test_kernel_matches_plain_version(cuda_device, N, K, f, dtype, tol):
    rng = np.random.default_rng(5)
    flat = rng.normal(size=(N, f, K * f)).astype(dtype)
    adj = rng.integers(0, N, size=(N, K)).astype(np.int32)
    x = rng.normal(size=(N, f)).astype(dtype)
    args = [torch.as_tensor(v, device=cuda_device) for v in (flat, adj, x)]
    n0 = LAUNCHES[args[0].dtype]
    y = ell_spmv(*args)
    torch.cuda.synchronize()
    assert LAUNCHES[args[0].dtype] == n0 + 1
    ref = ell_spmv_reference(*args)
    assert float((y - ref).norm() / ref.norm()) <= tol


def _operands(N, K, f, dtype, device, offset=0, seed=5):
    """Seeded operands on the card; ``offset`` shifts flat's pointer by that
    many elements, so the view is contiguous but not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    buf = torch.as_tensor(
        rng.normal(size=(N * f * K * f + offset,)).astype(dtype),
        device=device)
    flat = buf[offset:].view(N, f, K * f)
    adj = torch.as_tensor(rng.integers(0, N, size=(N, K)).astype(np.int32),
                          device=device)
    x = torch.as_tensor(rng.normal(size=(N, f)).astype(dtype), device=device)
    return flat, adj, x


# ragged last tiles (N not a multiple of the tile), one neighbour, widths
# on every kernel (f=9; f=5 and f=7 with a warp per vertex at K=15 and a
# thread per row at K=3, tiles of 4 and of 16-24 vertices; the run-time-f
# one), a tile over 48 KB of shared memory (K=31), each from an aligned
# and from a misaligned pointer
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N,K,f", [
    (1, 1, 1), (3, 1, 9), (4, 1, 8), (5, 1, 9), (5, 1, 1), (4, 1, 9),
    (53, 15, 8), (130, 31, 9), (2501, 15, 9)] + [
    (N, K, f) for N in (1, 3, 5, 53) for K in (3, 15) for f in (5, 7)])
def test_kernel_ragged_and_misaligned(cuda_device, N, K, f, offset, dtype,
                                      tol):
    flat, adj, x = _operands(N, K, f, dtype, cuda_device, offset)
    assert flat.is_contiguous()
    if offset:
        assert flat.data_ptr() % 16 != 0
    y = ell_spmv(flat, adj, x)
    again = ell_spmv(flat, adj, x)
    torch.cuda.synchronize()
    ref = ell_spmv_reference(flat, adj, x)
    assert float((y - ref).norm() / ref.norm()) <= tol
    assert torch.equal(y, again)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("N,K,f", [(2501, 15, 9), (2501, 15, 7),
                                   (2501, 15, 5), (5991, 3, 7),
                                   (5991, 3, 5)])
def test_kernel_on_a_side_stream(cuda_device, N, K, f, dtype, tol):
    flat, adj, x = _operands(N, K, f, dtype, cuda_device)
    y = ell_spmv(flat, adj, x)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        y_side = ell_spmv(flat, adj, x)
    side.synchronize()
    ref = ell_spmv_reference(flat, adj, x)
    assert torch.equal(y, y_side)
    assert float((y_side - ref).norm() / ref.norm()) <= tol


# the lane axis: the batched pore sweep's shape (3 lanes of the L=50 nm,
# R=5 nm pore, f=9), the reaction-diffusion pore's f=7, the 1D models' K=3,
# a ragged edge; each lane bitwise equal to a one-lane launch of its own
# matrix, from a contiguous (V, N, f, K*f) tensor (lanes 1.. miss the
# 16-byte boundary and take the element-sized copies) and from the
# lane-aligned layout (every lane bulk-copied).  Twin tolerances: 2.5e-7
# (f32) and 5e-16 (f64) relative L2 per lane, the kernel's other summation
# order on random data (measured <= 1.2e-7 / 2.5e-16 on the card)
@pytest.mark.parametrize("dtype,tol", [(np.float32, 2.5e-7),
                                       (np.float64, 5e-16)])
@pytest.mark.parametrize("V,N,K,f", [(3, 2501, 15, 9), (3, 2501, 15, 7),
                                     (2, 5991, 3, 7), (3, 53, 15, 8)])
def test_kernel_lanes_bitwise_per_lane(cuda_device, V, N, K, f, dtype, tol):
    from gmpnp_tpu_torch.ops import SHAPE_LAUNCHES
    from gmpnp_tpu_torch.ops.ell_spmv import lane_aligned, lane_copy_paths

    rng = np.random.default_rng(8)
    flat = torch.as_tensor(rng.normal(size=(V, N, f, K * f)).astype(dtype),
                           device=cuda_device)
    adj = torch.as_tensor(rng.integers(0, N, size=(N, K)).astype(np.int32),
                          device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(V, N, f)).astype(dtype),
                        device=cuda_device)
    single = torch.stack([ell_spmv(flat[v], adj, x[v]) for v in range(V)])
    ref = ell_spmv_reference(flat, adj, x)
    aligned = lane_aligned(flat)
    assert lane_copy_paths(aligned) == ["bulk"] * V
    key = (V, N, K, f, str(flat.dtype).replace("torch.", ""))
    for operand in (flat, aligned):
        n0 = SHAPE_LAUNCHES.get(key, 0)
        y = ell_spmv(operand, adj, x)
        torch.cuda.synchronize()
        assert SHAPE_LAUNCHES[key] == n0 + 1
        assert torch.equal(y, single)
        for v in range(V):
            assert float((y[v] - ref[v]).norm() / ref[v].norm()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_cr_factor_apply_card_matches_cpu(cuda_device, dtype, tol):
    from gmpnp_tpu_torch.solve.linear import (
        block_tridiag_apply_cr, block_tridiag_factor_cr)
    from gmpnp_tpu_torch.testing import rel_l2, tridiag_bands

    out = {}
    for dev in (cuda_device, "cpu"):
        bands = tridiag_bands(5991, 7, seed=9, dtype=dtype, device=dev)
        fac = block_tridiag_factor_cr(*bands[:3])
        x = block_tridiag_apply_cr(fac, bands[3])
        assert x.dtype == dtype and x.device.type == torch.device(dev).type
        out[str(dev)] = x.cpu().numpy()
    assert rel_l2(out["cuda"], out["cpu"]) <= tol


#: the CR apply kernel against its plain version on the card (another
#: order of summation in the f-term products; measured on an H100 at most
#: 2.2e-16 in f64 and 1.1e-7 in f32 over the cases below)
CR_APPLY_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def _cr_system(N, f, lanes, dtype, device, seed=9):
    from gmpnp_tpu_torch.solve.linear import block_tridiag_factor_cr
    from gmpnp_tpu_torch.testing import tridiag_bands

    lo, di, up, rhs = tridiag_bands(N, f, lanes, seed=seed, dtype=dtype,
                                    device=device)
    return block_tridiag_factor_cr(lo, di, up), rhs


def _cr_lane(fac, v):
    """Lane v of a lane-batched CR factorization, as a single-lane one."""
    from gmpnp_tpu_torch.solve.linear import CRFactors

    return CRFactors(tuple(type(lev)(*(t[v] for t in lev))
                           for lev in fac.levels), fac.Binv_top[v])


@pytest.mark.parametrize("V", [None, 3])
@pytest.mark.parametrize("N", [1, 2, 3, 1000, 5991, 8192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("f", [1, 5, 7, 16])
def test_cr_apply_kernel_matches_plain_version(cuda_device, f, dtype, N, V):
    from gmpnp_tpu_torch.ops import COUNTERS, cr_apply_reference
    from gmpnp_tpu_torch.solve.linear import block_tridiag_apply_cr

    fac, rhs = _cr_system(N, f, V, dtype, cuda_device)
    launches, shapes = COUNTERS["cr_apply"]
    key = ((V,) if V else ()) + (N, f, str(dtype).replace("torch.", ""))
    n0, k0 = launches[dtype], shapes.get(key, 0)
    x = block_tridiag_apply_cr(fac, rhs)
    again = block_tridiag_apply_cr(fac, rhs)
    ref = cr_apply_reference(fac.levels, fac.Binv_top, rhs)
    torch.cuda.synchronize()
    assert launches[dtype] == n0 + 2 and shapes[key] == k0 + 2
    assert x.shape == rhs.shape and x.dtype == dtype
    assert torch.equal(x, again)
    rel = float((x - ref).norm() / ref.norm())
    print(f"cr_apply f={f} {dtype} N={N} V={V}: max_rel_l2={rel!r}")
    assert rel <= CR_APPLY_TOL[dtype]
    for v in range(V or 0):
        one = block_tridiag_apply_cr(_cr_lane(fac, v), rhs[v])
        assert torch.equal(x[v], one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cr_apply_kernel_nan_and_range_where_plain_puts_them(cuda_device,
                                                             dtype):
    """Right-hand sides with rows beyond 1e16 (on a system whose diagonal
    is scaled by 0.1, so that the clamps reach the solution: some 860 of
    its values sit at +-1e16) and with a NaN (it spreads to every row):
    NaNs and clamped values exactly where the plain version has them, the
    other values within its bar; in f32 1e-4 here, not 1e-5, since the
    two orders of summation drift apart with this system's worse
    conditioning (measured 3.1e-5 on an H100; f64 within 1e-13)."""
    from gmpnp_tpu_torch.ops import cr_apply, cr_apply_reference
    from gmpnp_tpu_torch.ops.block_inv import RANGE_LIM
    from gmpnp_tpu_torch.solve.linear import block_tridiag_factor_cr
    from gmpnp_tpu_torch.testing import tridiag_bands

    lo, di, up, rhs = tridiag_bands(5991, 7, dtype=dtype, device=cuda_device)
    fac = block_tridiag_factor_cr(lo, di * 0.1, up)
    big = rhs.clone()
    big[100:140] *= 1e20
    nan = rhs.clone()
    nan[3000, 2] = float("nan")
    lim = torch.tensor(RANGE_LIM, dtype=dtype)
    out = {}
    for name, b in (("big", big), ("nan", nan)):
        x = cr_apply(fac.levels, fac.Binv_top, b)
        ref = cr_apply_reference(fac.levels, fac.Binv_top, b)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(x), torch.isnan(ref))
        assert torch.equal(x.abs() == lim, ref.abs() == lim)
        fin = ~torch.isnan(ref)
        if fin.any():
            bar = 1e-4 if dtype == torch.float32 else CR_APPLY_TOL[dtype]
            assert float((x[fin] - ref[fin]).norm()
                         / ref[fin].norm()) <= bar
        out[name] = x
    assert (out["big"].abs() == lim).sum() > 100
    assert torch.isnan(out["nan"]).all()


def test_cr_apply_kernel_on_a_side_stream(cuda_device):
    from gmpnp_tpu_torch.solve.linear import block_tridiag_apply_cr

    fac, rhs = _cr_system(5991, 7, 3, torch.float64, cuda_device)
    want = block_tridiag_apply_cr(fac, rhs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = block_tridiag_apply_cr(fac, rhs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cr_apply_kernel_refuses_what_it_does_not_take(cuda_device):
    from gmpnp_tpu_torch.ops import cr_apply

    fac, rhs = _cr_system(37, 5, None, torch.float64, cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        cr_apply(fac.levels, fac.Binv_top, rhs.to(torch.float16))
    with pytest.raises(TypeError, match="rhs torch.float32"):
        cr_apply(fac.levels, fac.Binv_top, rhs.float())
    on_cpu = [type(lev)(*(t.cpu() for t in lev)) for lev in fac.levels]
    with pytest.raises(ValueError, match="on cpu"):
        cr_apply(on_cpu, fac.Binv_top.cpu(), rhs)
    z = dict(dtype=torch.float64, device=cuda_device)
    wide = [type(lev)(*(torch.zeros((64 >> (i + 1), 17, 17), **z)
                        for _ in lev)) for i, lev in enumerate(fac.levels)]
    with pytest.raises(ValueError, match="f <= 16"):
        cr_apply(wide, torch.zeros((17, 17), **z), torch.zeros((37, 17), **z))
    with pytest.raises(ValueError, match="rows"):
        cr_apply(fac.levels[:-1], fac.Binv_top, rhs)
    with pytest.raises(ValueError, match="contiguous"):
        cr_apply(fac.levels, fac.Binv_top, rhs.t().contiguous().t())


def test_cr_apply_one_launch_an_apply_on_the_edl_path(cuda_device,
                                                      monkeypatch):
    from gmpnp_tpu_torch.models import edl_1d
    from gmpnp_tpu_torch.ops import COUNTERS
    from gmpnp_tpu_torch.solve import timeloop

    calls = []
    apply = timeloop.block_tridiag_apply_cr

    def counted(*a):
        calls.append(1)
        return apply(*a)

    monkeypatch.setattr(timeloop, "block_tridiag_apply_cr", counted)
    cfg = edl_1d.EDL1DConfig(L_n=1e-6)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, kind="tridiag_cr", refresh="carried"))
    launches = COUNTERS["cr_apply"][0]
    n0 = sum(launches.values())
    _, _, stats, _ = edl_1d.build(cfg, device=cuda_device).run(n_steps=3)
    assert np.asarray(stats.converged).all()
    assert sum(launches.values()) - n0 == len(calls) > 0


def test_carried_transient_card_matches_cpu(cuda_device):
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.testing import rel_l2

    cfg = pore_3d.Pore3DConfig(mesh_resolution=(2, 10))
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh="carried"))
    runs = {}
    for dev in (cuda_device, "cpu"):
        n0 = LAUNCHES[torch.float32]
        _, _, stats, u = pore_3d.build(cfg, device=dev).run(n_steps=3)
        assert np.asarray(stats.converged).all()
        runs[str(dev)] = (np.asarray(stats.newton_iters), u.cpu().numpy(),
                          LAUNCHES[torch.float32] - n0)
    (it_d, u_d, launched), (it_c, u_c, none) = runs["cuda"], runs["cpu"]
    np.testing.assert_array_equal(it_d, it_c)
    assert launched > 0 and none == 0
    assert rel_l2(u_d, u_c) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_at_amg_coarse_shape_repeatable(cuda_device, dtype):
    rng = np.random.default_rng(13)
    N, K, f = 98, 15, 9
    flat = torch.as_tensor(rng.normal(size=(N, f, K * f)), dtype=dtype,
                           device=cuda_device)
    adj = torch.as_tensor(rng.integers(0, N, size=(N, K)).astype(np.int32),
                          device=cuda_device)
    x = torch.as_tensor(rng.normal(size=(N, f)), dtype=dtype,
                        device=cuda_device)
    y = ell_spmv(flat, adj, x)
    assert torch.equal(y, ell_spmv(flat, adj, x))
    ref = ell_spmv_reference(flat, adj, x)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((y - ref).norm() / ref.norm()) <= tol


def _krylov_system(device, dtype=torch.float64):
    """A 3-field reaction-diffusion Jacobian on the (2, 8) pore mesh (the
    system of tests/test_torch_krylov.py), with its space and a seeded
    rhs."""
    from gmpnp_tpu_torch import fem, mesh

    m = mesh.cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=8)
    m = m.with_markers(np.zeros(len(m.facets), dtype=np.int32))
    sp = fem.FemSpace.build(m, 3, quad_degree=2, device=device)
    form = fem.WeakForm(3, lambda u, gu, up, x, th: (1.0 * u, gu))
    bc = fem.DirichletBC.from_vertex_sets(
        m.num_vertices, 3, [(np.unique(m.facets.reshape(-1))[:4], 0, 0.0)],
        device=device)
    u = torch.ones((m.num_vertices, 3), dtype=torch.float64, device=device)
    ell = bc.apply_to_jacobian(sp.jacobian(form, u, u, None))
    rhs = torch.as_tensor(np.random.default_rng(7).normal(
        size=(m.num_vertices, 3)), dtype=dtype, device=device)
    return sp, ell, rhs


def test_galerkin_and_ssor_repeatable_on_card(cuda_device):
    from gmpnp_tpu_torch.solve.amg import AMGPlan, galerkin_coarse
    from gmpnp_tpu_torch.solve.linear import multicolor_ssor_preconditioner

    sp, ell, rhs = _krylov_system(cuda_device)
    plan = AMGPlan.build(sp.adj, 3, coarsest_dofs=12)
    a = galerkin_coarse(ell, plan.levels[0])
    assert torch.equal(a.flat, galerkin_coarse(ell, plan.levels[0]).flat)
    pc = multicolor_ssor_preconditioner(ell, sp.colors, sweeps=2)
    z = pc(rhs)
    torch.cuda.synchronize()
    assert torch.equal(z, pc(rhs))
    n0 = LAUNCHES[torch.float64]
    pc(rhs)
    assert LAUNCHES[torch.float64] == n0 + 1   # the extra sweep's matvec


@pytest.mark.parametrize("kind,precond,solve_dtype", [
    ("bicgstab", "block_jacobi", "f64"), ("gmres", "block_jacobi", "f32"),
    ("gmres", "ssor", "f64"), ("gmres", "amg", "f64")])
def test_krylov_card_matches_cpu(cuda_device, kind, precond, solve_dtype):
    from gmpnp_tpu_torch.solve.amg import AMGPlan, amg_preconditioner
    from gmpnp_tpu_torch.solve.linear import (
        bicgstab, block_jacobi_preconditioner, gmres,
        multicolor_ssor_preconditioner)
    from gmpnp_tpu_torch.solve.smallblock import block_inv
    from gmpnp_tpu_torch.testing import rel_l2

    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        sp, ell, b = _krylov_system(dev)
        if solve_dtype == "f32":
            Dinv = block_inv(ell.diag_blocks())
            ell = ell.scale_rows(Dinv)
            ell = type(ell)(ell.adj, ell.flat.to(torch.float32),
                            ell.diag_slot)
            b = torch.einsum("nfg,ng->nf", Dinv, b).to(torch.float32)
        pc = {"block_jacobi": lambda: block_jacobi_preconditioner(ell),
              "ssor": lambda: multicolor_ssor_preconditioner(ell, sp.colors),
              "amg": lambda: amg_preconditioner(
                  ell, AMGPlan.build(sp.adj, 3, coarsest_dofs=12))}[precond]()
        tol = 1e-10 if solve_dtype == "f64" else 1e-5
        n0 = LAUNCHES[b.dtype]
        if kind == "gmres":
            res = gmres(ell.matvec, b, Minv=pc, tol=tol, restart=40,
                        maxiter=400)
        else:
            res = bicgstab(ell.matvec, b, Minv=pc, tol=tol, maxiter=400)
        out[dev.type] = (res, LAUNCHES[b.dtype] - n0)
    (rd, launched), (rc, _) = out["cuda"], out["cpu"]
    assert launched > 0
    assert rd.converged == rc.converged
    assert abs(rd.iters - rc.iters) <= max(1, rc.iters // 10)
    err = rel_l2(rd.x.cpu().double().numpy(), rc.x.double().numpy())
    assert err <= (1e-6 if solve_dtype == "f64" else 1e-3), err


# --- the sorted-segment sum and the batched block inverse ------------------
#
# block_inv: the kernel is bitwise equal to its plain version (every
# product, difference and quotient rounded as torch's kernels round them);
# the segment sum: bitwise equal to the sequential sum in sorted order,
# bitwise repeatable, and within the cumsum twin's own rounding of it
# (2 M eps max|prefix| per column, M the rows summed).

# the paths' widths and batches (the slab equilibration's (2,501, 9, 9),
# the 1D CR's first level (4,096, 7, 7), the 1D rxn-diff f=5) and every
# other width the kernel takes
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,f", [(2501, 9), (4096, 7), (4096, 5), (37, 1),
                                 (37, 2), (37, 3), (37, 4), (37, 6),
                                 (37, 8), (37, 10), (37, 11), (37, 12),
                                 (37, 13), (37, 14), (37, 15), (37, 16)])
def test_block_inv_kernel_bitwise_equal_to_plain(cuda_device, n, f, dtype):
    from gmpnp_tpu_torch.ops import COUNTERS, block_inv, block_inv_reference
    from gmpnp_tpu_torch.testing import guard_blocks

    A = torch.as_tensor(guard_blocks(np.random.default_rng(13), n, f)
                        .astype(dtype), device=cuda_device)
    launches = COUNTERS["block_inv"][0]
    n0 = launches[A.dtype]
    got = block_inv(A)
    again = block_inv(A)
    torch.cuda.synchronize()
    assert launches[A.dtype] == n0 + 2
    ref = block_inv_reference(A)
    assert torch.equal(got, ref)
    assert torch.equal(got, again)
    nan = A.clone()
    nan[1, 0, 0] = float("nan")        # NaN ranks highest, as in argmax
    assert torch.equal(torch.isnan(block_inv(nan)),
                       torch.isnan(block_inv_reference(nan)))


def _pore_tables(device):
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.mesh import cylinder_mesh, pore_boundary_markers

    mesh = pore_boundary_markers(cylinder_mesh(50e-9, 5e-9), 50e-9, 5e-9)
    sp = FemSpace.build(mesh, 9, quad_degree=2, device=device)
    return sp.dev["res_tables"], sp.dev["jac_tables"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which,d", [("res", 9), ("jac", 81), ("jac", 49),
                                     ("jac", 200)])
def test_segment_sum_kernel_sequential_and_repeatable(cuda_device, which, d,
                                                      dtype):
    from gmpnp_tpu_torch.ops import (COUNTERS, segment_sum, segment_sum_op,
                                     segment_sum_reference)
    from gmpnp_tpu_torch.testing import sequential_segment_sum

    res, jac = _pore_tables(cuda_device)
    order, start, end = res if which == "res" else jac
    M = order.shape[0]
    values = torch.as_tensor(np.random.default_rng(3).normal(size=(M, d)),
                             dtype=dtype, device=cuda_device)
    launches = COUNTERS["segment_sum"][0]
    n0 = launches[dtype]
    got = segment_sum(values, order, start, end)
    again = segment_sum(values, order, start, end)
    torch.cuda.synchronize()
    assert launches[dtype] == n0 + 2
    assert torch.equal(got, again)
    assert torch.equal(got, sequential_segment_sum(values, order, start,
                                                   end))
    twin = segment_sum_reference(values, order, start, end)
    prefix = torch.cumsum(values[order], dim=0).abs().amax(dim=0)
    bound = 2 * M * torch.finfo(dtype).eps * prefix
    assert bool(((got - twin).abs() <= bound).all())
    # lanes: one launch, each lane its one-lane launch
    lanes = torch.stack([values, 2.0 * values, values.flip(0)])
    one = torch.stack([segment_sum(v.contiguous(), order, start, end)
                       for v in lanes])
    assert torch.equal(segment_sum(lanes, order, start, end), one)
    assert torch.equal(torch.func.vmap(
        lambda v: segment_sum_op(v, order, start, end))(lanes), one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hot_kernels_on_a_side_stream(cuda_device, dtype):
    from gmpnp_tpu_torch.ops import block_inv, segment_sum
    from gmpnp_tpu_torch.testing import guard_blocks

    _, (order, start, end) = _pore_tables(cuda_device)
    rng = np.random.default_rng(6)
    values = torch.as_tensor(rng.normal(size=(order.shape[0], 81)),
                             dtype=dtype, device=cuda_device)
    A = torch.as_tensor(guard_blocks(rng, 2501, 9), dtype=dtype,
                        device=cuda_device)
    s, inv = segment_sum(values, order, start, end), block_inv(A)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        s_side = segment_sum(values, order, start, end)
        inv_side = block_inv(A)
    side.synchronize()
    assert torch.equal(s, s_side) and torch.equal(inv, inv_side)


# segment lengths around the kernel's chunks (testing.edge_segment_tables:
# 0, 1, 31, 32, 33 and 100 entries) at every packed width the paths use,
# the packed path's ends, and the warp-per-row path's widths
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 5, 7, 9, 16, 17, 49, 81, 129])
def test_segment_sum_kernel_edge_segments(cuda_device, d, dtype):
    from gmpnp_tpu_torch.ops import segment_sum, segment_sum_op
    from gmpnp_tpu_torch.testing import (edge_segment_tables,
                                         sequential_segment_sum)

    rng = np.random.default_rng(d)
    order, start, end = edge_segment_tables(rng, cuda_device)
    lanes = torch.as_tensor(rng.normal(size=(3, order.shape[0], d)),
                            dtype=dtype, device=cuda_device)
    got = segment_sum(lanes, order, start, end)
    one = torch.stack([segment_sum(v.contiguous(), order, start, end)
                       for v in lanes])
    torch.cuda.synchronize()
    assert torch.equal(got, sequential_segment_sum(lanes, order, start, end))
    assert torch.equal(got, one)
    assert torch.equal(got, segment_sum(lanes, order, start, end))
    assert torch.equal(torch.func.vmap(
        lambda v: segment_sum_op(v, order, start, end))(lanes), one)
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        on_side = segment_sum(lanes, order, start, end)
    side.synchronize()
    assert torch.equal(got, on_side)


# batches under one warp's blocks and not a whole number of warps or CUDA
# blocks at any f; the first ten blocks take every guard branch
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("f", list(range(1, 17)))
def test_block_inv_kernel_ragged_batches(cuda_device, f, dtype):
    from gmpnp_tpu_torch.ops import block_inv, block_inv_reference
    from gmpnp_tpu_torch.testing import guard_blocks

    for batch in (1, 31, 37, 130):
        A = torch.as_tensor(guard_blocks(np.random.default_rng(batch),
                                         batch, f).astype(dtype),
                            device=cuda_device)
        got = block_inv(A)
        assert torch.equal(got, block_inv_reference(A))
        assert torch.equal(got, block_inv(A))
        nan = A.clone()
        nan[-1, f - 1, 0] = float("nan")
        assert torch.equal(torch.isnan(block_inv(nan)),
                           torch.isnan(block_inv_reference(nan)))


_PORES = {}


def _pore(physics, mesh, device):
    """A pore program on the card: the L=50 nm, R=5 nm pore (mesh None)
    or the (2, 10) mesh of the default pore; built once per test run."""
    from gmpnp_tpu_torch.models import pore_3d

    key = (physics, mesh)
    if key not in _PORES:
        kw = ({"L": 50e-9, "R": 5e-9} if mesh is None
              else {"mesh_resolution": mesh})
        _PORES[key] = pore_3d.build(
            pore_3d.Pore3DConfig(physics=physics, **kw), device=device)
    return _PORES[key]


def _pore_call(prog, seed, scale=1.0):
    """(u, u_prev, dt, tables) of a pore residual call at seeded states."""
    from gmpnp_tpu_torch.testing import pore_states

    u, up = pore_states(prog, seed, scale)
    d = prog.space.dev
    dt = prog._theta_of_carry((u, 0.0), 0)["dt"]
    return u, up, dt, (d["cells"], d["gradN"], d["vols"], d["Nq"], d["wq"])


def _per_field_rel(a, b):
    f = b.shape[-1]
    a, b = a.reshape(-1, f), b.reshape(-1, f)
    return max(float((a[:, i] - b[:, i]).norm() / b[:, i].norm())
               for i in range(f))


# the pore residual kernel: the L=50 nm, R=5 nm pore and the (2, 10) mesh,
# GMPNP (f=9) and reaction-diffusion (f=7), the steric denominator over
# its clip (scale 1) and under it (scale 60)
@pytest.mark.parametrize("scale", [1.0, 60.0])
@pytest.mark.parametrize("mesh", [None, (2, 10)], ids=["L50R5", "2x10"])
@pytest.mark.parametrize("physics", ["GMPNP", "rxn_diff"])
def test_pore_residual_kernel_matches_plain_version(cuda_device, physics,
                                                    mesh, scale):
    from gmpnp_tpu_torch.fem import WeakForm
    from gmpnp_tpu_torch.ops import (COUNTERS, pore_residual,
                                     pore_residual_reference)

    prog = _pore(physics, mesh, cuda_device)
    sp, form = prog.space, prog.form
    u, up, dt, tables = _pore_call(prog, 11, scale)
    launches = COUNTERS["pore_residual"][0]
    n0 = launches[torch.float64]
    got = pore_residual(u, up, dt, *tables, form.spec)
    again = pore_residual(u, up, dt, *tables, form.spec)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        on_side = pore_residual(u, up, dt, *tables, form.spec)
    side.synchronize()
    assert launches[torch.float64] == n0 + 3
    assert torch.equal(got, again) and torch.equal(got, on_side)
    ref = pore_residual_reference(u, up, dt, *tables, form.spec)
    assert _per_field_rel(got, ref) <= 1e-12
    # the assembled residual: the kernel's route against the vmapped
    # element loop's (the same form without the spec)
    theta = prog._theta_of_carry((u, 0.0), 0)
    bare = WeakForm(form.n_fields, form.volume, boundary=form.boundary)
    r = sp.residual(form, u, up, theta)
    assert launches[torch.float64] == n0 + 4
    assert _per_field_rel(r, sp.residual(bare, u, up, theta)) <= 1e-12


@pytest.mark.parametrize("physics", ["GMPNP", "rxn_diff"])
def test_pore_residual_kernel_lanes_bitwise_per_lane(cuda_device, physics):
    from gmpnp_tpu_torch.ops import COUNTERS, pore_residual

    prog = _pore(physics, None, cuda_device)
    spec = prog.form.spec
    calls = [_pore_call(prog, s) for s in (21, 22, 23)]
    U = torch.stack([c[0] for c in calls])
    UP = torch.stack([c[1] for c in calls])
    dt, tables = calls[0][2], calls[0][3]
    dts = torch.tensor([dt, 0.5 * dt, 0.25 * dt], dtype=torch.float64,
                       device=cuda_device)
    launches = COUNTERS["pore_residual"][0]
    # dt per lane on the card, then one host scalar for every lane
    for lane_dt, dim in ((dts, 0), (dt, None)):
        one = torch.stack([pore_residual(
            U[v], UP[v], lane_dt if dim is None else lane_dt[v], *tables,
            spec) for v in range(3)])
        n0 = launches[torch.float64]
        lanes = torch.func.vmap(
            lambda a, b, t: pore_residual(a, b, t, *tables, spec),
            in_dims=(0, 0, dim))(U, UP, lane_dt)
        torch.cuda.synchronize()
        assert launches[torch.float64] == n0 + 1
        assert torch.equal(lanes, one)
    # FemSpace.residual_lanes: one launch for the three lanes
    from gmpnp_tpu_torch.solve.timeloop import stack_lane_theta

    theta = stack_lane_theta(
        [dict(prog._theta_of_carry((U[v], 0.0), 0), dt=dt * 0.5 ** v)
         for v in range(3)], cuda_device)
    n0 = launches[torch.float64]
    prog.space.residual_lanes(prog.form, U, UP, theta)
    assert launches[torch.float64] == n0 + 1


# ragged element counts: every position of the last element in its warp
# (3 a warp at f=9, 4 at f=7) and block (12 and 16 a block)
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 11, 12, 13, 16, 17, 97, 1001,
                               11519])
def test_pore_residual_kernel_ragged_element_counts(cuda_device, C):
    from gmpnp_tpu_torch.ops import pore_residual, pore_residual_reference

    for physics in ("GMPNP", "rxn_diff"):
        prog = _pore(physics, None, cuda_device)
        u, up, dt, tables = _pore_call(prog, C)
        lo = (prog.space.cells.shape[0] - C) // 2
        part = tuple(t[lo:lo + C] for t in tables[:3]) + tables[3:]
        got = pore_residual(u, up, dt, *part, prog.form.spec)
        torch.cuda.synchronize()
        assert got.shape == (C, 4, prog.space.n_fields)
        assert torch.equal(got, pore_residual(u, up, dt, *part,
                                              prog.form.spec))
        ref = pore_residual_reference(u, up, dt, *part, prog.form.spec)
        assert _per_field_rel(got, ref) <= 1e-12


def test_pore_residual_counter_on_the_paths(cuda_device, monkeypatch):
    """One launch per FemSpace.residual call of a carried pore step; none
    in an EDL step."""
    from gmpnp_tpu_torch.fem.assembly import FemSpace
    from gmpnp_tpu_torch.models import edl_1d, pore_3d
    from gmpnp_tpu_torch.ops import COUNTERS

    calls = [0]
    residual = FemSpace.residual

    def counted(self, *args, **kw):
        calls[0] += 1
        return residual(self, *args, **kw)

    monkeypatch.setattr(FemSpace, "residual", counted)
    launches = COUNTERS["pore_residual"][0]
    cfg = pore_3d.Pore3DConfig(mesh_resolution=(2, 10))
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh="carried"))
    n0 = launches[torch.float64]
    _, _, stats, _ = pore_3d.build(cfg, device=cuda_device).run(n_steps=3)
    assert np.asarray(stats.converged).all()
    assert calls[0] > 0 and launches[torch.float64] - n0 == calls[0]
    calls[0] = 0
    n0 = launches[torch.float64]
    edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6), device=cuda_device).run(
        n_steps=2)
    assert calls[0] > 0 and launches[torch.float64] == n0


_NNAN = np.frombuffer(np.uint64(0xFFF8000000000000).tobytes(), np.float64)[0]


def _sechenov_column(kind, N, rng):
    """One column of a Sechenov kernel check: ``random`` near bulk, heavy
    ``ties`` (one decimal), ``equal`` (one value), ``negative`` (both
    signs), ``zeros`` (+0.0 and -0.0 holding the middle ranks) or ``nan``
    (NaNs of both signs past 32 values, where torch.sort puts -NaN first
    and +NaN last; +NaN alone below, where it sorts by a bitonic network),
    once with few NaNs and once with the median among them."""
    x = 1.0 + 0.1 * rng.normal(size=N)
    if kind == "ties":
        x = np.round(x, 1)
    elif kind == "equal":
        x = np.full(N, rng.normal())
    elif kind == "negative":
        x = rng.normal(size=N) - 0.5
    elif kind == "zeros":
        x = rng.normal(size=N)
        x[rng.random(N) < 0.4] = 0.0
        x[rng.random(N) < 0.3] = -0.0
    elif kind in ("nan_few", "nan_many"):
        share = 0.1 if kind == "nan_few" else 0.6
        nans = rng.random(N) < share
        x[nans] = np.nan
        if N > 32:
            x[nans & (rng.random(N) < 0.5)] = _NNAN
    return x


def _sechenov_constants(prog, gmpnp):
    from gmpnp_tpu_torch.ops import SechenovConstants

    c = prog.sechenov
    return SechenovConstants(fields=c.fields, bc0=c.bc0, h=c.h, gmpnp=gmpnp,
                             A=c.A, bc0_CO2=c.bc0_CO2)


def _f64_bits(t):
    return t.detach().reshape(-1).cpu().view(torch.int64)


# one value, two, the pore's N=2,501 (odd) and 2,502, the 1D mesh's 5,991
# and 40,000, past the keys staged in shared memory (24,576)
@pytest.mark.parametrize("N", [1, 2, 2501, 2502, 5991, 40000])
def test_sechenov_kernel_bitwise_plain_version(cuda_device, N):
    """The kernel's four medians and its Sechenov value are the plain
    version's bits on the card (torch.sort and the scalar operations), for
    both physics, at every kind of column; bitwise repeatable, on a side
    stream too; one launch a call."""
    from gmpnp_tpu_torch.ops import (COUNTERS, sechenov_co2,
                                     sechenov_co2_reference)
    from gmpnp_tpu_torch.ops.sechenov import median

    prog = _pore("GMPNP", (2, 10), cuda_device)
    launches = COUNTERS["sechenov"][0]
    rng = np.random.default_rng(N)
    for kind in ("random", "ties", "equal", "negative", "zeros", "nan_few",
                 "nan_many"):
        cols = [_sechenov_column(kind, N, rng) for _ in range(9)]
        u = torch.tensor(np.stack(cols, axis=1), device=cuda_device)
        for gmpnp in (True, False):
            c = _sechenov_constants(prog, gmpnp)
            med = torch.empty(4, dtype=torch.float64, device=cuda_device)
            n0 = launches[torch.float64]
            got = sechenov_co2(u, c, medians=med)
            again = sechenov_co2(u, c)
            side = torch.cuda.Stream(device=cuda_device)
            with torch.cuda.stream(side):
                on_side = sechenov_co2(u, c)
            side.synchronize()
            torch.cuda.synchronize()
            assert launches[torch.float64] == n0 + 3
            want_med = torch.stack([median(u[:, i]) for i in c.fields])
            want = sechenov_co2_reference(u, c)
            label = (kind, N, gmpnp, med.tolist(), want_med.tolist(),
                     float(got), float(want))
            assert torch.equal(_f64_bits(med), _f64_bits(want_med)), label
            assert torch.equal(_f64_bits(got), _f64_bits(want)), label
            for other in (again, on_side):
                assert torch.equal(_f64_bits(other), _f64_bits(got))


def test_sechenov_kernel_refuses_what_it_does_not_take(cuda_device):
    from gmpnp_tpu_torch.ops import sechenov_co2

    prog = _pore("GMPNP", (2, 10), cuda_device)
    u = prog.initial_state()
    with pytest.raises(TypeError, match="float64"):
        sechenov_co2(u.float(), prog.sechenov)
    with pytest.raises(ValueError, match="contiguous"):
        sechenov_co2(u.t().contiguous().t(), prog.sechenov)
    with pytest.raises(ValueError, match="outside"):
        sechenov_co2(u[:, :5].contiguous(), prog.sechenov)
    with pytest.raises(ValueError, match="N, f"):
        sechenov_co2(u[:0], prog.sechenov)


@pytest.mark.parametrize("physics", ["GMPNP", "rxn_diff"])
def test_sechenov_carried_episode_bitwise_plain_path(cuda_device,
                                                     monkeypatch, physics):
    """One whole carried L=50 nm, R=5 nm episode (the benchmark cell's
    linear settings) through the kernel gives every step's CO2 Dirichlet
    value, the Newton and Krylov counts and the final state bit for bit as
    the same episode through the plain version on the card; one launch per
    _theta_of_carry call."""
    from gmpnp_tpu_torch.models import pore_3d
    from gmpnp_tpu_torch.ops import COUNTERS, sechenov_co2_reference

    cfg = pore_3d.Pore3DConfig(physics=physics, L=50e-9, R=5e-9)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh="carried", chord_dtype="f32"))
    prog = pore_3d.build(cfg, device=cuda_device)
    launches = COUNTERS["sechenov"][0]
    runs = {}
    for route in ("kernel", "plain"):
        values = []
        inner = (pore_3d.sechenov_co2 if route == "kernel"
                 else sechenov_co2_reference)

        def recorded(u, consts, inner=inner, values=values):
            out = inner(u, consts)
            values.append(out)
            return out

        monkeypatch.setattr(pore_3d, "sechenov_co2", recorded)
        n0 = launches[torch.float64]
        _, _, stats, u_final = prog.run(record_full=False)
        torch.cuda.synchronize()
        monkeypatch.undo()
        n = launches[torch.float64] - n0
        assert n == (len(values) if route == "kernel" else 0)
        runs[route] = (torch.stack(values), stats, u_final)
    (kv, ks, ku), (pv, ps, pu) = runs["kernel"], runs["plain"]
    assert kv.shape[0] >= prog.num_steps
    assert torch.equal(_f64_bits(kv), _f64_bits(pv))
    assert np.asarray(ks.converged).all()
    assert np.array_equal(np.asarray(ks.newton_iters),
                          np.asarray(ps.newton_iters))
    assert np.array_equal(np.asarray(ks.linear_iters),
                          np.asarray(ps.linear_iters))
    assert torch.equal(_f64_bits(ku), _f64_bits(pu))
