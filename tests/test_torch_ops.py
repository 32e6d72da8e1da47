"""The block-ELL kernel's plain version against the reference's Pallas
kernel (interpret mode) and XLA contraction.  (The kernel itself against
its plain version on a card: tests/test_torch_cuda.py.)

Tolerances: f32 2e-5 and f64 1e-11 (summation order), as tests/test_ops.py;
GMRES solutions 5e-4 relative (f32 Krylov to 1e-6, different rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.fem import FemSpace as JFemSpace  # noqa: E402
from gmpnp_tpu.fem.assembly import BlockELL as JBlockELL  # noqa: E402
from gmpnp_tpu.mesh import cylinder_mesh, pore_boundary_markers  # noqa: E402
from gmpnp_tpu.ops.ell_spmv import (  # noqa: E402
    ell_block_contract_pallas,
    ell_contract_dispatch,
    ell_matvec_pallas,
)
from gmpnp_tpu.solve.linear import gmres as jgmres  # noqa: E402
from gmpnp_tpu_torch.interop import blockell_from_numpy  # noqa: E402
from gmpnp_tpu_torch.ops import LAUNCHES, ell_spmv  # noqa: E402
from gmpnp_tpu_torch.ops.ell_spmv import (  # noqa: E402
    ROW_THREAD,
    ROW_WARP,
    VERTEX_WARP,
    _tile_smem,
    align_vertices,
    ell_matvec,
    launch_plan,
    tile_vertices,
)
from gmpnp_tpu_torch.solve.linear import gmres as tgmres  # noqa: E402

TOL = {np.float32: 2e-5, np.float64: 1e-11}


def _random_ell(N, K, f, dtype, seed):
    rng = np.random.default_rng(seed)
    blocks = rng.normal(size=(N, K, f, f)).astype(dtype)
    adj = rng.integers(0, N, size=(N, K)).astype(np.int32)
    x = rng.normal(size=(N, f)).astype(dtype)
    flat = np.ascontiguousarray(
        np.swapaxes(blocks, 1, 2).reshape(N, f, K * f))
    return blocks, adj, x, flat


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("N,K,f", [(50, 4, 3), (200, 16, 9), (5, 1, 9),
                                   (53, 15, 8), (60, 15, 7), (61, 3, 7),
                                   (61, 3, 5), (59, 15, 5)])
def test_plain_version_matches_pallas_and_dispatch(N, K, f, dtype):
    blocks, adj, x, flat = _random_ell(N, K, f, dtype, N + K + f)
    got = ell_spmv(torch.as_tensor(flat), torch.as_tensor(adj),
                   torch.as_tensor(x)).numpy()
    xg = jnp.asarray(x)[jnp.asarray(adj)]
    pallas = np.asarray(ell_block_contract_pallas(
        jnp.asarray(blocks), xg, tile=64, interpret=True))
    xla = np.asarray(ell_contract_dispatch(jnp.asarray(blocks), xg))
    assert got.dtype == dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, xla, rtol=tol, atol=tol)


def _small_space():
    mesh = pore_boundary_markers(
        cylinder_mesh(100e-9, 10e-9, n_rings=2, n_layers=8), 100e-9, 10e-9)
    return JFemSpace.build(mesh, 3, quad_degree=2)


def test_blockell_matvec_matches_reference():
    space = _small_space()
    rng = np.random.default_rng(11)
    adj = np.asarray(space.adj)
    dslot = np.asarray(space.diag_slot)
    N, K = adj.shape
    blocks = rng.normal(size=(N, K, 3, 3))
    jell = JBlockELL.from_blocks(jnp.asarray(adj), jnp.asarray(blocks),
                                 jnp.asarray(dslot))
    tell = blockell_from_numpy(adj, np.asarray(jell.flat), dslot)
    x = rng.normal(size=(N, 3))
    got = tell.matvec(torch.as_tensor(x)).numpy()
    ref = np.asarray(jell.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11)


def test_f32_gmres_matches_reference_with_pallas_matvec():
    """f32 GMRES over the port's ell_matvec converges like the reference's
    f32 GMRES over ell_matvec_pallas (the LinearConfig.matvec='pallas'
    path)."""
    space = _small_space()
    rng = np.random.default_rng(13)
    adj = np.asarray(space.adj)
    dslot = np.asarray(space.diag_slot)
    N, K = adj.shape
    blocks = (rng.normal(size=(N, K, 3, 3)) * 0.05).astype(np.float32)
    blocks[np.arange(N), dslot] += 2.0 * np.eye(3, dtype=np.float32)
    jell = JBlockELL.from_blocks(jnp.asarray(adj), jnp.asarray(blocks),
                                 jnp.asarray(dslot))
    b = rng.normal(size=(N, 3)).astype(np.float32)
    jres = jgmres(lambda v: ell_matvec_pallas(jell, v, interpret=True),
                  jnp.asarray(b), tol=1e-6, maxiter=200)
    tell = blockell_from_numpy(adj, np.asarray(jell.flat), dslot)
    tres = tgmres(lambda v: ell_matvec(tell, v), torch.as_tensor(b),
                  tol=1e-6, maxiter=200)
    assert bool(jres.converged) and tres.converged
    assert tres.iters == int(jres.iters)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=5e-4, atol=5e-6)


def test_cpu_tensors_never_launch():
    before = dict(LAUNCHES)
    _, adj, x, flat = _random_ell(30, 5, 3, np.float32, 1)
    ell_spmv(torch.as_tensor(flat), torch.as_tensor(adj), torch.as_tensor(x))
    assert LAUNCHES == before


def test_wrapper_rejects_bad_operands():
    _, adj, x, flat = _random_ell(30, 5, 3, np.float32, 2)
    f, a, xx = (torch.as_tensor(v) for v in (flat, adj, x))
    with pytest.raises(TypeError):
        ell_spmv(f, a.long(), xx)
    with pytest.raises(TypeError):
        ell_spmv(f, a, xx.double())
    with pytest.raises(ValueError):
        ell_spmv(f, a[:-1], xx)
    x_strided = torch.as_tensor(np.ascontiguousarray(x.T)).t()
    assert not x_strided.is_contiguous()
    with pytest.raises(ValueError):
        ell_spmv(f, a, x_strided)


# a block row of f*K*f values: 4,860 B (f32) and 9,720 B (f64) at the pore's
# f=9, K=15 are multiples of 4 and 8 bytes only
@pytest.mark.parametrize("f,K,itemsize,want", [
    (9, 15, 4, 4), (9, 15, 8, 2), (8, 15, 4, 1), (8, 15, 8, 1),
    (3, 7, 4, 4), (3, 7, 8, 2), (1, 1, 4, 4), (1, 1, 8, 2), (2, 1, 4, 1),
    (9, 2, 4, 2),
    # f=7 and f=5 at the pores' K=15 (2,940 / 5,880 B and 1,500 / 3,000 B
    # rows) and the 1D meshes' K=3 (588 / 1,176 B and 300 / 600 B)
    (7, 15, 4, 4), (7, 15, 8, 2), (7, 3, 4, 4), (7, 3, 8, 2),
    (5, 15, 4, 4), (5, 15, 8, 2), (5, 3, 4, 4), (5, 3, 8, 2)])
def test_align_vertices(f, K, itemsize, want):
    assert align_vertices(f, K, itemsize) == want
    assert (want * f * K * f * itemsize) % 16 == 0
    assert all((v * f * K * f * itemsize) % 16 for v in range(1, want))


@pytest.mark.parametrize("f,K,itemsize,want", [
    (9, 15, 4, 4),       # the pore: 626 tiles of 19,440 B
    (9, 15, 8, 4),       # two aligned pairs: every warp has a vertex
    (3, 7, 4, 4),
    (1, 1, 4, 4),
    (8, 15, 4, 4),
    (20, 30, 8, 2),      # 96 KB rows: two fit, four do not
    (9, 201, 4, 1),      # four rows exceed shared memory: one, unaligned
    (7, 15, 4, 4),       # a warp per vertex: 626 tiles at the pore
    (7, 15, 8, 4),
    (5, 15, 4, 4),
    (5, 15, 8, 4),
    (7, 3, 4, 16),       # a thread per row: 112 of 128 threads
    (7, 3, 8, 18),       # 126 of 128
    (5, 3, 4, 24),       # 120 of 128
    (5, 3, 8, 24),
])
def test_tile_vertices(f, K, itemsize, want):
    tile = tile_vertices(f, K, itemsize)
    assert tile == want
    if tile > 1:
        assert tile % align_vertices(f, K, itemsize) == 0


# every model shape: the 3D pores (K=15: GMPNP f=9, reaction-diffusion
# f=7; the AMG coarse level is f=9, K=15 too), the 1D EDL (K=3, f=7) and
# reaction-diffusion (f=5) meshes, and the Krylov tests' 3- and 2-field
# systems on the run-time-f kernel
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("f,K,mode,lanes", [
    (9, 15, VERTEX_WARP, 32), (7, 15, VERTEX_WARP, 32),
    (7, 3, ROW_THREAD, 7), (5, 3, ROW_THREAD, 5),
    (3, 15, ROW_WARP, 96), (2, 3, ROW_WARP, 64)])
def test_launch_plan_at_model_shapes(f, K, mode, lanes, itemsize):
    plan = launch_plan(f, K, itemsize)
    assert (plan.mode, plan.lanes) == (mode, lanes)
    assert plan.tile == tile_vertices(f, K, itemsize)
    assert plan.tile % align_vertices(f, K, itemsize) == 0
    assert _tile_smem(plan.tile, f, K, itemsize) <= 200 * 1024
    if mode == ROW_THREAD:
        # each of the 128 threads owns at most one output row, and one
        # more aligned group of vertices would not fit
        assert 128 - f * align_vertices(f, K, itemsize) < plan.tile * f <= 128
    else:
        assert plan.tile >= 4       # every warp has a vertex or a row


def test_tile_vertices_rejects_a_row_beyond_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tile_vertices(32, 64, 4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wrapper_takes_a_view_with_a_storage_offset(dtype):
    """A contiguous view whose pointer is not 16-byte aligned is an operand
    like any other: no copy, no error."""
    _, adj, x, flat = _random_ell(7, 3, 9, dtype, 3)
    buf = torch.zeros(flat.size + 1, dtype=torch.as_tensor(flat).dtype)
    buf[1:] = torch.as_tensor(flat).reshape(-1)
    view = buf[1:].view(flat.shape)
    assert view.is_contiguous() and view.storage_offset() == 1
    got = ell_spmv(view, torch.as_tensor(adj), torch.as_tensor(x))
    want = ell_spmv(torch.as_tensor(flat), torch.as_tensor(adj),
                    torch.as_tensor(x))
    assert torch.equal(got, want)
