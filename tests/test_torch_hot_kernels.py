"""The port's two assembly and small-block kernels on the CPU: the wrappers
of ``ops.segment_sum`` and ``ops.block_inv`` take their plain versions for
CPU tensors and refuse what the CUDA kernels do not take; the plain
versions agree with ``gmpnp_tpu``'s ``_segment_reduce`` and ``block_inv``
on the same seeded inputs; and the segment sum's lane route (the custom
op's vmap rule) gives every lane what a one-lane call gives.  The kernels
themselves run only on a card (``tests/test_torch_cuda.py``).

Tolerances, each with its reason:
- block_inv, f64: 1e-13 relative L2 (the bar of
  ``test_torch_fem.py::test_block_inv_pivoting_and_guards_match``; the
  two packages run the same operations, XLA may fuse them otherwise);
  f32: 1e-6 (the same, in f32 rounding);
- the segment sum, f64: 1e-12 relative L2 (the two cumulative sums add in
  different orders: XLA's scan and torch's sequential loop);
- the segment sum on the edge table: 1e-12 relative L2 against the
  reference (as above) and, against the sequential sum, the cumsum's own
  rounding (2 M eps max|prefix| per column);
- the lane route and the wrappers against their plain versions: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.fem.assembly import _segment_reduce as jsegment_reduce  # noqa: E402
from gmpnp_tpu.solve.smallblock import block_inv as jblock_inv  # noqa: E402
from gmpnp_tpu_torch.fem.assembly import (  # noqa: E402
    FemSpace,
    _segment_reduce,
    _sorted_segment_tables,
)
from gmpnp_tpu_torch.mesh import cylinder_mesh, pore_boundary_markers  # noqa: E402
from gmpnp_tpu_torch.models import edl_1d  # noqa: E402
from gmpnp_tpu_torch.ops import COUNTERS  # noqa: E402
from gmpnp_tpu_torch.ops.block_inv import (  # noqa: E402
    MAX_F,
    RANGE_LIM,
    block_inv,
    block_inv_reference,
    blocks_per_warp,
)
from gmpnp_tpu_torch.ops.segment_sum import (  # noqa: E402
    MAX_PACKED_WIDTH,
    PACKED_DEPTH,
    PACKED_ROWS,
    ROW_WARP,
    segment_plan,
    segment_sum,
    segment_sum_op,
    segment_sum_reference,
)
from gmpnp_tpu_torch.solve.smallblock import block_inv as smallblock_inv  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import stack_lane_theta  # noqa: E402
from gmpnp_tpu_torch.testing import (  # noqa: E402
    EDGE_SEGMENT_LENGTHS,
    edge_segment_tables,
    guard_blocks,
    rel_l2,
    sequential_segment_sum,
)

jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("f", [5, 7, 9])
def test_block_inv_twin_matches_reference_with_guards(f, dtype, tol):
    A = guard_blocks(np.random.default_rng(f), 48, f).astype(dtype)
    ref = np.asarray(jblock_inv(jnp.asarray(A)))
    got = block_inv_reference(torch.as_tensor(A)).numpy()
    assert got.dtype == dtype
    assert rel_l2(got, ref) <= tol
    # the guards engaged: clamped entries, every value finite
    assert np.all(np.isfinite(got)) and np.abs(got).max() == dtype(
        RANGE_LIM)
    # the healthy blocks on their own (the clamped ones dominate the norm)
    assert rel_l2(got[10:], ref[10:]) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_inv_wrapper_takes_twin_on_cpu(dtype):
    A = torch.as_tensor(guard_blocks(np.random.default_rng(3), 48, 7),
                        dtype=dtype)
    n0 = dict(COUNTERS["block_inv"][0])
    got = block_inv(A)
    assert torch.equal(got, block_inv_reference(A))
    # any leading dims, and the solver's entry (strided operands copied)
    B = A.reshape(4, 12, 7, 7)
    assert torch.equal(block_inv(B), got.reshape(4, 12, 7, 7))
    assert torch.equal(smallblock_inv(B.transpose(0, 1)),
                       got.reshape(4, 12, 7, 7).transpose(0, 1))
    assert COUNTERS["block_inv"][0] == n0   # no kernel on the CPU


def test_block_inv_wrapper_refuses_what_the_kernel_does_not_take():
    A = torch.ones((3, 5, 5), dtype=torch.float64)
    with pytest.raises(TypeError):
        block_inv(A.to(torch.int64))
    with pytest.raises(TypeError):
        block_inv(A.to(torch.float16))
    with pytest.raises(ValueError):
        block_inv(torch.ones((3, 5, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        block_inv(torch.ones(5, dtype=torch.float64))
    with pytest.raises(ValueError):
        block_inv(torch.ones((2, MAX_F + 1, MAX_F + 1), dtype=torch.float64))
    with pytest.raises(ValueError):
        block_inv(A.transpose(1, 2))
    with pytest.raises(ValueError):
        block_inv(A.to("meta"))   # neither a card nor the CPU
    assert block_inv(torch.eye(MAX_F, dtype=torch.float64)).shape == (
        MAX_F, MAX_F)


@pytest.fixture(scope="module")
def pore_space():
    """The (2, 8) cylinder pore's FEM tables (9 fields)."""
    mesh = pore_boundary_markers(cylinder_mesh(100e-9, 10e-9, 2, 8),
                                 100e-9, 10e-9)
    return FemSpace.build(mesh, 9, quad_degree=2)


def _tables(tabs):
    return [torch.as_tensor(np.asarray(t), dtype=torch.int64) for t in tabs]


@pytest.mark.parametrize("which", ["residual", "jacobian", "facets",
                                   "empty_segments"])
def test_segment_sum_twin_matches_reference(pore_space, which):
    sp = pore_space
    rng = np.random.default_rng(11)
    if which == "residual":
        tabs, d = sp.res_tables, sp.n_fields
    elif which == "jacobian":
        tabs, d = sp.jac_tables, sp.n_fields ** 2
    elif which == "facets":
        tabs, d = dict(sp.facet_tabs)[2]["jac_tables"], sp.n_fields ** 2
    else:   # destinations no value reaches sum to exact zeros
        dest = rng.integers(0, 40, size=300)
        dest[(dest % 7) == 3] = 0
        tabs, d = _sorted_segment_tables(dest, 45), 5
    M = np.asarray(tabs[0]).shape[0]
    values = rng.normal(size=(M, d))
    ref = np.asarray(jsegment_reduce(jnp.asarray(values),
                                     *map(jnp.asarray, tabs)))
    t = _tables(tabs)
    got = _segment_reduce(torch.as_tensor(values), *t).numpy()
    assert rel_l2(got, ref) <= 1e-12
    empty = (t[1] == t[2]).numpy()
    assert np.all(got[empty] == 0.0) and np.all(ref[empty] == 0.0)
    if which == "empty_segments":
        assert empty.sum() >= 5
    # the wrapper and the custom op take the plain version on the CPU
    n0 = dict(COUNTERS["segment_sum"][0])
    v = torch.as_tensor(values)
    assert torch.equal(segment_sum(v, *t), segment_sum_reference(v, *t))
    assert torch.equal(segment_sum_op(v, *t), torch.as_tensor(got))
    assert COUNTERS["segment_sum"][0] == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_segment_sum_lane_route_is_bitwise_per_lane(pore_space, dtype):
    """vmap over the op makes one lane-axis call; each lane equals its
    one-lane call bitwise, from any lane axis position and nested vmaps."""
    tabs = _tables(pore_space.jac_tables)
    M, V = tabs[0].shape[0], 3
    values = torch.as_tensor(
        np.random.default_rng(4).normal(size=(V, M, 81)), dtype=dtype)
    one = torch.stack([_segment_reduce(values[v], *tabs) for v in range(V)])

    def fn(x):
        return _segment_reduce(x, *tabs)

    assert torch.equal(torch.func.vmap(fn)(values), one)
    assert torch.equal(segment_sum(values, *tabs), one)
    moved = values.movedim(0, 2).contiguous()            # (M, 81, V)
    assert torch.equal(torch.func.vmap(fn, in_dims=2)(moved), one)
    nested = torch.func.vmap(torch.func.vmap(fn))(
        torch.stack([values, values.flip(0)]))
    assert torch.equal(nested[0], one) and torch.equal(nested[1],
                                                       one.flip(0))


def test_segment_sum_wrapper_refuses_what_the_kernel_does_not_take():
    o, s, e = _tables(_sorted_segment_tables(np.array([0, 2, 2, 1]), 3))
    v = torch.ones((4, 3), dtype=torch.float64)
    assert torch.equal(segment_sum(v, o, s, e),
                       torch.tensor([[1.0] * 3, [1.0] * 3, [2.0] * 3],
                                    dtype=torch.float64))
    with pytest.raises(TypeError):
        segment_sum(v.to(torch.int32), o, s, e)
    with pytest.raises(TypeError):
        segment_sum(v, o.to(torch.int32), s, e)
    with pytest.raises(ValueError):
        segment_sum(v[:3], o, s, e)                     # order's length
    with pytest.raises(ValueError):
        segment_sum(v, o, s, e[:2])                     # start vs end
    with pytest.raises(ValueError):
        segment_sum(v.reshape(12), o, s, e)             # values' rank
    with pytest.raises(ValueError):
        segment_sum(v, o, s.to("meta"), e)              # mixed devices
    with pytest.raises(ValueError):
        segment_sum(torch.ones((3, 4), dtype=torch.float64).t(), o, s, e)
    with pytest.raises(ValueError):
        segment_sum(v.to("meta"), *(t.to("meta") for t in (o, s, e)))


def test_edl_assembly_lanes_equal_single_lanes():
    """FemSpace.residual_lanes / jacobian_lanes on the 1D EDL model (L_n =
    1 um) at three voltages: every lane bitwise its own residual and
    jacobian call."""
    prog = edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6), device="cpu")
    u0 = prog.initial_state()
    base = prog._theta_of_carry((u0, 0.0), 0)
    ths = [dict(base, voltage=v) for v in (-0.5, -1.0, -2.0)]
    theta = stack_lane_theta(ths, "cpu")
    rng = np.random.default_rng(8)
    U = u0 * (1.0 + 0.01 * torch.as_tensor(
        rng.normal(size=(3,) + tuple(u0.shape))))
    sp, form = prog.space, prog.form
    r = sp.residual_lanes(form, U, U, theta)
    J = sp.jacobian_lanes(form, U, U, theta)
    for v in range(3):
        assert torch.equal(r[v], sp.residual(form, U[v], U[v], ths[v]))
        assert torch.equal(J.flat[v],
                           sp.jacobian(form, U[v], U[v], ths[v]).flat)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", list(range(1, 17)) + [17, 49, 81, 129])
def test_segment_plan_packs_small_widths(d, itemsize):
    """Up to 16 columns as many whole rows as fit share a warp, each lane
    with a buffer of 32 entries (at most 256 bytes); wider rows take a
    warp each."""
    plan = segment_plan(d, itemsize)
    if d <= MAX_PACKED_WIDTH:
        assert plan.path == PACKED_ROWS
        assert plan.rows_per_warp * d <= 32 < (plan.rows_per_warp + 1) * d
        assert plan.depth == PACKED_DEPTH == 32
        assert plan.depth * itemsize <= 256
    else:
        assert plan == (ROW_WARP, 1, 0)
    assert {9: 3, 7: 4, 5: 6, 1: 32, 16: 2}.get(d, plan.rows_per_warp) == (
        plan.rows_per_warp)
    with pytest.raises(ValueError):
        segment_plan(0, itemsize)


@pytest.mark.parametrize("d", [1, 9, 81])
def test_edge_segment_table_matches_reference(d):
    """The kernels' edge table (rows of 0, 1, 31, 32, 33 and 100 entries):
    the lengths it promises, and the plain version against gmpnp_tpu and
    against the sequential sum."""
    order, start, end = edge_segment_tables(np.random.default_rng(d))
    lengths = (end - start).tolist()
    assert sorted(lengths) == sorted(EDGE_SEGMENT_LENGTHS * 2 + (5,))
    assert torch.equal(torch.sort(order).values,
                       torch.arange(order.shape[0]))
    values = np.random.default_rng(7).normal(size=(order.shape[0], d))
    ref = np.asarray(jsegment_reduce(
        jnp.asarray(values), *(jnp.asarray(t.numpy())
                               for t in (order, start, end))))
    v = torch.as_tensor(values)
    got = segment_sum(v, order, start, end)
    assert rel_l2(got.numpy(), ref) <= 1e-12
    seq = sequential_segment_sum(v, order, start, end)
    prefix = torch.cumsum(v[order], dim=0).abs().amax(dim=0)
    bound = 2 * order.shape[0] * torch.finfo(v.dtype).eps * prefix
    assert bool(((got - seq).abs() <= bound).all())
    assert bool((got[end == start] == 0.0).all())


@pytest.mark.parametrize("f", range(1, MAX_F + 1))
def test_block_inv_blocks_per_warp(f):
    """The kernel's f threads per block: as many whole blocks as fit in a
    warp (3 at f=9, 4 at f=7, 6 at f=5); no f outside 1..16."""
    g = blocks_per_warp(f)
    assert g * f <= 32 < (g + 1) * f
    assert {9: 3, 7: 4, 5: 6, 1: 32, 16: 2}.get(f, g) == g
    for bad in (0, MAX_F + 1):
        with pytest.raises(ValueError):
            blocks_per_warp(bad)
