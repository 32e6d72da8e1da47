"""Sums whose order is fixed: the port's facet residual, output projections
and dense relayout reduce in sorted order (the segment-sum kernel on the
card), never by an atomic scatter, so a card run gives the same bits every
time.

Tolerances, each with its reason:
- the facet residual (the reaction-diffusion pore, whose wall and exit
  carry flux terms, and the EDL) against the reference's
  ``FemSpace.residual``: 1e-12 relative L2 (f64, the sorted segment sum in
  place of the reference's scatter-add: another summation order); its
  lanes against one-lane calls: exactly equal;
- ``mass_matvec`` against the reference's: 1e-13 relative L2 (one product
  per element, summed in another order); ``project_cellwise`` and
  ``project_gradient``: 1e-10 relative L2 (conjugate gradients to 1e-12 on
  the mass system, each package stopping at its own iterate);
- ``BlockELL.to_dense``: exactly the reference's (every block lands
  whole, padded slots add zero blocks);
- the static check: no call of an atomic scatter in the port outside
  ``ALLOWED``.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.fem import projection as jproj  # noqa: E402
from gmpnp_tpu.fem.assembly import BlockELL as JBlockELL  # noqa: E402
from gmpnp_tpu.models import edl_1d as jedl  # noqa: E402
from gmpnp_tpu.models import pore_3d as jp3  # noqa: E402
from gmpnp_tpu_torch.fem import projection as tproj  # noqa: E402
from gmpnp_tpu_torch.interop import blockell_from_numpy  # noqa: E402
from gmpnp_tpu_torch.models import edl_1d as tedl  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d as tp3  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import stack_lane_theta  # noqa: E402
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "gmpnp_tpu_torch")

#: calls whose CUDA kernels add in an order that can change between runs
ATOMIC_CALLS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_", "index_reduce",
                "index_reduce_", "put_", "histc"}
#: (module path under gmpnp_tpu_torch, call) -> why it may stay: none is
#: left; an entry needs its reason
ALLOWED = {}


@pytest.fixture(scope="module")
def programs():
    jrx = jp3.build(jp3.Pore3DConfig(mesh_resolution=(2, 10),
                                     physics="rxn_diff"))
    trx = tp3.build(tp3.Pore3DConfig(mesh_resolution=(2, 10),
                                     physics="rxn_diff"), device="cpu")
    jed = jedl.build(jedl.EDL1DConfig(L_n=1e-6))
    ted = tedl.build(tedl.EDL1DConfig(L_n=1e-6), device="cpu")
    return {"pore": (jrx, trx), "edl": (jed, ted)}


def _state(prog, seed):
    rng = np.random.default_rng(seed)
    N, f = prog.space.num_vertices, prog.space.n_fields
    u = rng.uniform(0.5, 1.5, size=(N, f))
    return u, u + 0.01 * rng.normal(size=(N, f))


@pytest.mark.parametrize("model", ["pore", "edl"])
def test_facet_residual_matches_reference(programs, model):
    jprog, tprog = programs[model]
    u, up = _state(tprog, 5)
    theta = tprog._theta_of_carry((torch.as_tensor(up), 0.0), 0)
    jtheta = {k: (float(v) if isinstance(v, torch.Tensor) else v)
              for k, v in theta.items()}
    assert any(m in tprog.form.boundary for m, _ in tprog.space.facet_tabs)
    jr = jax.jit(lambda a, b: jprog.space.residual(jprog.form, a, b,
                                                   jtheta))(
        jnp.asarray(u), jnp.asarray(up))
    tr = tprog.space.residual(tprog.form, torch.as_tensor(u),
                              torch.as_tensor(up), theta)
    assert rel_l2(tr.numpy(), np.asarray(jr)) <= 1e-12
    # three lanes (this state and two others): each lane's residual is the
    # one-lane call's, bits included
    states = [_state(tprog, s) for s in (5, 6, 7)]
    U = torch.as_tensor(np.stack([s[0] for s in states]))
    Up = torch.as_tensor(np.stack([s[1] for s in states]))
    lanes = tprog.space.residual_lanes(
        tprog.form, U, Up, stack_lane_theta([theta] * 3, "cpu"))
    for v in range(3):
        assert torch.equal(lanes[v], tprog.space.residual(
            tprog.form, U[v], Up[v], theta))


@pytest.mark.parametrize("model", ["pore", "edl"])
def test_projections_match_reference(programs, model):
    jprog, tprog = programs[model]
    rng = np.random.default_rng(11)
    N = tprog.space.num_vertices
    C = tprog.space.cells.shape[0]
    x = rng.normal(size=(N, 3))
    cells = rng.normal(size=(C, 4))
    u = rng.normal(size=N)
    js, ts = jprog.space, tprog.space
    assert rel_l2(tproj.mass_matvec(ts, torch.as_tensor(x)).numpy(),
                  np.asarray(jproj.mass_matvec(js, jnp.asarray(x)))) <= 1e-13
    assert rel_l2(tproj.project_cellwise(ts, torch.as_tensor(cells)).numpy(),
                  np.asarray(jproj.project_cellwise(
                      js, jnp.asarray(cells)))) <= 1e-10
    assert rel_l2(tproj.project_gradient(ts, torch.as_tensor(u),
                                         sign=-1.0).numpy(),
                  np.asarray(jproj.project_gradient(
                      js, jnp.asarray(u), sign=-1.0))) <= 1e-10


def test_to_dense_matches_reference():
    """Random blocks on a padded adjacency (rows padded with their own
    vertex, the padded slots holding nonzero blocks too, so that the sum
    onto the diagonal is exercised), one lane and three."""
    rng = np.random.default_rng(3)
    N, K, f = 9, 4, 3
    rows = [np.unique(np.clip(np.arange(n - 1, n + 2), 0, N - 1))
            for n in range(N)]
    adj = np.stack([np.pad(a, (0, K - len(a)), constant_values=n)
                    for n, a in enumerate(rows)]).astype(np.int32)
    diag_slot = np.argmax(adj == np.arange(N)[:, None], axis=1)
    flat = rng.normal(size=(3, N, f, K * f))
    for v in range(3):
        want = np.asarray(JBlockELL(jnp.asarray(adj), jnp.asarray(flat[v]),
                                    jnp.asarray(diag_slot)).to_dense())
        got = blockell_from_numpy(adj, flat[v], diag_slot).to_dense()
        np.testing.assert_array_equal(got.numpy(), want)
    lanes = blockell_from_numpy(adj, flat, diag_slot).to_dense()
    for v in range(3):
        assert torch.equal(lanes[v], blockell_from_numpy(
            adj, flat[v], diag_slot).to_dense())


def _accumulates(call: ast.Call) -> bool:
    return any(kw.arg == "accumulate" and not (
        isinstance(kw.value, ast.Constant) and kw.value.value is False)
        for kw in call.keywords) or len(call.args) >= 3


def atomic_calls(source: str):
    """(line, call) of every atomic scatter in ``source``: the calls of
    ``ATOMIC_CALLS``, ``torch.bincount`` and ``index_put`` /
    ``index_put_`` with ``accumulate`` (numpy's host-side calls are not
    scatters on the card)."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        owner = node.func.value
        on_numpy = isinstance(owner, ast.Name) and owner.id in ("np",
                                                                "numpy")
        if on_numpy:
            continue
        if (name in ATOMIC_CALLS or name == "bincount"
                or (name in ("index_put", "index_put_")
                    and _accumulates(node))):
            out.append((node.lineno, name))
    return out


def test_no_atomic_scatter_in_the_port():
    found = {}
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PACKAGE)
            with open(path) as fh:
                for line, call in atomic_calls(fh.read()):
                    if (rel, call) not in ALLOWED:
                        found[f"{rel}:{line}"] = call
    assert found == {}


def test_atomic_scatter_check_finds_each_form():
    src = ("r = r.index_add(0, i, v)\n"
           "d.index_put_((a, b), v, accumulate=True)\n"
           "d.index_put_((a, b), v, True)\n"
           "d.index_put_((a, b), v)\n"
           "z.scatter_add_(0, i, v)\n"
           "c = torch.bincount(i)\n"
           "c = np.bincount(i)\n")
    assert atomic_calls(src) == [(1, "index_add"), (2, "index_put_"),
                                 (3, "index_put_"), (5, "scatter_add_"),
                                 (6, "bincount")]
