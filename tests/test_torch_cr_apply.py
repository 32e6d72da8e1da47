"""The 1D cyclic-reduction apply on the CPU: ``solve.linear.
block_tridiag_apply_cr`` and the wrapper ``ops.cr_apply`` take the plain
version for CPU tensors (bit for bit, no launch counted), the launch plan
``cr_plan`` splits the levels as documented, a model of the kernel's
schedule (its workspace layout, the upward sweep in place, rows in any
order) solves what the plain version solves, and the C entry points'
layout matches the source.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).

Tolerances: the schedule model against the plain version 1e-13 relative L2
(another order of summation in the f-term products); the plain version
against the one-shot ``block_tridiag_solve_cr`` 1e-12 (the two eliminate
in the same levels but invert the odd blocks separately).
"""

import importlib
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.ops import COUNTERS, cr_apply, cr_apply_reference  # noqa: E402
from gmpnp_tpu_torch.ops.block_inv import RANGE_LIM  # noqa: E402
from gmpnp_tpu_torch.solve import linear  # noqa: E402
from gmpnp_tpu_torch.testing import rel_l2, tridiag_bands  # noqa: E402

# the module (``ops.cr_apply`` is the wrapper)
cra = importlib.import_module("gmpnp_tpu_torch.ops.cr_apply")
_build = importlib.import_module("gmpnp_tpu_torch.ops._build")


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("N,f", [(1, 7), (2, 5), (3, 1), (37, 7), (64, 16)])
def test_cpu_takes_the_plain_version(N, f, lanes):
    lo, di, up, rhs = tridiag_bands(N, f, lanes)
    fac = linear.block_tridiag_factor_cr(lo, di, up)
    n0 = dict(COUNTERS["cr_apply"][0])
    shapes0 = dict(COUNTERS["cr_apply"][1])
    x = linear.block_tridiag_apply_cr(fac, rhs)
    want = cr_apply_reference(fac.levels, fac.Binv_top, rhs)
    assert torch.equal(x, want)
    assert torch.equal(cr_apply(fac.levels, fac.Binv_top, rhs), want)
    assert COUNTERS["cr_apply"][0] == n0   # no kernel on the CPU
    assert COUNTERS["cr_apply"][1] == shapes0
    assert x.shape == rhs.shape and x.dtype == rhs.dtype
    assert rel_l2(x.numpy(), linear.block_tridiag_solve_cr(
        lo, di, up, rhs).numpy()) <= 1e-12


@pytest.mark.parametrize("levels,f,want", [
    # the EDL (N=5,991) and 1D reaction-diffusion: 64 and 96 rows a pass,
    # the six levels of 4,096 .. 128 rows over 16 blocks
    (13, 7, (16, 6, 64)), (13, 5, (16, 6, 96)),
    # the narrowest and widest rows, one level, none, larger systems
    (13, 1, (8, 3, 512)), (13, 16, (16, 7, 32)), (1, 7, (1, 0, 64)),
    (0, 7, (1, 0, 64)), (7, 7, (1, 0, 64)), (8, 7, (2, 1, 64)),
    (9, 5, (4, 2, 96)), (16, 7, (16, 9, 64)), (24, 16, (16, 18, 32))])
def test_plan_splits_the_levels(levels, f, want):
    plan = cra.cr_plan(levels, f)
    assert tuple(plan) == want
    rows = plan.rows_per_block
    assert rows == (cra.THREADS // 32) * (32 // f)
    M = 1 << levels
    # the cluster's levels are exactly those wider than one block's pass
    widths = [M >> (lev + 1) for lev in range(levels)]
    assert all(w > rows for w in widths[:plan.tail])
    assert all(w <= rows for w in widths[plan.tail:])
    # what the C entry point checks: a power of two, every cluster level
    # split evenly, the one-block levels' vectors in their shared memory
    assert plan.cluster & (plan.cluster - 1) == 0
    assert plan.cluster <= cra.MAX_CLUSTER
    assert plan.tail == 0 or M >> plan.tail >= plan.cluster
    assert ((M >> plan.tail) - 1) * f <= cra.TAIL_VALUES


@pytest.mark.parametrize("levels,f", [(13, 0), (13, 17), (25, 7), (-1, 7)])
def test_plan_refuses_what_the_kernel_does_not_take(levels, f):
    with pytest.raises(ValueError, match="cr_apply takes"):
        cra.cr_plan(levels, f)


def _clamp(x):
    return np.where(np.isnan(x), x, np.clip(x, -RANGE_LIM, RANGE_LIM))


def _kernel_schedule(levels, Binv_top, rhs, rng):
    """csrc/cr_apply.cu's schedule for one lane, row by row in a shuffled
    order: D_1 .. D_L laid out as in its workspace, M - 1 rows (D_l at row
    M - 2 M / 2^l; the one-block levels keep the same layout in shared
    memory), rhs rows past N read as 0, the top solve in place, each upward
    level writing x_l over D_l (x_0 into out), each f-term product summed
    in the order k = 0 .. f-1."""
    lv = [[t.numpy() for t in lev] for lev in levels]
    b = rhs.numpy()
    N, f = b.shape
    L = len(lv)
    M = 1 << L
    ws = np.full((M - 1, f), np.nan)
    out = np.full((N, f), np.nan)

    def base(lev):
        return M - 2 * (M >> lev)

    def d_at(lev, row):
        if lev == 0:
            return b[row] if row < N else np.zeros(f)
        return ws[base(lev) + row].copy()

    def dot(a, v):
        s = np.zeros(f)
        for k in range(f):
            s = s + a[:, k] * v[k]
        return s

    for lev in range(L):
        alpha, gamma = lv[lev][:2]
        for j in rng.permutation(M >> (lev + 1)):
            left = d_at(lev, 2 * j - 1) if j > 0 else np.zeros(f)
            ws[base(lev + 1) + j] = _clamp(
                (d_at(lev, 2 * j) - dot(alpha[j], left))
                - dot(gamma[j], d_at(lev, 2 * j + 1)))
    x_top = dot(Binv_top.numpy(), d_at(L, 0))
    if L:
        ws[base(L)] = x_top
    else:
        out[0] = x_top
    for lev in reversed(range(L)):
        A_od, C_od, Binv = lv[lev][2:]
        h = M >> (lev + 1)
        for j in rng.permutation(h):
            xj = ws[base(lev + 1) + j].copy()
            xr = (ws[base(lev + 1) + j + 1].copy() if j + 1 < h
                  else np.zeros(f))
            r = _clamp((d_at(lev, 2 * j + 1) - dot(A_od[j], xj))
                       - dot(C_od[j], xr))
            xo = _clamp(dot(Binv[j], r))
            for row, val in ((2 * j, xj), (2 * j + 1, xo)):
                if lev:
                    ws[base(lev) + row] = val
                elif row < N:
                    out[row] = val
    return out


@pytest.mark.parametrize("N,f", [(1, 7), (2, 3), (5, 1), (37, 7), (64, 5),
                                 (100, 16)])
def test_kernel_schedule_solves_what_the_plain_version_solves(N, f):
    lo, di, up, rhs = tridiag_bands(N, f, seed=N + f)
    fac = linear.block_tridiag_factor_cr(lo, di, up)
    got = _kernel_schedule(fac.levels, fac.Binv_top, rhs,
                           np.random.default_rng(N))
    want = cr_apply_reference(fac.levels, fac.Binv_top, rhs).numpy()
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= 1e-13


def test_wrapper_refuses_other_devices():
    lo, di, up, rhs = tridiag_bands(9, 5)
    fac = linear.block_tridiag_factor_cr(lo, di, up)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cr_apply(fac.levels, fac.Binv_top, rhs.to("meta"))


def test_launch_layout_matches_the_source():
    src_path = os.path.join(os.path.dirname(_build.__file__), os.pardir,
                            "csrc", "cr_apply.cu")
    assert os.path.abspath(src_path) in map(os.path.abspath, _build.SOURCES)
    src = open(src_path).read()
    for name, value in (("kThreads", cra.THREADS), ("kMaxF", cra.MAX_F),
                        ("kMaxLevels", cra.MAX_LEVELS),
                        ("kMaxCluster", cra.MAX_CLUSTER),
                        ("kPerLevel", len(cra.LEVEL_FIELDS))):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert re.search(r"constexpr int kTailValues = 2 \* kWarps \* 32;", src)
    assert cra.TAIL_VALUES == 2 * (cra.THREADS // 32) * 32
    assert cra.LEVEL_FIELDS == linear._CRLevel._fields
    argtypes = dict((n, a) for n, _, a in _build._SIGNATURES)
    for t in ("f32", "f64"):
        sig = re.search(rf'extern "C" int cr_apply_{t}\(([^)]*)\)', src)
        assert len(sig.group(1).split(",")) == len(
            argtypes[f"cr_apply_{t}"]) == 12
    # the kernel's symbol stays clear of the roofline readers' names
    assert re.findall(
        r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(", src) == [
        "cr_apply_kernel"]
    assert not any(n in "cr_apply_kernel" for n in (
        "ell_spmv", "segment_sum", "block_inv", "gemm", "gemv"))
