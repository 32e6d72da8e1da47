"""Port vs reference: GMPNP pore residual and Jacobian, Dirichlet rows,
block-row equilibration, small-block inverses, the Sechenov median.

Tolerances: 1e-12 relative L2 for residuals and Jacobians and 1e-13 for
the block operations — both f64 with a different summation order; the
median and the Dirichlet masks are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.models import pore_3d as jp3  # noqa: E402
from gmpnp_tpu.solve.smallblock import block_inv as jblock_inv  # noqa: E402
from gmpnp_tpu.solve.smallblock import block_solve as jblock_solve  # noqa: E402
from gmpnp_tpu_torch.interop import (  # noqa: E402
    blockell_from_numpy,
    dirichlet_from_numpy,
)
from gmpnp_tpu_torch.models import pore_3d as tp3  # noqa: E402
from gmpnp_tpu_torch.solve.smallblock import block_inv as tblock_inv  # noqa: E402
from gmpnp_tpu_torch.solve.smallblock import block_solve as tblock_solve  # noqa: E402
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

RES = (2, 10)


def _programs(**kw):
    jprog = jp3.build(jp3.Pore3DConfig(mesh_resolution=RES, **kw))
    tprog = tp3.build(tp3.Pore3DConfig(mesh_resolution=RES, **kw),
                      device="cpu")
    return jprog, tprog


def _state(prog, seed, steric_overload=False):
    """(u, u_prev, theta) made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    cfg = prog.config
    N, nf, ns = prog.space.num_vertices, cfg.n_fields, len(cfg.species)
    u = rng.uniform(0.5, 1.5, size=(N, nf))
    u[:, ns] = rng.normal(scale=0.5, size=N)
    up = u + 0.01 * rng.normal(size=(N, nf))
    if steric_overload:
        # sum_j scale_vol_j u_j ~ 1.5: the steric denominator sits below
        # steric_clip everywhere, so the clip is active
        sv = np.asarray([prog.params.a(s) ** 3 * prog.bulk_conc[s]
                         * prog.params.nat_const.N_A for s in cfg.species])
        u[:, :ns] *= 1.5 / (u[:, :ns] @ sv)[:, None]
    theta = {"dt": prog.dt_scaled,
             "co2_s1": prog.eq_conc["CO2"] / prog.bulk_conc["CO2"]}
    return u, up, theta


def _residual_and_jacobian(jprog, tprog, u, up, theta):
    jsp, tsp = jprog.space, tprog.space
    jr = jax.jit(lambda a, b: jsp.residual(jprog.form, a, b, theta))(
        jnp.asarray(u), jnp.asarray(up))
    jJ = jax.jit(lambda a, b: jsp.jacobian(jprog.form, a, b, theta).flat)(
        jnp.asarray(u), jnp.asarray(up))
    tu, tup = torch.as_tensor(u), torch.as_tensor(up)
    th = {"dt": theta["dt"], "co2_s1": torch.tensor(theta["co2_s1"],
                                                     dtype=torch.float64)}
    tr = tsp.residual(tprog.form, tu, tup, th)
    tJ = tsp.jacobian(tprog.form, tu, tup, th)
    return np.asarray(jr), np.asarray(jJ), tr.numpy(), tJ


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("overload", [False, True],
                         ids=["state", "steric_clip_state"])
def test_pore_residual_and_jacobian_match(faithful, overload):
    jprog, tprog = _programs(faithful=faithful)
    u, up, theta = _state(jprog, 3, steric_overload=overload)
    jr, jJ, tr, tJ = _residual_and_jacobian(jprog, tprog, u, up, theta)
    assert rel_l2(tr, jr) <= 1e-12
    assert rel_l2(tJ.flat.numpy(), jJ) <= 1e-12


def test_steric_clip_tie_derivative_matches():
    """At denom == steric_clip exactly, d(max)/d(denom) is split 0.5/0.5 in
    both frameworks (jnp.maximum; torch.maximum in the port)."""
    cfg_kw = dict(steric_clip=0.25)
    jprog, tprog = _programs(**cfg_kw)
    cfg = jprog.config
    ns, nf = len(cfg.species), cfg.n_fields
    sv = np.asarray([jprog.params.a(s) ** 3 * jprog.bulk_conc[s]
                     * jprog.params.nat_const.N_A for s in cfg.species])
    j = int(np.argmax(sv))
    t = 0.75 / sv[j]
    for _ in range(64):   # walk to the float whose product is exactly 0.75
        prod = sv[j] * t
        if prod == 0.75:
            break
        t = np.nextafter(t, -np.inf if prod > 0.75 else np.inf)
    assert sv[j] * t == 0.75
    u = np.zeros(nf)
    u[j] = t
    gu = np.random.default_rng(0).normal(size=(nf, 3))
    up = np.full(nf, 0.5)
    theta = {"dt": jprog.dt_scaled}
    x = np.zeros(3)

    def jf(uu):
        fv, fg = jprog.form.volume(uu, jnp.asarray(gu), jnp.asarray(up),
                                   jnp.asarray(x), theta)
        return jnp.concatenate([fv, fg.reshape(-1)])

    def tf(uu):
        fv, fg = tprog.form.volume(uu, torch.as_tensor(gu),
                                   torch.as_tensor(up), torch.as_tensor(x),
                                   theta)
        return torch.cat([fv, fg.reshape(-1)])

    jjac = np.asarray(jax.jacfwd(jf)(jnp.asarray(u)))
    tjac = torch.func.jacfwd(tf)(torch.as_tensor(u)).numpy()
    assert rel_l2(tjac, jjac) <= 1e-13


def test_dirichlet_and_block_operations_match():
    jprog, tprog = _programs()
    u, up, theta = _state(jprog, 5)
    jJ = jprog.space.jacobian(jprog.form, jnp.asarray(u), jnp.asarray(up),
                              theta)
    co2 = 0.9 * theta["co2_s1"]
    jbc = jprog._bc_of_theta({"co2_s1": jnp.asarray(co2)})
    tbc = tprog._bc_of_theta({"co2_s1": torch.tensor(co2,
                                                     dtype=torch.float64)})
    np.testing.assert_array_equal(tbc.mask.numpy(), np.asarray(jbc.mask))
    np.testing.assert_array_equal(tbc.values.numpy(), np.asarray(jbc.values))
    # the same BC and matrix fed from numpy through interop
    tbc2 = dirichlet_from_numpy(np.asarray(jbc.mask), np.asarray(jbc.values))
    tJ = blockell_from_numpy(np.asarray(jJ.adj), np.asarray(jJ.flat),
                             np.asarray(jJ.diag_slot))
    tu, tr = torch.as_tensor(u), torch.as_tensor(up - u)

    jJb = jbc.apply_to_jacobian(jJ)
    tJb = tbc2.apply_to_jacobian(tJ)
    np.testing.assert_array_equal(tJb.flat.numpy(), np.asarray(jJb.flat))
    np.testing.assert_array_equal(
        tbc2.apply_to_residual(tr, tu).numpy(),
        np.asarray(jbc.apply_to_residual(jnp.asarray(up - u),
                                         jnp.asarray(u))))
    np.testing.assert_array_equal(tbc2.project(tu).numpy(),
                                  np.asarray(jbc.project(jnp.asarray(u))))

    jD = jJb.diag_blocks()
    tD = tJb.diag_blocks()
    np.testing.assert_array_equal(tD.numpy(), np.asarray(jD))
    jDinv = jblock_inv(jD)
    tDinv = tblock_inv(tD)
    assert rel_l2(tDinv.numpy(), np.asarray(jDinv)) <= 1e-13
    jeq = jJb.scale_rows(jDinv)
    teq = tJb.scale_rows(torch.as_tensor(np.asarray(jDinv)))
    assert rel_l2(teq.flat.numpy(), np.asarray(jeq.flat)) <= 1e-13


def test_block_inv_pivoting_and_guards_match():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(64, 9, 9))
    A[0, 0, 0] = 0.0                      # zero leading pivot: row swap
    A[1, 1, 0] = -A[1, 0, 0]              # tied column maxima: first wins
    got = tblock_inv(torch.as_tensor(A)).numpy()
    ref = np.asarray(jblock_inv(jnp.asarray(A)))
    assert rel_l2(got, ref) <= 1e-13
    for b in (rng.normal(size=(64, 9)), rng.normal(size=(64, 9, 2))):
        got = tblock_solve(torch.as_tensor(A), torch.as_tensor(b)).numpy()
        ref = np.asarray(jblock_solve(jnp.asarray(A), jnp.asarray(b)))
        assert rel_l2(got, ref) <= 1e-13
    # singular blocks: the floored pivots and the clamp keep the output
    # finite and inside +-RANGE_LIM (values sit at the clamp, where the
    # digits carry no information, so only the guard is checked)
    S = rng.normal(size=(4, 9, 9))
    S[0] = 0.0
    S[1, 4, :] = S[1, 5, :]
    S[2] *= 1e20
    S[3, :, 0] *= 1e-20
    got = tblock_inv(torch.as_tensor(S)).numpy()
    assert np.all(np.isfinite(got)) and np.abs(got).max() <= 1e16


def test_even_length_median_averages_middle_values():
    rng = np.random.default_rng(2)
    for n in (8, 9, 210):
        x = rng.normal(size=n)
        got = float(tp3.median(torch.as_tensor(x)))
        assert got == float(jnp.median(jnp.asarray(x)))
    x = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert float(tp3.median(x)) == 2.5
    assert float(torch.median(x)) == 2.0   # torch's lower-middle rule


def test_theta_of_carry_matches():
    jprog, tprog = _programs(dt_first_scale=0.125, dt_first_steps=1)
    u, _, _ = _state(jprog, 9)
    for i in (0, 1):
        jt = jprog._theta_of_carry((jnp.asarray(u), 0.0), jnp.asarray(i))
        tt = tprog._theta_of_carry((torch.as_tensor(u), 0.0), i)
        assert float(tt["dt"]) == float(jt["dt"])
        assert abs(float(tt["co2_s1"]) - float(jt["co2_s1"])) <= (
            1e-13 * abs(float(jt["co2_s1"])))


def test_corrected_fluxes_change_the_residual():
    """faithful=False adds the wall/exit fluxes (non-zero boundary terms)."""
    jprog, tprog = _programs(faithful=True)
    _, tprog_c = _programs(faithful=False)
    u, up, theta = _state(jprog, 4)
    th = dict(theta, co2_s1=torch.tensor(theta["co2_s1"],
                                         dtype=torch.float64))
    r1 = tprog.space.residual(tprog.form, torch.as_tensor(u),
                              torch.as_tensor(up), th)
    r2 = tprog_c.space.residual(tprog_c.form, torch.as_tensor(u),
                                torch.as_tensor(up), th)
    assert float((r1 - r2).abs().max()) > 0.0
    assert dataclasses.replace(tprog.config, faithful=False) == \
        tprog_c.config
