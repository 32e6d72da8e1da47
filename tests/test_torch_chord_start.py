"""The carried chord step's Newton certifies its answer as the step's
guarantee states, ``||F(u_new)|| < atol`` or ``< rtol ||F(u_start)||``
with ``u_start`` the step's safe start (u_prev with its Dirichlet
values), also where the chord iteration starts from a predicted state
whose residual is the larger: ``newton_solve``'s ``start_residual``."""

import torch

from gmpnp_tpu_torch.models import edl_1d
from gmpnp_tpu_torch.solve.newton import _l2, newton_solve
from gmpnp_tpu_torch.solve.timeloop import LinearConfig

TARGET = torch.ones(8, dtype=torch.float64)


def _residual(u):
    return u - TARGET


def _chord(u, r):
    # a stale linear solve: each iteration halves the residual
    return 0.5 * r, 0


def test_rtol_is_measured_at_the_safe_start():
    u_safe, u_pred = TARGET + 1e-2, TARGET + 10.0
    n_safe = float(_l2(_residual(u_safe)))
    kw = dict(rtol=1e-4, atol=1e-12, max_iter=60)
    loose = newton_solve(_residual, _chord, u_pred, **kw)
    assert loose.converged and loose.residual_norm > 1e-4 * n_safe
    calls = []

    def start():
        calls.append(1)
        return _residual(u_safe)

    res = newton_solve(_residual, _chord, u_pred, start_residual=start, **kw)
    assert res.converged and res.residual_norm < 1e-4 * n_safe
    assert res.iterations > loose.iterations and len(calls) == 1


def test_start_residual_unread_below_atol():
    def start():
        raise AssertionError("a start already below atol needs no reference")

    res = newton_solve(_residual, _chord, TARGET + 1e-9, rtol=1e-4,
                       atol=1e-6, start_residual=start)
    assert res.converged and res.iterations == 0


def test_carried_edl_steps_hold_the_guarantee():
    """Three carried chord steps of the 1 um double layer: the third
    starts from an overshooting prediction, and was accepted at 11.6
    times the stated bound while rtol was measured there."""
    torch.set_num_threads(1)
    cfg = edl_1d.EDL1DConfig(
        L_n=1e-6, voltage_multiplier=-2.0,
        linear=LinearConfig(kind="tridiag_cr", refresh="carried"))
    prog = edl_1d.build(cfg, device="cpu")
    u0, hist, stats, _ = prog.run(n_steps=3)
    assert bool(stats.converged.all())
    newton = cfg.newton
    for i in range(3):
        u_prev = u0 if i == 0 else hist[i - 1]
        theta = prog._theta_of_carry((u_prev, 0.0), i)

        def norm(u):
            r = prog.space.residual(prog.form, u, u_prev, theta)
            return float(_l2(prog.bc.apply_to_residual(r, u)))

        bound = max(newton.atol,
                    newton.rtol * norm(prog.bc.project(u_prev)))
        assert norm(hist[i]) < bound, i
