"""Port vs reference: the sharded transients (parallel.shard) and the
carried chord state handed over from the reference.

The reference's sharded results are read from
``goldens/torch_shard_transient.json`` (its XLA compiles take minutes on
one CPU core); ``python tests/test_torch_shard_transient.py`` rewrites
that file from ``gmpnp_tpu`` on 8 virtual host devices.  Both golden
entries use the GMPNP pore at L=50 nm, R=5 nm, mesh (2, 10) (N=209), the
reference dt, relaxation 0.9, Krylov tol 1e-10, the replicated seam,
refresh='carried'; no random inputs:
- ``transient``: ``make_sharded_pore_transient`` on 4 devices, 3 steps
  with the moving Sechenov CO2 lift, Newton rtol = atol = 1e-9: Newton
  and Krylov counts per step and the final state;
- ``carried_step``: ``make_sharded_step`` on 2 devices (the step's own
  Dirichlet values, no lift), Newton rtol = atol = 1e-4 (the production
  tolerance), one carried step from the cold start against the carry of
  ``prep_init`` at the cold start.
The port runs its ranks on the host (``['cpu'] * n_dev``).  (The sharded
``pore_3d.run``, the CLIs and resume are held in
tests/test_torch_shard_run.py.)

Tolerances, each with its reason:
- the carried transient (4 ranks, 3 steps): within 1e-6 relative L2 of
  the port's single-device carried run at the same Newton tolerance (two
  chord solvers — sharded f64 GMRES over the f32 SPIKE factors, and the
  single-device f32 GMRES — stop at different points inside it), Newton
  counts per step equal to the reference's;
- ``prep_init`` against the reference's, leaf by leaf (n_dev=2): element
  Jacobians and the f64 block-row scaling to 1e-12 relative (measured
  3e-16), the f32 SPIKE factors and spikes to 1e-4 (f32 rounding of
  another LAPACK: measured <= 6.5e-6), the replicated seam factor to 2e-2
  (the reduced seam block's inverse has 2-norm 2.0e5 here, which
  amplifies the spikes' f32 rounding to a measured 6.3e-3); a carried
  step from the reference's carry gives the reference's step: the same
  Newton count (11) and 1e-7 on the state (measured 1.9e-12; 8.6e-12 from
  the port's own carry);
- ``max_retries``: a step forced to fail (Newton budget 1 at tol 1e-10) is
  retried at dt/2 once and reports ``dt_scale`` 0.5 (``record_stride=2``
  keeps the second of two steps).
"""

if __name__ == "__main__":
    import os

    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.interop import shard_carry_from_numpy  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d as tpore  # noqa: E402
from gmpnp_tpu_torch.parallel import shard as tshard  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import (  # noqa: E402
    LinearConfig, NewtonConfig)
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "torch_shard_transient.json")
NEWTON_TOL, KRYLOV_TOL = 1e-9, 1e-10
CARRY_NEWTON_TOL = 1e-4     # the carried step from the reference's carry
MESH = (2, 10)


def _cfg(newton_tol=NEWTON_TOL, **kw):
    return tpore.Pore3DConfig(
        physics="GMPNP", L=50e-9, mesh_resolution=MESH,
        newton=NewtonConfig(max_iter=50, rtol=newton_tol, atol=newton_tol,
                            relaxation=0.9), **kw)


def _theta(prog):
    return {"dt": prog.dt_scaled,
            "co2_s1": prog.eq_conc["CO2"] / prog.bulk_conc["CO2"]}


# -- the reference (golden writer and live prep_init) -------------------------

def _reference_program():
    import jax.numpy as jnp
    from gmpnp_tpu.models import pore_3d as jpore
    from gmpnp_tpu.solve.timeloop import NewtonConfig as JNewtonConfig

    cfg = jpore.Pore3DConfig(
        physics="GMPNP", L=50e-9, mesh_resolution=MESH,
        newton=JNewtonConfig(max_iter=50, rtol=NEWTON_TOL, atol=NEWTON_TOL,
                             relaxation=0.9))
    prog = jpore.build(cfg)
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(prog.eq_conc["CO2"]
                                   / prog.bulk_conc["CO2"])}
    return prog, theta


def _reference_carried_step(n_dev=2):
    """The reference's carried sharded step and its prep_init carry at the
    cold start: (step, carry, u0 sharded, plan)."""
    import jax
    import jax.numpy as jnp
    from gmpnp_tpu.parallel import shard as jshard

    prog, theta = _reference_program()
    cfg = prog.config
    bc = prog._bc_of_theta(theta)
    plan = jshard.ZShardPlan.build(prog.mesh, cfg.n_fields, n_dev,
                                   np.asarray(bc.mask), np.asarray(bc.values),
                                   quad_degree=cfg.quad_degree)
    step, prep_init, _, shd = jshard.make_sharded_step(
        plan, prog.form, jax.devices()[:n_dev],
        newton_rtol=CARRY_NEWTON_TOL, newton_atol=CARRY_NEWTON_TOL,
        relaxation=0.9, krylov_tol=KRYLOV_TOL, krylov_maxiter=4000,
        refresh="carried")
    u0 = np.ones((plan.N, cfg.n_fields))
    u0[:, len(cfg.species)] = 0.0
    u0 = jax.device_put(jnp.asarray(plan.localize(u0)), shd)
    return step, prep_init(u0, u0, theta), u0, plan, theta


def write_golden():
    import jax
    from gmpnp_tpu.parallel import shard as jshard

    prog, _ = _reference_program()
    run, u0, plan = jshard.make_sharded_pore_transient(
        prog, jax.devices()[:4], n_steps=3, refresh="carried",
        krylov_tol=KRYLOV_TOL, record_stride=1)
    (u_fin, _), (_, st) = run(u0)
    out = {"transient": {
        "newton": np.asarray(st[0]).tolist(),
        "krylov": np.asarray(st[3]).tolist(),
        "converged": np.asarray(st[1]).tolist(),
        "u": np.asarray(u_fin).reshape(-1).tolist()}}
    step, carry, u0, plan, theta = _reference_carried_step()
    u, (iters, conv, rn, lin), _ = step(u0, u0, theta, carry)
    out["carried_step"] = {
        "newton": int(iters), "krylov": int(lin), "converged": bool(conv),
        "u": plan.globalize(np.asarray(u)).reshape(-1).tolist()}
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


def _golden(name):
    with open(GOLDEN) as fh:
        return json.load(fh)[name]


# -- transients ---------------------------------------------------------------

def test_carried_transient_matches_single_device_and_reference():
    ref = _golden("transient")
    cfg = _cfg(linear=LinearConfig(kind="slab_direct", refresh="carried",
                                   tol=KRYLOV_TOL))
    prog = tpore.build(cfg, device="cpu")
    run, u0, plan = tshard.make_sharded_pore_transient(
        prog, ["cpu"] * 4, n_steps=3, refresh="carried",
        krylov_tol=KRYLOV_TOL, record_stride=1)
    (u_fin, _), (u_hist, st) = run(u0)
    assert u_hist.shape == (3, plan.N, cfg.n_fields)
    assert torch.equal(u_hist[-1], u_fin)
    assert np.asarray(st[1]).all()
    assert np.asarray(st[0]).tolist() == ref["newton"]
    _, _, st1, u1 = prog.run(n_steps=3)
    assert np.asarray(st1.converged).all()
    u_fin = u_fin.numpy()
    assert rel_l2(u_fin, u1.numpy()) < 1e-6
    print(f"sharded carried: newton {np.asarray(st[0]).tolist()} krylov "
          f"{np.asarray(st[3]).tolist()} (reference {ref['newton']} "
          f"{ref['krylov']}); single-device newton "
          f"{np.asarray(st1.newton_iters).tolist()}, "
          f"{rel_l2(u_fin, u1.numpy())!r} apart; "
          f"{rel_l2(u_fin, np.asarray(ref['u']).reshape(u_fin.shape))!r} "
          f"from the reference")


def test_record_stride_must_divide_n_steps():
    prog = tpore.build(_cfg(), device="cpu")
    for k, match in ((0, ">= 1"), (2, "must divide")):
        with pytest.raises(ValueError, match=match):
            tshard.make_sharded_pore_transient(
                prog, ["cpu"] * 2, n_steps=3, record_stride=k)


def test_max_retries_halves_dt_of_a_failed_step():
    prog = tpore.build(_cfg(), device="cpu")
    run, u0, plan = tshard.make_sharded_pore_transient(
        prog, ["cpu"] * 2, n_steps=2, newton_max_iter=1,
        newton_rtol=1e-10, newton_atol=1e-10, krylov_tol=KRYLOV_TOL,
        record_stride=2, max_retries=1)
    (u_fin, _), (u_hist, st) = run(u0)
    assert len(st) == 5 and u_hist.shape[0] == 1
    assert np.asarray(st[4]).tolist() == [0.5]
    assert not np.asarray(st[1]).any()
    assert torch.isfinite(u_fin).all()


def test_carried_step_from_reference_carry():
    step_j, carry_j, u0_j, plan_j, _ = _reference_carried_step()
    n_dev = 2
    dev_j = [np.asarray(a).reshape((n_dev, -1) + tuple(a.shape[1:]))
             for a in carry_j[0]]
    rep_j = [np.asarray(a) for a in carry_j[1]]

    prog = tpore.build(_cfg(), device="cpu")
    theta = _theta(prog)
    bc = prog._bc_of_theta(theta)
    plan = tshard.ZShardPlan.build(prog.mesh, prog.config.n_fields, n_dev,
                                   bc.mask.numpy(), bc.values.numpy(),
                                   quad_degree=prog.config.quad_degree)
    step, prep_init, group = tshard.make_sharded_step(
        plan, prog.form, ["cpu"] * n_dev, newton_rtol=CARRY_NEWTON_TOL,
        newton_atol=CARRY_NEWTON_TOL, relaxation=0.9, krylov_tol=KRYLOV_TOL,
        krylov_maxiter=4000, refresh="carried")
    u0 = group.shard(torch.as_tensor(plan.localize(
        prog.initial_state().numpy())))
    dev, rep = prep_init(u0, u0, theta)

    # leaves: J_e, Dinv_b (f64); factors Dinv, Cp, Al, V, W (f32); the
    # replicated seam factors (f32)
    names = ["J_e", "Dinv_b", "Dinv", "Cp", "Al", "V", "W"]
    assert len(dev[0]) == len(names) and len(rep[0]) == 3
    for i, name in enumerate(names):
        for p in range(n_dev):
            got = dev[p][i].numpy()
            assert got.dtype == dev_j[i].dtype, name
            bar = 1e-12 if got.dtype == np.float64 else 1e-4
            assert rel_l2(got, dev_j[i][p]) < bar, (name, p)
    # the replicated seam factors (one seam: Cp and Al are zero)
    for i, bar in enumerate((2e-2, 0.0, 0.0)):
        assert rel_l2(rep[0][i].numpy(), rep_j[i]) <= bar

    ref = _golden("carried_step")
    carry = shard_carry_from_numpy(dev_j, rep_j, ["cpu"] * n_dev)
    u, (iters, conv, rn, lin), _ = step(u0, u0, theta, carry)
    u = plan.globalize(group.unshard(u).numpy())
    assert conv and ref["converged"]
    assert iters == ref["newton"]
    assert rel_l2(u, np.asarray(ref["u"]).reshape(u.shape)) < 1e-7


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
    print(f"wrote {GOLDEN}")
