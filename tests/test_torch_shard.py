"""Port vs reference: z-slab domain decomposition (parallel.shard) — the
collectives and halo primitives, and one sharded exact Newton step.

The reference's sharded steps at n_dev 2 and 4 are read from
``goldens/torch_shard_step.json``: their XLA compiles take ~9 s and ~38 s
on one idle CPU core, and over 100 s while the rest of the suite runs
beside them; ``python tests/test_torch_shard.py`` rewrites that file from
``gmpnp_tpu`` on 8 virtual host devices.  The golden's problem: the GMPNP
pore at L=50 nm, R=5 nm, mesh (2, 10) (N=209), one exact step from the
cold start at the reference dt, Newton rtol = atol = 1e-10, relaxation
0.9, slab_direct GMRES(30) to tol 1e-10, replicated seam; no random
inputs.  The port runs its ranks on the host (``['cpu'] * n_dev``), as
the reference's tests run on virtual CPU devices.  (The reference runs
live in tests/test_torch_shard_transient.py, for its ``prep_init``.)  (The plans, the ring seam and BiCGStab are held in
tests/test_torch_shard_run.py.)

Tolerances, each with its reason:
- collectives: psum bitwise equal to the rank-order sum, ppermute zeros
  on ranks named by no pair, halo gather and spill reduction exact
  (spill_reduce is the transpose of halo_gather);
- one exact step (the golden's problem) at n_dev 2 and 4: within 1e-7
  relative L2 of the port's single-device step and 1e-8 of the
  reference's sharded step, the same Newton count (11) and a Krylov total
  within 2 per Newton iteration of the reference's (the f32 SPIKE
  factors round differently between LAPACKs).
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

from gmpnp_tpu.parallel import shard as jshard  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d as tpore  # noqa: E402
from gmpnp_tpu_torch.parallel import shard as tshard  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import (  # noqa: E402
    LinearConfig, NewtonConfig, make_implicit_step)
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "torch_shard_step.json")
TIGHT = 1e-10


def _ranks(rng, n, shape):
    return [torch.as_tensor(rng.standard_normal(shape)) for _ in range(n)]


def test_group_collectives():
    rng = np.random.default_rng(5)
    g = tshard.ZGroup(["cpu"] * 4)
    assert list(g.axis_index) == [0, 1, 2, 3]
    xs = _ranks(rng, 4, (3, 2))
    got = g.ppermute(xs, [(0, 1), (2, 3)])
    assert torch.equal(got[1], xs[0]) and torch.equal(got[3], xs[2])
    assert not got[0].any() and not got[2].any()
    s = g.psum([x.sum() for x in xs])
    want = ((xs[0].sum() + xs[1].sum()) + xs[2].sum()) + xs[3].sum()
    assert all(torch.equal(t, want) for t in s)
    ag = g.all_gather(xs)
    assert all(torch.equal(a, torch.stack(xs)) for a in ag)
    calls = []
    out = g.per_device(lambda v: calls.append(1) or v * 2, ag)
    assert len(calls) == 1 and all(o is out[0] for o in out)
    u = torch.as_tensor(rng.standard_normal((12, 2)))
    assert torch.equal(g.unshard(g.shard(u)), u)
    d = tshard.pdot(g, xs, xs)
    np.testing.assert_allclose(
        float(d[0]), sum(float((x * x).sum()) for x in xs), rtol=1e-15)
    np.testing.assert_allclose(float(tshard.pnorm(g, xs)[0]),
                               np.sqrt(float(d[0])), rtol=1e-15)


def test_halo_gather_spill_reduce_and_ring_shift():
    rng = np.random.default_rng(6)
    n, N_p, H, f = 4, 5, 3, 2
    g = tshard.ZGroup(["cpu"] * n)
    us = _ranks(rng, n, (N_p, f))
    ext = tshard.halo_gather(g, us, H)
    for p in range(n):
        assert torch.equal(ext[p][:N_p], us[p])
        head = us[p + 1][:H] if p < n - 1 else torch.zeros(H, f,
                                                           dtype=us[p].dtype)
        assert torch.equal(ext[p][N_p:], head)
    rs = _ranks(rng, n, (N_p + H, f))
    red = tshard.spill_reduce(g, rs, N_p, H)
    for p in range(n):
        want = rs[p][:N_p].clone()
        if p > 0:
            want[:H] += rs[p - 1][N_p:]
        assert torch.equal(red[p], want)
    # the spill reduction is the transpose of the halo gather
    lhs = sum(float((a * b).sum()) for a, b in zip(ext, rs))
    rhs = sum(float((a * b).sum()) for a, b in zip(us, red))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-13)
    for dist in (1, -1, 2, -2):
        shifted = tshard.ring_shift(g, us, dist, 0.0)
        eyes = tshard.ring_shift(g, us, dist, tshard._eye_like)
        for p in range(n):
            q = p + dist
            if 0 <= q < n:
                assert torch.equal(shifted[p], us[q])
                assert torch.equal(eyes[p], us[q])
            else:
                assert not shifted[p].any()
                assert torch.equal(eyes[p], torch.eye(f, dtype=us[p].dtype))


def _cfg():
    return tpore.Pore3DConfig(
        physics="GMPNP", L=50e-9, mesh_resolution=(2, 10),
        newton=NewtonConfig(max_iter=50, rtol=TIGHT, atol=TIGHT,
                            relaxation=0.9),
        linear=LinearConfig(kind="slab_direct", tol=TIGHT))


def _theta(prog):
    return {"dt": prog.dt_scaled,
            "co2_s1": prog.eq_conc["CO2"] / prog.bulk_conc["CO2"]}


def _sharded_step(prog, n_dev):
    """One exact sharded step of ``prog`` from its cold start on n_dev
    host ranks: the state in the mesh's vertex order and the stats."""
    cfg = prog.config
    theta = _theta(prog)
    bc = prog._bc_of_theta(theta)
    plan = tshard.ZShardPlan.build(prog.mesh, cfg.n_fields, n_dev,
                                   bc.mask.numpy(), bc.values.numpy(),
                                   quad_degree=cfg.quad_degree)
    step, group = tshard.make_sharded_step(
        plan, prog.form, ["cpu"] * n_dev, newton_max_iter=50,
        newton_rtol=TIGHT, newton_atol=TIGHT, relaxation=0.9,
        krylov_tol=TIGHT, krylov_maxiter=4000)
    u0 = group.shard(torch.as_tensor(plan.localize(
        prog.initial_state().numpy())))
    u, stats = step(u0, u0, theta)
    return plan.globalize(group.unshard(u).numpy()), stats


def _reference_step(n_dev):
    """The reference's exact sharded step on the golden's problem."""
    import jax
    import jax.numpy as jnp
    from gmpnp_tpu.models import pore_3d as jpore
    from gmpnp_tpu.solve.timeloop import NewtonConfig as JNewtonConfig

    cfg = jpore.Pore3DConfig(
        physics="GMPNP", L=50e-9, mesh_resolution=(2, 10),
        newton=JNewtonConfig(max_iter=50, rtol=TIGHT, atol=TIGHT,
                             relaxation=0.9))
    prog = jpore.build(cfg)
    theta = {"dt": jnp.asarray(prog.dt_scaled),
             "co2_s1": jnp.asarray(prog.eq_conc["CO2"]
                                   / prog.bulk_conc["CO2"])}
    bc = prog._bc_of_theta(theta)
    plan = jshard.ZShardPlan.build(prog.mesh, cfg.n_fields, n_dev,
                                   np.asarray(bc.mask), np.asarray(bc.values),
                                   quad_degree=cfg.quad_degree)
    step, _, shd = jshard.make_sharded_step(
        plan, prog.form, jax.devices()[:n_dev], newton_max_iter=50,
        newton_rtol=TIGHT, newton_atol=TIGHT, relaxation=0.9,
        krylov_tol=TIGHT, krylov_maxiter=4000)
    u0 = np.ones((plan.N, cfg.n_fields))
    u0[:, len(cfg.species)] = 0.0
    u0 = jax.device_put(jnp.asarray(plan.localize(u0)), shd)
    u, (iters, conv, rn, lin) = step(u0, u0, theta)
    return {"u": plan.globalize(np.asarray(u)).reshape(-1).tolist(),
            "newton": int(iters), "krylov": int(lin),
            "converged": bool(conv)}


def write_golden():
    out = {f"n_dev={n}": _reference_step(n) for n in (2, 4)}
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def single_step():
    prog = tpore.build(_cfg(), device="cpu")
    bc = prog._bc_of_theta(_theta(prog))
    step = make_implicit_step(prog.space, prog.form, prog.config.newton,
                              prog.config.linear, bc_of_theta=lambda th: bc)
    u, st = step(prog.initial_state(), _theta(prog))
    assert st.converged
    return prog, u.numpy(), st


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_step_matches_single_device_and_reference(single_step,
                                                          n_dev):
    prog, u_single, st_single = single_step
    with open(GOLDEN) as fh:
        ref = json.load(fh)[f"n_dev={n_dev}"]
    u_ref = np.asarray(ref["u"]).reshape(u_single.shape)
    u, (iters, conv, rn, lin) = _sharded_step(prog, n_dev)
    assert conv and ref["converged"]
    assert iters == ref["newton"] == st_single.newton_iters == 11
    assert abs(lin - ref["krylov"]) <= 2 * iters, (lin, ref["krylov"])
    assert rel_l2(u, u_single) < 1e-7
    assert rel_l2(u, u_ref) < 1e-8


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
    print(f"wrote {GOLDEN}")
