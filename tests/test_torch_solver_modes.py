"""Port vs reference: the remaining solver modes — slab cyclic reduction
(``slab_mode='cr'``), f32 element Jacobians (``jac_dtype='f32'``),
``calibrate_refresh`` (``refresh='auto'``) — and the observability
utilities (StepLogger, PhaseTimer, trace_profile, ``verbose=``).

Tolerances, each with its reason:
- ``slab_factor_cr`` / ``slab_solve_cr`` on seeded, diagonally dominant f32
  bands: 1e-5 relative L2 to the reference's (f32 factors, batched
  inverses rounded by another LAPACK);
- ``slab_direct_solve(mode='cr')`` against Thomas on the (2, 8) pore's
  cold-start Jacobian, both to tol 1e-12: 1e-10 (the f64 GMRES polish
  removes the factorizations' f32 difference);
- f32 element Jacobians: 1e-6 relative L2 to the reference's f32 Jacobian
  (both round the element kernels in f32; measured 1.2e-8, against 6e-8
  between f32 and f64); one exact pore step with them converges to within
  1e-6 of the f64 step (inexact Newton);
- ``calibrate_refresh``: a valid (mode, times); the non-slab kinds' fixed
  answers equal the reference's;
- StepLogger: console text, ndjson and summary equal to the reference's.
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.solve import slab as jslab  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d  # noqa: E402
from gmpnp_tpu_torch.solve import slab as tslab  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import (  # noqa: E402
    LinearConfig, calibrate_refresh, make_implicit_step)
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

RES = (2, 8)


@pytest.fixture(scope="module")
def pore():
    """The (2, 8) pore, its cold-start BC-applied Jacobian and residual, and
    its slab plan."""
    prog = pore_3d.build(pore_3d.Pore3DConfig(mesh_resolution=RES),
                         device="cpu")
    u0 = prog.initial_state()
    theta = prog._theta_of_carry((u0, 0.0), 0)
    bc = prog._bc_of_theta(theta)
    u = bc.project(u0)
    ell = bc.apply_to_jacobian(prog.space.jacobian(prog.form, u, u0, theta))
    r = bc.apply_to_residual(prog.space.residual(prog.form, u, u0, theta), u)
    sp = prog.space
    plan = tslab.SlabPlan.build(np.asarray(sp.adj),
                                np.asarray(sp.points)[:, -1], sp.n_fields,
                                np.asarray(sp.diag_slot))
    return dict(prog=prog, u0=u0, theta=theta, ell=ell, r=r, plan=plan)


@pytest.mark.parametrize("S", [7, 8])
def test_slab_cr_factor_and_solve_match_reference(S):
    import jax.numpy as jnp

    rng = np.random.default_rng(S)
    m = 12
    lo = (0.1 * rng.normal(size=(S, m, m))).astype(np.float32)
    up = (0.1 * rng.normal(size=(S, m, m))).astype(np.float32)
    di = (np.eye(m) * 4 + 0.3 * rng.normal(size=(S, m, m))).astype(
        np.float32)
    lo[0] = 0
    up[-1] = 0
    d = rng.normal(size=(S, m)).astype(np.float32)
    jf = jslab.slab_factor_cr(jnp.asarray(lo), jnp.asarray(di),
                              jnp.asarray(up))
    tf = tslab.slab_factor_cr(*(torch.tensor(a) for a in (lo, di, up)))
    assert len(tf.levels) == len(jf.levels)
    for a, b in zip(tf.levels, jf.levels):
        for name in a._fields:
            assert rel_l2(getattr(a, name).numpy(),
                          np.asarray(getattr(b, name))) < 1e-5, name
    assert rel_l2(tf.root_inv.numpy(), np.asarray(jf.root_inv)) < 1e-5
    x = tslab.slab_solve_cr(tf, torch.tensor(d))
    assert rel_l2(x.numpy(), np.asarray(jslab.slab_solve_cr(
        jf, jnp.asarray(d)))) < 1e-5
    # the CR solve solves the banded system
    dense = np.zeros((S * m, S * m))
    for s in range(S):
        dense[s * m:(s + 1) * m, s * m:(s + 1) * m] = di[s]
        if s:
            dense[s * m:(s + 1) * m, (s - 1) * m:s * m] = lo[s]
        if s < S - 1:
            dense[s * m:(s + 1) * m, (s + 1) * m:(s + 2) * m] = up[s]
    assert rel_l2(x.numpy().reshape(-1),
                  np.linalg.solve(dense, d.reshape(-1))) < 1e-5


def test_slab_direct_solve_cr_matches_thomas(pore):
    tslab.full_f32_precision()
    ell, r, plan = pore["ell"], pore["r"], pore["plan"]
    res = {mode: tslab.slab_direct_solve(ell, r, plan, tol=1e-12,
                                         max_refine=40, mode=mode)
           for mode in ("thomas", "cr")}
    assert res["cr"].converged and res["thomas"].converged
    assert isinstance(tslab.slab_prepare(ell, plan, mode="cr").factors,
                      tslab.CRFactors)
    assert rel_l2(res["cr"].x.numpy(), res["thomas"].x.numpy()) < 1e-10


def test_f32_element_jacobian_matches_reference():
    import jax.numpy as jnp
    from gmpnp_tpu.models import pore_3d as jp3

    cfg = jp3.Pore3DConfig(mesh_resolution=RES)
    jprog = jp3.build(cfg)
    tprog = pore_3d.build(pore_3d.Pore3DConfig(mesh_resolution=RES),
                          device="cpu")
    ns, nf = len(cfg.species), cfg.n_fields
    rng = np.random.default_rng(11)
    up = np.ones((jprog.space.num_vertices, nf))
    up[:, ns] = 0
    u = up + 0.05 * rng.normal(size=up.shape)
    jth = jprog._theta_of_carry((jnp.asarray(up), 0.0), 0)
    want = jprog.space.jacobian(jprog.form, jnp.asarray(u), jnp.asarray(up),
                                jth, dtype=jnp.float32)
    tth = tprog._theta_of_carry((torch.tensor(up), 0.0), 0)
    got = tprog.space.jacobian(tprog.form, torch.tensor(u), torch.tensor(up),
                               tth, dtype=torch.float32)
    f64 = tprog.space.jacobian(tprog.form, torch.tensor(u), torch.tensor(up),
                               tth)
    assert got.flat.dtype == torch.float64
    assert rel_l2(got.flat.numpy(), np.asarray(want.flat)) < 1e-6
    # the element kernels really ran in f32
    assert rel_l2(got.flat.numpy(), f64.flat.numpy()) > 1e-9


def test_pore_step_modes_f32_jacobian_and_cr(pore):
    prog, u0, theta = pore["prog"], pore["u0"], pore["theta"]
    cfg = prog.config

    def step(**kw):
        lin = dataclasses.replace(cfg.linear, **kw)
        return make_implicit_step(prog.space, prog.form, cfg.newton, lin,
                                  bc_of_theta=prog._bc_of_theta)(u0, theta)

    u64, st64 = step()
    u32, st32 = step(jac_dtype="f32")
    ucr, stcr = step(slab_mode="cr")
    assert st64.converged and st32.converged and stcr.converged
    assert st32.newton_iters == st64.newton_iters == stcr.newton_iters
    assert rel_l2(u32.numpy(), u64.numpy()) < 1e-6
    assert rel_l2(ucr.numpy(), u64.numpy()) < 1e-6


def test_calibrate_refresh(pore):
    from gmpnp_tpu.solve import timeloop as jtl

    prog = pore["prog"]
    cfg = prog.config
    mode, times = calibrate_refresh(
        prog.space, prog.form, cfg.newton, cfg.linear, prog._bc_of_theta,
        prog.initial_state(), prog._theta_of_carry, warm_steps=1,
        probe_steps=1, reps=1)
    assert mode in ("carried", "iter")
    assert times["probe_steps"] == 1
    assert min(times["carried_window_s"], times["iter_window_s"]) > 0
    assert mode == ("carried" if times["carried_window_s"]
                    <= times["iter_window_s"] else "iter")
    for kind in ("tridiag_cr", "tridiag_thomas", "dense", "gmres",
                 "bicgstab"):
        got = calibrate_refresh(None, None, None, LinearConfig(kind=kind),
                                None, None, None)
        want = jtl.calibrate_refresh(None, None, None,
                                     jtl.LinearConfig(kind=kind), None,
                                     None, None)
        assert got == want


class FakeStats:
    def __init__(self, n):
        self.newton_iters = np.full(n, 3)
        self.converged = np.array([True] * (n - 1) + [False])
        self.residual_norm = np.linspace(1e-5, 2e-5, n)
        self.linear_iters = np.arange(n) * 7


def test_step_logger_matches_reference(tmp_path):
    from gmpnp_tpu.utils import StepLogger as JStepLogger
    from gmpnp_tpu_torch.utils import StepLogger

    out = {}
    for name, cls in (("ref", JStepLogger), ("port", StepLogger)):
        buf = io.StringIO()
        nd = str(tmp_path / f"{name}.ndjson")
        summary = cls(stream=buf, ndjson_path=nd, every=2).log_run(
            FakeStats(5), dt_phys=1e-3, extra={"run": "x"})
        with open(nd) as fh:
            out[name] = (buf.getvalue(), fh.read(), summary)
    assert out["port"] == out["ref"]
    assert "WARNING" in out["port"][0]


def test_phase_timer():
    from gmpnp_tpu_torch.utils import PhaseTimer

    t = PhaseTimer()
    for name in ("a", "a", "b"):
        with t.phase(name):
            pass
    assert t.counts == {"a": 2, "b": 1}
    assert set(t.as_dict()) == {"a", "b"}
    assert "a" in t.report() and "ms/call" in t.report()


def test_trace_profile_writes_a_trace(tmp_path):
    from gmpnp_tpu_torch.utils import trace_profile

    with trace_profile(None):
        pass
    d = str(tmp_path / "trace")
    with trace_profile(d):
        torch.ones(8).cumsum(0)
    with open(os.path.join(d, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def test_verbose_runs(capsys):
    from gmpnp_tpu_torch.models import edl_1d, rxn_diff_1d

    pore_3d.run(pore_3d.Pore3DConfig(mesh_resolution=RES), write=False,
                n_steps=1, verbose=True, device="cpu")
    edl_1d.run(edl_1d.EDL1DConfig(L_n=1e-6), write=False, n_steps=1,
               verbose=True, device="cpu")
    rxn_diff_1d.run(rxn_diff_1d.RxnDiff1DConfig(L_n=1e-6), write=False,
                    n_steps=1, verbose=True, device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step")]
    assert len(lines) == 3 and all("newton=" in ln for ln in lines)
