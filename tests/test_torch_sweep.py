"""Port vs reference: voltage sweeps (parallel.sweep) and the arithmetic
Dirichlet BC they use.

The reference's sweeps are read from ``goldens/torch_sweeps.json`` (its
XLA compiles take ~50 s on one CPU core, more than this file's budget);
``python tests/test_torch_sweep.py`` rewrites that file from ``gmpnp_tpu``
(``chunk=0``: its lanes one after another, as the port runs them).

Tolerances, each with its reason:
- ``ArithDirichletBC``: equal to the reference's blends (the same
  arithmetic) and within 1e-15 of ``DirichletBC`` (``r + (x - r)`` rounds);
- ``_auto_chunk``: equal on a grid;
- sweep lanes: final states within rtol = atol = 1e-7 of the reference's
  (tests/test_parallel.py's bar), every lane's Newton counts and converged
  flags equal to the reference's.  The pore lanes run at tight tolerances
  (Newton rtol = atol = 1e-11, slab tol 1e-12), as the port's other
  carried-pore parity tests do: at the production tolerances the f32
  chord directions stop at other points inside the Newton tolerance (up
  to 5e-7 relative L2 and one Newton iteration apart here).  In the
  downgraded (``refresh='step'``) sweep the -1.5 V lane's cold step does
  not converge within 50 modified-Newton iterations, in both packages.
  tests/test_parallel.py allows +-4 where a backtracking halving engages
  (vmapped lanes sit on either side of the rejection threshold at
  roundoff); lane by lane on both sides the counts are equal, including
  the -2.0 V EDL lane whose cold-start steps take 7 and 6 iterations;
- lane-per-device on [cpu, cpu]: bitwise equal to the sequential sweep
  (production tolerances, carried);
- ``refresh='auto'``: resolved at sweep entry to one of the two modes,
  and the lanes equal a sweep run with that mode given explicitly.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.fem.dirichlet import DirichletBC as JDirichletBC  # noqa: E402
from gmpnp_tpu.parallel import sweep as jsweep  # noqa: E402
from gmpnp_tpu_torch.fem.dirichlet import DirichletBC  # noqa: E402
from gmpnp_tpu_torch.interop import blockell_from_numpy  # noqa: E402
from gmpnp_tpu_torch.models import edl_1d, pore_3d  # noqa: E402
from gmpnp_tpu_torch.parallel import sweep  # noqa: E402
from gmpnp_tpu_torch.solve import timeloop  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "torch_sweeps.json")
EDL_VOLTS = [-0.5, -1.0, -2.0]
PORE_VOLTS = [-0.5, -1.5]


def _pore_cfg(refresh="carried", mod=pore_3d, tl=timeloop):
    """The (2, 8) pore at tight tolerances (as tests/test_torch_pore_3d.py
    holds carried runs): rtol = atol = 1e-11, slab tol 1e-12."""
    return mod.Pore3DConfig(
        mesh_resolution=(2, 8),
        newton=tl.NewtonConfig(max_iter=50, rtol=1e-11, atol=1e-11,
                               relaxation=0.9),
        linear=tl.LinearConfig(kind="slab_direct", tol=1e-12,
                               refresh=refresh))


def write_golden():
    from gmpnp_tpu.models import edl_1d as jedl
    from gmpnp_tpu.models import pore_3d as jp3
    from gmpnp_tpu.solve import timeloop as jtl

    def record(u, st):
        u = np.asarray(u)
        return {"final": u[:, -1].tolist(),
                "newton_iters": np.asarray(st.newton_iters).tolist(),
                "converged": np.asarray(st.converged).tolist()}

    out = {"edl": record(*jsweep.run_edl_voltage_sweep(
        jedl.EDL1DConfig(L_n=1e-6), EDL_VOLTS, n_steps=3, chunk=0))}
    for chunk in (0, 2):
        cfg = _pore_cfg(mod=jp3, tl=jtl)
        out[f"pore_chunk{chunk}"] = record(*jsweep.run_pore_voltage_sweep(
            cfg, PORE_VOLTS, n_steps=2, chunk=chunk))
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


def _golden(key):
    with open(GOLDEN) as fh:
        return json.load(fh)[key]


def _check_lanes(u, stats, ref):
    np.testing.assert_allclose(u[:, -1].numpy(), np.asarray(ref["final"]),
                               rtol=1e-7, atol=1e-7)
    np.testing.assert_array_equal(stats.newton_iters, ref["newton_iters"])
    np.testing.assert_array_equal(stats.converged, ref["converged"])


def test_arith_dirichlet_bc():
    rng = np.random.default_rng(3)
    N, f = 40, 4
    mask = rng.random((N, f)) < 0.3
    vals = rng.normal(size=(N, f))
    r, u = rng.normal(size=(N, f)), rng.normal(size=(N, f))
    verts = np.array([1, 5, 7, 30])
    jbc = JDirichletBC(mask, vals).arith().set_value_arith(verts, 2, -1.25)
    bc = DirichletBC(torch.tensor(mask), torch.tensor(vals))
    abc = bc.arith().set_value_arith(verts, 2, -1.25)
    ref_bc = bc.set_value(torch.tensor(verts), 2, -1.25)
    tr, tu = torch.tensor(r), torch.tensor(u)
    for name, args in (("apply_to_residual", (r, u)), ("project", (u,))):
        want = np.asarray(getattr(jbc, name)(*args))
        got = getattr(abc, name)(*(torch.tensor(a) for a in args)).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(abc.apply_to_residual(tr, tu).numpy(),
                               ref_bc.apply_to_residual(tr, tu).numpy(),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(abc.project(tu).numpy(),
                               ref_bc.project(tu).numpy(),
                               rtol=1e-15, atol=1e-15)
    # the Jacobian row rewrite depends on the mask alone
    K = 3
    adj = np.stack([np.arange(N)] * K, axis=1).astype(np.int32)
    flat = rng.normal(size=(N, f, K * f))
    J = blockell_from_numpy(adj, flat, np.zeros(N, np.int64))
    assert torch.equal(abc.apply_to_jacobian(J).flat,
                       ref_bc.apply_to_jacobian(J).flat)


def test_auto_chunk_matches_reference():
    for lanes in (1, 2, 3, 8):
        for n in (10, 1999, 2000, 2501, 5991):
            assert sweep._auto_chunk(lanes, n) == jsweep._auto_chunk(lanes, n)


def test_edl_voltage_sweep_matches_reference():
    u, stats = sweep.run_edl_voltage_sweep(
        edl_1d.EDL1DConfig(L_n=1e-6), EDL_VOLTS, n_steps=3, device="cpu")
    assert u.shape == (3, 3, 1091, 7)
    _check_lanes(u, stats, _golden("edl"))


@pytest.fixture(scope="module")
def pore_carried():
    info = {}
    out = sweep.run_pore_voltage_sweep(_pore_cfg(), PORE_VOLTS, n_steps=2,
                                       chunk=0, device="cpu", info=info)
    return out, info


def test_pore_voltage_sweep_carried_matches_reference(pore_carried):
    (u, stats), info = pore_carried
    assert info == {"chunk": 0, "refresh": "carried"}
    _check_lanes(u, stats, _golden("pore_chunk0"))


def test_pore_voltage_sweep_downgrades_carried_when_batched():
    info = {}
    u, stats = sweep.run_pore_voltage_sweep(
        _pore_cfg(), PORE_VOLTS, n_steps=2, chunk=2, device="cpu", info=info)
    assert info == {"chunk": 2, "refresh": "step"}
    _check_lanes(u, stats, _golden("pore_chunk2"))


def _production_cfg(refresh):
    cfg = pore_3d.Pore3DConfig(mesh_resolution=(2, 8))
    return dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh=refresh))


def test_lane_per_device_equals_sequential():
    cfg = _production_cfg("carried")
    u_seq, st_seq = sweep.run_pore_voltage_sweep(
        cfg, PORE_VOLTS, n_steps=2, chunk=0, device="cpu")
    u, stats = sweep.run_pore_voltage_sweep(
        cfg, PORE_VOLTS, n_steps=2, devices=["cpu", "cpu"])
    assert torch.equal(u, u_seq)
    np.testing.assert_array_equal(stats.newton_iters, st_seq.newton_iters)


def test_ragged_lanes_raise():
    with pytest.raises(ValueError, match="multiple"):
        sweep.run_lanes_on_devices(lambda dev: None, [-0.5, -1.0, -1.5],
                                   devices=["cpu", "cpu"])


def test_default_devices_refuse_the_host(monkeypatch):
    """Without a CUDA device the default device list raises instead of
    running the lanes on the CPU; callers that want the CPU pass
    ``devices=``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA devices"):
        sweep._default_devices()
    with pytest.raises(ValueError, match="no CUDA devices"):
        sweep.run_lanes_on_devices(lambda dev: None, [-0.5])


def test_refresh_auto_resolved_at_sweep_entry():
    """ROADMAP queue 3 item 3: the reference's sweep raises deep inside
    make_linear_solver for refresh='auto'; the port calibrates first."""
    info = {}
    u, stats = sweep.run_pore_voltage_sweep(
        _production_cfg("auto"), [-1.0], n_steps=1, device="cpu", info=info)
    mode = info["refresh_calibration"]["mode"]
    assert mode in ("carried", "iter")
    assert {"carried_window_s", "iter_window_s"} <= set(
        info["refresh_calibration"])
    u2, st2 = sweep.run_pore_voltage_sweep(
        _production_cfg(mode), [-1.0], n_steps=1, device="cpu")
    assert torch.equal(u, u2)
    np.testing.assert_array_equal(stats.newton_iters, st2.newton_iters)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
    print(f"wrote {GOLDEN}")
