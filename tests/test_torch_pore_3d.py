"""Port vs reference: 3-step GMPNP pore transients and the CLI, on the
(2, 10) generated mesh.

Tolerances, each with its reason:
- tight Newton tolerances (rtol = atol = 1e-11, slab tol 1e-12, as
  tests/test_pore_3d.py::test_carried_factor_matches_exact_newton): final
  states within 1e-8 relative L2 — the BASELINE bar;
- production tolerances, carried mode with f32 chord directions: within
  1e-6 relative L2 — the f32-chord band BASELINE.md records (5-7e-7);
- the golden field summaries at rtol 5e-4, the golden's own tolerance
  (tests/test_goldens.py), on the exact-Newton run that wrote it (a
  carried run converges to another point inside the Newton tolerance: its
  H.first sits 1.1e-2 from the golden, in the reference as in the port);
- CLI arrays at rtol 1e-6 (production tolerances, as above).
Newton iterations per step are identical in every case.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.cli import pore_3d as jcli  # noqa: E402
from gmpnp_tpu.models import pore_3d as jp3  # noqa: E402
from gmpnp_tpu.solve.timeloop import LinearConfig as JLin  # noqa: E402
from gmpnp_tpu.solve.timeloop import NewtonConfig as JNewton  # noqa: E402
from gmpnp_tpu_torch.cli import pore_3d as tcli  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d as tp3  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import LinearConfig as TLin  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import NewtonConfig as TNewton  # noqa: E402
from gmpnp_tpu_torch.testing import GoldenFile, field_summary, rel_l2  # noqa: E402

RES = (2, 10)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "pore_3d_gmpnp_3steps.json")


def _run_both(refresh, tight, n_steps=3):
    """(jax iters, jax final state, torch iters, torch final state)."""
    out = []
    for mod, Newton, Lin, kw in ((jp3, JNewton, JLin, {}),
                                 (tp3, TNewton, TLin, {"device": "cpu"})):
        cfg = mod.Pore3DConfig(mesh_resolution=RES)
        if tight:
            cfg = dataclasses.replace(
                cfg, newton=Newton(max_iter=50, rtol=1e-11, atol=1e-11,
                                   relaxation=0.9),
                linear=Lin(kind="slab_direct", tol=1e-12))
        cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
            cfg.linear, refresh=refresh))
        _, _, stats, u_final = mod.build(cfg, **kw).run(n_steps=n_steps)
        assert np.asarray(stats.converged).all(), (mod.__name__, refresh)
        out += [np.asarray(stats.newton_iters),
                np.asarray(u_final) if mod is jp3 else u_final.numpy()]
    return out


def test_tight_tolerance_transients_match():
    j_it_e, j_u_e, t_it_e, t_u_e = _run_both("iter", tight=True)
    j_it_c, j_u_c, t_it_c, t_u_c = _run_both("carried", tight=True)
    np.testing.assert_array_equal(t_it_e, j_it_e)
    np.testing.assert_array_equal(t_it_c, j_it_c)
    assert rel_l2(t_u_e, j_u_e) <= 1e-8
    assert rel_l2(t_u_c, j_u_c) <= 1e-8
    assert rel_l2(t_u_c, t_u_e) <= 1e-8


@pytest.mark.parametrize("refresh", ["carried", "iter"])
def test_production_transient_matches(refresh):
    j_it, j_u, t_it, t_u = _run_both(refresh, tight=False)
    np.testing.assert_array_equal(t_it, j_it)
    assert rel_l2(t_u, j_u) <= 1e-6
    if refresh == "iter":
        names = list(tp3.Pore3DConfig().species) + ["p"]
        msg = GoldenFile(GOLDEN, rtol=5e-4).check(
            {"fields": field_summary(t_u, names)})
        assert msg is None, msg


def test_golden_reader_never_writes(tmp_path):
    missing = tmp_path / "absent.json"
    with pytest.raises(FileNotFoundError):
        GoldenFile(str(missing)).check({"a": 1.0})
    assert not missing.exists()


def _cli_run(cli, root, extra=()):
    args = ["--mesh_resolution", "2", "10", "--n_steps", "2",
            "--out_root", str(root), *extra]
    run_dir = cli.main(args)["run_dir"]
    files = sorted(os.listdir(run_dir))
    npz = {k: dict(np.load(os.path.join(run_dir, k)))
           for k in ("arrays_unscaled.npz", "arrays_scaled.npz")}
    with open(os.path.join(run_dir, "metadata.json")) as fh:
        meta = json.load(fh)
    return files, npz, meta


def test_cli_outputs_match_reference(tmp_path):
    j_files, j_npz, j_meta = _cli_run(jcli, tmp_path / "jax")
    t_files, t_npz, t_meta = _cli_run(tcli, tmp_path / "torch",
                                      ["--device", "cpu"])
    assert t_files == j_files
    assert set(t_meta) == set(j_meta)
    for k, v in j_meta.items():
        if isinstance(v, float):
            assert t_meta[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
        elif k != "linear_iters_total":   # Krylov counts may differ by one
            assert t_meta[k] == v, k
    for name in j_npz:
        assert set(t_npz[name]) == set(j_npz[name]), name
        for k, ref in j_npz[name].items():
            got = t_npz[name][k]
            assert got.shape == ref.shape, (name, k)
            assert rel_l2(got, ref) <= 1e-6, (name, k)


@pytest.mark.parametrize("refresh", ["iter", "carried"])
def test_dt_halving_recovery_matches(refresh):
    """With a Newton budget too small for the cold-start step, both
    packages halve dt the same number of times (make_recovering_step /
    make_recovering_carried_step) and agree on every step's statistics."""
    stats_by, u_by = {}, {}
    for mod, Newton, kw in ((jp3, JNewton, {}), (tp3, TNewton,
                                                   {"device": "cpu"})):
        cfg = mod.Pore3DConfig(mesh_resolution=RES, dt_retries=1)
        cfg = dataclasses.replace(
            cfg, newton=Newton(max_iter=4, rtol=1e-4, atol=1e-4,
                               relaxation=0.9),
            linear=dataclasses.replace(cfg.linear, refresh=refresh))
        _, _, stats, u = mod.build(cfg, **kw).run(n_steps=1)
        stats_by[mod] = {k: np.asarray(getattr(stats, k)) for k in
                         ("newton_iters", "converged", "dt_scale")}
        u_by[mod] = np.asarray(u) if mod is jp3 else u.numpy()
    for k, ref in stats_by[jp3].items():
        np.testing.assert_array_equal(stats_by[tp3][k], ref, err_msg=k)
    assert (stats_by[tp3]["dt_scale"] < 1.0).any()
    assert rel_l2(u_by[tp3], u_by[jp3]) <= 1e-6
