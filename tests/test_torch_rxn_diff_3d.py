"""Port vs reference: the 3D reaction-diffusion pore (``physics='rxn_diff'``,
7 neutral species, wall and exit fluxes always on) on the (2, 10)
generated mesh.

Tolerances, each with its reason:
- residual and Jacobian, fluxes included, at a non-trivial state: 1e-12
  relative L2 (the same integrands; only the order of sums differs);
- the per-step Sechenov theta with the electroneutral cation: 1e-14
  relative (the same medians and the same closed-form solubility);
- 3 exact steps against the reference-written golden
  ``pore_3d_rxn_diff_3steps.json``: its own rtol 5e-4
  (tests/test_goldens.py);
- 3 carried steps (f32 chord directions) at tight Newton tolerances
  (rtol = atol = 1e-11, slab tol 1e-12, as tests/test_torch_pore_3d.py):
  the same Newton iterations, states within 1e-8;
- 3 carried steps at the production tolerances (the config's defaults:
  Newton rtol = atol = 1e-4, slab tol 1e-6) against the reference's
  carried run, read from ``goldens/torch_rxn_diff_carried.json``: the
  same Newton iterations, and each field within the reference's own
  carried-vs-exact spread at those tolerances (the band of this path,
  from the same golden).  The two packages' f32 chord directions round
  differently and stop at two points inside the Newton tolerance: H (the
  smallest field, ~0.04 of bulk) lies 1e-5 to 3e-5 from the reference's
  carried run, and the reference's own carried run lies ~3e-3 from its
  exact one in H (~1e-7 over all fields; the test prints both);
- the CLIs in their default exact mode, the reference's writer fed the
  port's transient: the same files, npz keys and metadata keys (no
  ``voltage_multiplier``), values within 1e-12 (the post-processing is
  the same arithmetic).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.cli import rxn_diff_3d as jcli  # noqa: E402
from gmpnp_tpu.models import pore_3d as jp3  # noqa: E402
from gmpnp_tpu.solve.timeloop import LinearConfig as JLin  # noqa: E402
from gmpnp_tpu.solve.timeloop import NewtonConfig as JNewton  # noqa: E402
from gmpnp_tpu_torch.cli import rxn_diff_3d as tcli  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d as tp3  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import LinearConfig as TLin  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import NewtonConfig as TNewton  # noqa: E402
from gmpnp_tpu_torch.testing import GoldenFile, field_summary, rel_l2  # noqa: E402

RES = (2, 10)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "pore_3d_rxn_diff_3steps.json")
CARRIED_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "goldens", "torch_rxn_diff_carried.json")


@pytest.fixture(scope="module")
def progs():
    return (jp3.build(jp3.Pore3DConfig(physics="rxn_diff",
                                       mesh_resolution=RES)),
            tp3.build(tp3.Pore3DConfig(physics="rxn_diff",
                                       mesh_resolution=RES), device="cpu"))


def _state(n, f, seed):
    rng = np.random.default_rng(seed)
    return 1.0 + 0.3 * rng.uniform(-1.0, 1.0, size=(n, f))


def test_build_is_rxn_diff(progs):
    jprog, tprog = progs
    assert tprog.config.n_fields == 7 == jprog.config.n_fields
    assert set(tprog.form.boundary) == set(jprog.form.boundary) == {2, 3}
    np.testing.assert_array_equal(tprog.bc.mask.numpy(),
                                  np.asarray(jprog.bc.mask))
    np.testing.assert_array_equal(tprog.bc.values.numpy(),
                                  np.asarray(jprog.bc.values))
    np.testing.assert_array_equal(tprog.initial_state().numpy(), 1.0)


def test_theta_with_electroneutral_cation(progs):
    jprog, tprog = progs
    u = _state(jprog.space.num_vertices, 7, 3)
    jth = jprog._theta_of_carry((jnp.asarray(u), jnp.asarray(0.0)), 0)
    tth = tprog._theta_of_carry((torch.tensor(u), 0.0), 0)
    assert float(tth["co2_s1"]) == pytest.approx(float(jth["co2_s1"]),
                                                 rel=1e-14)
    assert tth["dt"] == float(jth["dt"])
    # the cation enters: a different state of the ions moves the value
    u2 = u.copy()
    u2[:, jprog.idx["HCO3"]] *= 1.5
    assert float(tprog._theta_of_carry((torch.tensor(u2), 0.0), 0)
                 ["co2_s1"]) != float(tth["co2_s1"])


def test_residual_and_jacobian_match_reference(progs):
    jprog, tprog = progs
    n = jprog.space.num_vertices
    u, up = _state(n, 7, 1), _state(n, 7, 2)
    jth = jprog._theta_of_carry((jnp.asarray(up), jnp.asarray(0.0)), 0)
    tth = tprog._theta_of_carry((torch.tensor(up), 0.0), 0)

    @jax.jit
    def ref(u, up, th):
        bc = jprog._bc_of_theta(th)
        return (bc.apply_to_residual(
                    jprog.space.residual(jprog.form, u, up, th), u),
                bc.apply_to_jacobian(
                    jprog.space.jacobian(jprog.form, u, up, th)))

    jr, jJ = ref(jnp.asarray(u), jnp.asarray(up), jth)
    tu, tup = torch.tensor(u), torch.tensor(up)
    bc = tprog._bc_of_theta(tth)
    tr = bc.apply_to_residual(tprog.space.residual(tprog.form, tu, tup, tth),
                              tu)
    tJ = bc.apply_to_jacobian(tprog.space.jacobian(tprog.form, tu, tup, tth))
    assert rel_l2(tr.numpy(), np.asarray(jr)) <= 1e-12
    assert rel_l2(tJ.flat.numpy(), np.asarray(jJ.flat)) <= 1e-12


def test_exact_steps_match_golden(progs):
    _, tprog = progs
    _, _, stats, u = tprog.run(n_steps=3)
    assert np.asarray(stats.converged).all()
    msg = GoldenFile(GOLDEN, rtol=5e-4).check(
        {"fields": field_summary(u.numpy(), tprog.config.species)})
    assert msg is None, msg


def test_carried_steps_match_reference():
    out = []
    for mod, Newton, Lin, kw in ((jp3, JNewton, JLin, {}),
                                 (tp3, TNewton, TLin, {"device": "cpu"})):
        cfg = mod.Pore3DConfig(
            physics="rxn_diff", mesh_resolution=RES,
            newton=Newton(max_iter=50, rtol=1e-11, atol=1e-11,
                          relaxation=0.9),
            linear=Lin(kind="slab_direct", tol=1e-12, refresh="carried"))
        _, _, stats, u = mod.build(cfg, **kw).run(n_steps=3)
        assert np.asarray(stats.converged).all(), mod.__name__
        out.append((np.asarray(stats.newton_iters), np.asarray(u)))
    (j_it, j_u), (t_it, t_u) = out
    np.testing.assert_array_equal(t_it, j_it)
    assert rel_l2(t_u, j_u) <= 1e-8


def _production_run(mod, refresh, **kw):
    """3 steps at the config's default tolerances, exact ('iter') or
    carried; returns the Newton iterations and the final state."""
    cfg = mod.Pore3DConfig(physics="rxn_diff", mesh_resolution=RES)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh=refresh))
    _, _, stats, u = mod.build(cfg, **kw).run(n_steps=3)
    assert np.asarray(stats.converged).all(), (mod.__name__, refresh)
    return np.asarray(stats.newton_iters), np.asarray(u)


def _field_distances(a, b):
    """Relative L2 distance of each field of a from b."""
    return [rel_l2(a[:, i], b[:, i]) for i in range(b.shape[1])]


def write_carried_golden():
    """The reference's exact and carried runs at production tolerances."""
    out = {}
    for refresh in ("iter", "carried"):
        iters, u = _production_run(jp3, refresh)
        out[refresh] = {"newton_iters": iters.tolist(),
                        "u": u.tolist()}
    with open(CARRIED_GOLDEN, "w") as fh:
        json.dump(out, fh)


def test_carried_steps_at_production_tolerance_within_reference_band():
    """The port's carried run against the reference's, each field held to
    the reference's own carried-vs-exact spread (the band of this path)."""
    with open(CARRIED_GOLDEN) as fh:
        ref = json.load(fh)
    ref_exact = np.asarray(ref["iter"]["u"])
    ref_carried = np.asarray(ref["carried"]["u"])
    band = _field_distances(ref_carried, ref_exact)
    iters, u = _production_run(tp3, "carried", device="cpu")
    got = _field_distances(u, ref_carried)
    names = tp3.Pore3DConfig(physics="rxn_diff").species
    print("field: port carried vs reference carried / reference carried vs "
          "exact: " + ", ".join(f"{n} {g:.3e} / {b:.3e}"
                                for n, g, b in zip(names, got, band)))
    np.testing.assert_array_equal(iters, ref["carried"]["newton_iters"])
    for n, g, b in zip(names, got, band):
        assert g <= b, (n, g, b)


def _cli_run(cli, root, extra=()):
    res = cli.main(["--mesh_resolution", *map(str, RES), "--n_steps", "2",
                    "--out_root", str(root), *extra])
    run_dir = res["run_dir"]
    npz = {k: dict(np.load(os.path.join(run_dir, k)))
           for k in ("arrays_unscaled.npz", "arrays_scaled.npz")}
    with open(os.path.join(run_dir, "metadata.json")) as fh:
        meta = json.load(fh)
    return sorted(os.listdir(run_dir)), npz, meta, res


def test_cli_outputs_match_reference(tmp_path, monkeypatch):
    ran = {}
    orig_run = tp3.Pore3DProgram.run

    def keep(self, *a, **kw):
        ran["out"] = orig_run(self, *a, **kw)
        return ran["out"]

    monkeypatch.setattr(tp3.Pore3DProgram, "run", keep)
    t_files, t_npz, t_meta, t_res = _cli_run(tcli, tmp_path / "torch",
                                             ["--device", "cpu"])
    u0, u_hist, stats, u_final = ran["out"]
    port_out = (u0.numpy(), u_hist.numpy(), stats, u_final.numpy())
    monkeypatch.setattr(jp3.Pore3DProgram, "run",
                        lambda self, *a, **kw: port_out)
    j_files, j_npz, j_meta, _ = _cli_run(jcli, tmp_path / "jax")

    assert np.asarray(t_res["stats"].converged).all()
    assert "pore_rxn_diff" in t_res["run_dir"].split(os.sep)
    assert t_files == j_files
    assert not any("solution_p" in f for f in t_files)
    assert set(t_meta) == set(j_meta)
    assert "voltage_multiplier" not in t_meta
    for k, v in j_meta.items():
        if isinstance(v, float):
            assert t_meta[k] == pytest.approx(v, rel=1e-12, abs=1e-300), k
        else:
            assert t_meta[k] == v, k
    for name in j_npz:
        assert set(t_npz[name]) == set(j_npz[name]), name
        for k, ref in j_npz[name].items():
            got = t_npz[name][k]
            assert got.shape == ref.shape, (name, k)
            assert rel_l2(got, ref) <= 1e-12, (name, k)
    assert "c_cat" in t_npz["arrays_scaled.npz"]
    assert "cat" not in t_npz["arrays_unscaled.npz"]
    assert "p" not in t_npz["arrays_unscaled.npz"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_carried_golden()
    print(f"wrote {CARRIED_GOLDEN}")
