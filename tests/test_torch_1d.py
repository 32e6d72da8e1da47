"""Port vs reference: the 1D models — the EDL model (MPNP, and PNP with
SUPG, faithful and corrected) and the planar reaction-diffusion model — on
the L_n = 1 um graded mesh (N = 1,091).

Tolerances, each with its reason:
- residual, Jacobian and SUPG parameters at a non-trivial state: 1e-12
  relative L2 (the same integrands; only the order of sums differs);
- the H_OHP controller: exact (the same rule on the same floats);
- the 5-step transients against the reference-written goldens
  ``rxn_diff_1d_5steps.json`` and ``edl_1d_mpnp_5steps.json``: their own
  rtol 1e-7 (tests/test_goldens.py) and the same Newton count;
- the carried (chord) EDL step from the reference's carry: the same Newton
  iterations, state within 1e-8 (an exact f64 CR apply of the same stale
  factorization).  The reference's side is its own factorization and its
  own Newton over its own CR apply, the chord half of its carried step:
  its whole carried step, exact fallback and refresh branches included,
  takes ~60 s of XLA compile on the CPU;
- the CLIs: the same files and npz/metadata key sets; the reference's
  writer fed the port's transient gives the port's arrays and metadata to
  1e-12 (the post-processing is the same arithmetic).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.cli import edl_1d as jcli_edl  # noqa: E402
from gmpnp_tpu.cli import rxn_diff_1d as jcli_rd  # noqa: E402
from gmpnp_tpu.models import edl_1d as jedl  # noqa: E402
from gmpnp_tpu.models import rxn_diff_1d as jrd  # noqa: E402
from gmpnp_tpu.solve import linear as jlin  # noqa: E402
from gmpnp_tpu.solve.newton import newton_solve as jnewton  # noqa: E402
from gmpnp_tpu.solve.timeloop import LinearConfig as JLin  # noqa: E402
from gmpnp_tpu.solve.timeloop import NewtonConfig as JNewton  # noqa: E402
from gmpnp_tpu_torch.cli import edl_1d as tcli_edl  # noqa: E402
from gmpnp_tpu_torch.cli import rxn_diff_1d as tcli_rd  # noqa: E402
from gmpnp_tpu_torch.interop import (  # noqa: E402
    chord_carry_from_numpy,
    cr_factors_from_numpy,
)
from gmpnp_tpu_torch.models import edl_1d as tedl  # noqa: E402
from gmpnp_tpu_torch.models import rxn_diff_1d as trd  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import LinearConfig as TLin  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import make_carried_step as tcarried  # noqa: E402
from gmpnp_tpu_torch.testing import GoldenFile, field_summary, rel_l2  # noqa: E402

L_N = 1.0e-6
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

MODELS = {
    "rxn_diff_1d": (jrd, trd, lambda m: m.RxnDiff1DConfig(L_n=L_N)),
    "edl_mpnp": (jedl, tedl, lambda m: m.EDL1DConfig(L_n=L_N)),
    "edl_pnp_supg_faithful": (jedl, tedl, lambda m: m.EDL1DConfig(
        L_n=L_N, model="PNP", stabilization="Y", H_OHP=1.1)),
    "edl_pnp_supg_corrected": (jedl, tedl, lambda m: m.EDL1DConfig(
        L_n=L_N, model="PNP", stabilization="Y", faithful_supg=False)),
}


def _state(n, f, seed):
    """A non-trivial state: species around bulk, a potential layer at the
    OHP (x = 0) with noise, and a potential that zigzags by +-3 thermal
    voltages across the coarse cells (vertices 1,000 on), so the SUPG
    cell-Peclet switch takes both branches."""
    rng = np.random.default_rng(seed)
    u = 1.0 + 0.2 * rng.uniform(-1.0, 1.0, size=(n, f))
    if f == 7:
        i = np.arange(n)
        u[:, 6] = (-4.0 * np.exp(-i / 30.0) + 0.05 * rng.normal(size=n)
                   + np.where(i >= 1000, 3.0 * (-1.0) ** i, 0.0))
    return u


@pytest.mark.parametrize("name", list(MODELS))
def test_residual_and_jacobian_match_reference(name):
    jmod, tmod, make = MODELS[name]
    jprog = jmod.build(make(jmod))
    tprog = tmod.build(make(tmod), device="cpu")
    n, f = jprog.space.num_vertices, jprog.form.n_fields
    u = _state(n, f, 1)
    up = _state(n, f, 2)
    if jmod is jedl:
        jth = jprog._theta_of_carry((jnp.asarray(up), jnp.asarray(0.3)),
                                    jnp.asarray(3))
        tth = tprog._theta_of_carry((torch.tensor(up), 0.3), 3)
    else:
        jth = {k: jnp.asarray(v) for k, v in jprog.theta.items()}
        tth = dict(tprog.theta)
    for k in jth:
        assert rel_l2(np.asarray(tth[k]), np.asarray(jth[k])) <= 1e-12, k
    jaux, taux = jth.get("_aux"), tth.get("_aux")
    if jaux is not None:
        # both sides of the cell-Peclet switch are exercised
        rho = taux.numpy()
        small = tprog.h_vert.numpy() ** 2 / 4.0
        hit_small = np.isclose(rho[:, 0], small, rtol=1e-12)
        assert hit_small.any() and not hit_small.all()

    def jfn(u, up, th):
        bc, sp = jprog.bc, jprog.space
        return (bc.apply_to_residual(
                    sp.residual(jprog.form, u, up, th, aux=th.get("_aux")), u),
                bc.apply_to_jacobian(
                    sp.jacobian(jprog.form, u, up, th, aux=th.get("_aux"))))

    jr, jJ = jax.jit(jfn)(jnp.asarray(u), jnp.asarray(up), jth)
    tu, tup = torch.tensor(u), torch.tensor(up)
    bc, sp = tprog.bc, tprog.space
    tr = bc.apply_to_residual(
        sp.residual(tprog.form, tu, tup, tth, aux=taux), tu)
    tJ = bc.apply_to_jacobian(
        sp.jacobian(tprog.form, tu, tup, tth, aux=taux))
    assert rel_l2(tr.numpy(), np.asarray(jr)) <= 1e-12
    assert rel_l2(tJ.flat.numpy(), np.asarray(jJ.flat)) <= 1e-12
    np.testing.assert_array_equal(tJ.adj.numpy(), np.asarray(jJ.adj))


@pytest.fixture(scope="module")
def controller_progs():
    cfg = dict(L_n=L_N, H_OHP=1.1)
    return (jedl.build(jedl.EDL1DConfig(**cfg)),
            tedl.build(tedl.EDL1DConfig(**cfg), device="cpu"))


H = 1.1


@pytest.mark.parametrize("chf,frac", [
    (0.5, -0.2),          # negative proton fraction
    (0.5, H - 0.2),       # well below the target
    (0.5, H - 0.03),      # slightly below
    (0.5, H + 0.2),       # above
    (0.5, H + 0.6),       # far above
    (1.5, H + 0.2),       # above, fraction capped
    (0.5, H - 0.01),      # inside the dead band
    (0.5, H),             # at the target
], ids=["negative", "well_below", "below", "above", "far_above", "capped",
        "dead_band", "at_target"])
def test_controller_matches_reference(controller_progs, chf, frac):
    jprog, tprog = controller_progs
    n = jprog.space.num_vertices
    ju = jnp.zeros((n, 7)).at[0, 0].set(frac)
    tu = torch.zeros((n, 7), dtype=torch.float64)
    tu[0, 0] = frac
    ref = float(jprog._update_carry(jnp.asarray(chf), ju, 0))
    assert tprog._update_carry(chf, tu, 0) == ref


@pytest.mark.parametrize("golden,name", [
    ("rxn_diff_1d_5steps.json", "rxn_diff_1d"),
    ("edl_1d_mpnp_5steps.json", "edl_mpnp")])
def test_five_steps_match_golden(golden, name):
    _, tmod, make = MODELS[name]
    prog = tmod.build(make(tmod), device="cpu")
    out = prog.run(n_steps=5)
    hist, stats = out[1], out[2]
    assert np.asarray(stats.converged).all()
    names = (list(trd.SPECIES) if tmod is trd
             else list(prog.config.species) + ["p"])
    msg = GoldenFile(os.path.join(GOLDENS, golden), rtol=1e-7).check({
        "fields": field_summary(hist[-1].numpy(), names),
        "newton_iters": int(np.asarray(stats.newton_iters).sum())})
    assert msg is None, msg


def test_carried_step_from_reference_carry():
    """Step 1 of a carried EDL run: the cold-start step 0 has ended in the
    exact-Newton fallback (its chord diverges from the cold-start
    factorization, in both packages) and refreshed the factorization at
    its state u1.  From the reference's carry at u1 (its f64 CR
    factorization through interop, du = u1 - u0), the port's carried step
    takes the reference's chord Newton iterations to its state and keeps
    the carried factorization."""
    lin = dict(kind="tridiag_cr", refresh="carried")
    jprog = jedl.build(jedl.EDL1DConfig(L_n=L_N))
    tprog = tedl.build(tedl.EDL1DConfig(L_n=L_N), device="cpu")
    newton = tprog.config.newton
    tstep, tinit = tcarried(tprog.space, tprog.form, newton, TLin(**lin),
                            bc_of_theta=lambda th: tprog.bc)
    tu0 = tprog.initial_state()
    tth0 = tprog._theta_of_carry((tu0, 0.0), 0)
    tu1, st0, _ = tstep(tu0, tth0, tinit(tu0, tth0))
    assert st0.converged and st0.newton_iters == 3

    u0, u1 = jnp.asarray(tu0.numpy()), jnp.asarray(tu1.numpy())
    jth0 = jprog._theta_of_carry((u0, jnp.asarray(0.0)), jnp.asarray(0))
    jth1 = jprog._theta_of_carry((u1, jnp.asarray(0.0)), jnp.asarray(1))
    bc = jprog.bc

    @jax.jit
    def reference(u0, u1, th0, th1):
        # the refresh of step 0 (prep_of at the accepted state) ...
        fac = jlin.block_tridiag_factor_cr(*jlin.block_tridiag_from_ell(
            bc.apply_to_jacobian(jprog.space.jacobian(jprog.form, u1, u0,
                                                      th0))))
        # ... and the chord attempt of step 1 (du_nrm_prev = 0: no
        # extrapolation)
        res = jnewton(
            lambda u: bc.apply_to_residual(
                jprog.space.residual(jprog.form, u, u1, th1), u),
            lambda u, r: (jlin.block_tridiag_apply_cr(fac, r),
                          jnp.array(0, jnp.int32)),
            bc.project(u1), rtol=newton.rtol, atol=newton.atol,
            max_iter=min(JLin().chord_max_iter, newton.max_iter),
            relaxation=newton.relaxation, loop=JNewton().loop,
            backtracking=newton.backtracking, bt_growth=newton.bt_growth,
            carry_residual=newton.carry_residual, du_max=newton.du_max,
            stall_atol=newton.stall_atol, stall_iters=newton.stall_iters)
        return fac, res

    jfac, jres = reference(u0, u1, jth0, jth1)
    assert bool(jres.converged)

    tprep = cr_factors_from_numpy(
        [tuple(np.asarray(a) for a in lev) for lev in jfac.levels],
        np.asarray(jfac.Binv_top))
    tcarry = chord_carry_from_numpy(tprep, np.asarray(u1 - u0),
                                    np.asarray(jth0["dt"]), 0.0)
    tu2, tst, tcarry2 = tstep(tu1, tprog._theta_of_carry((tu1, 0.0), 1),
                              tcarry)
    assert tst.converged and tst.linear_iters == 0
    assert tst.newton_iters == int(jres.iterations) <= JLin().refresh_iters
    assert tcarry2.prep is tprep          # no refresh: the carry rides on
    assert rel_l2(tu2.numpy(), np.asarray(jres.u)) <= 1e-8


def _files(run_dir):
    npz = {k: dict(np.load(os.path.join(run_dir, k)))
           for k in ("arrays_unscaled.npz", "arrays_scaled.npz")}
    with open(os.path.join(run_dir, "metadata.json")) as fh:
        meta = json.load(fh)
    return sorted(os.listdir(run_dir)), npz, meta


CLIS = {
    "edl_1d": (tcli_edl, jcli_edl, tedl, jedl, "EDL1DProgram",
               ["--L_n", "1e-6", "--n_steps", "2", "--H_OHP", "1.1"]),
    "rxn_diff_1d": (tcli_rd, jcli_rd, trd, jrd, "RxnDiff1DProgram",
                    ["--L_n", "1e-6"]),
}


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_outputs_match_reference(name, tmp_path, monkeypatch):
    """The port's CLI on the CPU, then the reference's CLI with its
    transient replaced by the port's: the same files, npz and metadata
    keys, and values."""
    tcli, jcli, tmod, jmod, prog_cls, argv = CLIS[name]
    if tmod is trd:
        # the reference CLI has no step flag; tests/test_cli.py shortens
        # the run the same way
        orig = tmod.run
        monkeypatch.setattr(tmod, "run", lambda cfg, out_root=None, **kw:
                            orig(cfg, out_root=out_root, n_steps=2, **kw))
    ran = {}
    orig_run = getattr(tmod, prog_cls).run

    def keep(self, *a, **kw):
        ran["out"] = orig_run(self, *a, **kw)
        return ran["out"]

    monkeypatch.setattr(getattr(tmod, prog_cls), "run", keep)
    t_files, t_npz, t_meta = _files(tcli.main(
        [*argv, "--out_root", str(tmp_path / "torch"), "--device", "cpu"])
        ["run_dir"])

    def as_numpy(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        if isinstance(v, tuple):
            return type(v)(*(as_numpy(x) for x in v))
        return v

    port_out = tuple(as_numpy(v) for v in ran["out"])
    monkeypatch.setattr(getattr(jmod, prog_cls), "run",
                        lambda self, *a, **kw: port_out)
    j_files, j_npz, j_meta = _files(jcli.main(
        [*argv, "--out_root", str(tmp_path / "jax")])["run_dir"])

    assert t_files == j_files
    assert set(t_meta) == set(j_meta)
    for k, v in j_meta.items():
        if isinstance(v, float):
            assert t_meta[k] == pytest.approx(v, rel=1e-12, abs=1e-300), k
        else:
            assert t_meta[k] == v, k
    for f in j_npz:
        assert set(t_npz[f]) == set(j_npz[f]), f
        for k, ref in j_npz[f].items():
            assert t_npz[f][k].shape == ref.shape, (f, k)
            assert rel_l2(t_npz[f][k], ref) <= 1e-12, (f, k)
    assert t_meta["all_steps_converged"]
