"""Port vs reference: z-slab domain decomposition (parallel.shard) — the
host plans, the ring seam and BiCGStab, the sharded ``pore_3d.run``,
``--shard`` on both pore CLIs and sharded checkpoint/resume.

The port runs its ranks on the host (``['cpu'] * n_dev``); the reference
runs live only for its host plans (numpy).

Tolerances, each with its reason:
- ZShardPlan and SlabPrecondPlan: bitwise equal (copied numpy code), for
  n_dev 1, 2, 4 on the (2, 10) and (2, 16) meshes and a (2, 10) mesh whose
  vertex order is permuted by a seeded permutation (the plan z-sorts it),
  and for n_dev=4 at L50R5 (the generated L=50 nm, R=5 nm mesh);
- on the reaction-diffusion pore (facet fluxes on the wall and exit
  markers), mesh (2, 10), n_dev=4, full Newton steps (relaxation 1.0, 3
  iterations), Newton and Krylov tol 1e-10: seam='ring' on the permuted
  mesh (the plan's ``perm`` on the solve path) within 1e-7 of the
  replicated seam on the unpermuted one, and BiCGStab + block-Jacobi
  within 1e-7 of the single-device slab_direct step with the same Newton
  count.  (At the GMPNP pore's relaxation 0.9 the exact step takes 11
  iterations of ~460 BiCGStab iterations each, over this file's budget.);
- ``run(cfg, shard=4, device='cpu')`` (GMPNP, (2, 10), 2 exact steps at
  the production Newton tolerance 1e-4): the npz, metadata and VTK key
  sets of the unsharded run, states within 1e-6 (the two linear solvers
  stop at different points inside the Newton tolerance); ``--shard 2
  --device cpu`` on both pore CLIs writes finite outputs of the expected
  shapes; ``run(cfg, shard=1)`` on the default CUDA device refuses;
- sharded checkpoint/resume: bitwise equal to the uninterrupted sharded
  run (exact Newton; the resumed chunk starts from the saved state), and
  the checkpoint resumes a single-device run (within 1e-6).
"""

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu.mesh import cylinder_mesh  # noqa: E402
from gmpnp_tpu.mesh import pore_boundary_markers  # noqa: E402
from gmpnp_tpu.parallel import shard as jshard  # noqa: E402
from gmpnp_tpu_torch import mesh as tmesh  # noqa: E402
from gmpnp_tpu_torch.cli import pore_3d as tcli  # noqa: E402
from gmpnp_tpu_torch.cli import rxn_diff_3d as tcli_rxn  # noqa: E402
from gmpnp_tpu_torch.models import pore_3d as tpore  # noqa: E402
from gmpnp_tpu_torch.parallel import shard as tshard  # noqa: E402
from gmpnp_tpu_torch.solve.timeloop import (  # noqa: E402
    LinearConfig, NewtonConfig, make_implicit_step)
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

TIGHT = 1e-10


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _permuted(mesh, seed=3):
    """The mesh with its vertices renumbered by a seeded permutation."""
    import dataclasses

    perm = np.random.default_rng(seed).permutation(mesh.num_vertices)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return dataclasses.replace(
        mesh, points=mesh.points[perm],
        cells=inv[mesh.cells].astype(mesh.cells.dtype),
        facets=inv[mesh.facets].astype(mesh.facets.dtype)), perm


def _mesh_pair(case):
    L, R, kw = {"2x10": (50e-9, 5e-9, {"n_rings": 2, "n_layers": 10}),
                "2x16": (100e-9, 5e-9, {"n_rings": 2, "n_layers": 16}),
                "perm": (50e-9, 5e-9, {"n_rings": 2, "n_layers": 10}),
                "L50R5": (50e-9, 5e-9, {})}[case]
    jm = pore_boundary_markers(cylinder_mesh(L, R, **kw), L, R)
    tm = tmesh.pore_boundary_markers(tmesh.cylinder_mesh(L, R, **kw), L, R)
    if case == "perm":
        jm, _ = _permuted(jm)
        tm, _ = _permuted(tm)
    return jm, tm


@pytest.mark.parametrize("case,n_dev", [
    (c, n) for c in ("2x10", "2x16", "perm") for n in (1, 2, 4)]
    + [("L50R5", 4)])
def test_plans_bit_identical(case, n_dev):
    jm, tm = _mesh_pair(case)
    N, f = jm.num_vertices, 9
    rng = np.random.default_rng(11)
    mask = rng.random((N, f)) < 0.1
    vals = rng.standard_normal((N, f))
    jp = jshard.ZShardPlan.build(jm, f, n_dev, mask, vals, quad_degree=2)
    tp = tshard.ZShardPlan.build(tm, f, n_dev, mask, vals, quad_degree=2)
    for name in ("n_dev", "n_fields", "N", "N_p", "H"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("cells_l", "vols", "gradN", "Nq", "wq", "bc_mask",
                 "bc_vals", "valid", "perm"):
        _assert_same(getattr(tp, name), getattr(jp, name), name)
    assert (case == "perm") == (not np.array_equal(tp.perm, np.arange(N)))
    assert sorted(tp.facets) == sorted(jp.facets)
    for m in jp.facets:
        for i, (a, b) in enumerate(zip(tp.facets[m], jp.facets[m])):
            _assert_same(a, b, f"facets[{m}][{i}]")
    u = rng.standard_normal((N, f))
    _assert_same(tp.localize(u), jp.localize(u), "localize")
    _assert_same(tp.globalize(tp.localize(u)), u, "globalize")

    for markers in ((), (2, 3)):
        jq = jshard.SlabPrecondPlan.build(jp, facet_markers=markers)
        tq = tshard.SlabPrecondPlan.build(tp, facet_markers=markers)
        for name in ("S", "m_v", "f", "N_p", "h_v", "pad", "facet_markers",
                     "m", "h"):
            assert getattr(tq, name) == getattr(jq, name), name
        for name in ("order", "start", "end", "cover"):
            _assert_same(getattr(tq, name), getattr(jq, name), name)


def test_too_many_devices_refused():
    tm = tmesh.pore_boundary_markers(
        tmesh.cylinder_mesh(50e-9, 5e-9, n_rings=2, n_layers=10),
        50e-9, 5e-9)
    z = np.zeros((tm.num_vertices, 9))
    with pytest.raises(ValueError, match="too many devices"):
        tshard.ZShardPlan.build(tm, 9, 8, z.astype(bool), z)



# the production configuration (Newton rtol = atol = 1e-4) on a small mesh
PRODUCTION = tpore.Pore3DConfig(L=50e-9, mesh_resolution=(2, 10))


def _cfg(physics, relaxation):
    return tpore.Pore3DConfig(
        physics=physics, L=50e-9, mesh_resolution=(2, 10),
        newton=NewtonConfig(max_iter=50, rtol=TIGHT, atol=TIGHT,
                            relaxation=relaxation),
        linear=LinearConfig(kind="slab_direct", tol=TIGHT))


def _theta(prog):
    return {"dt": prog.dt_scaled,
            "co2_s1": prog.eq_conc["CO2"] / prog.bulk_conc["CO2"]}


def _sharded_step(prog, n_dev, mesh=None, perm=None, **kw):
    """One sharded step of ``prog`` from its cold start on n_dev host
    ranks; ``mesh``/``perm``: the same problem on a renumbered mesh
    (vertex i of ``mesh`` is vertex perm[i] of the program's).  Returns
    the state in the program's vertex order and the stats."""
    cfg = prog.config
    theta = _theta(prog)
    bc = prog._bc_of_theta(theta)
    mask, vals = bc.mask.numpy(), bc.values.numpy()
    u0 = prog.initial_state().numpy()
    if perm is not None:
        mask, vals, u0 = mask[perm], vals[perm], u0[perm]
    plan = tshard.ZShardPlan.build(mesh or prog.mesh, cfg.n_fields, n_dev,
                                   mask, vals, quad_degree=cfg.quad_degree)
    step, group = tshard.make_sharded_step(
        plan, prog.form, ["cpu"] * n_dev, newton_max_iter=50,
        newton_rtol=TIGHT, newton_atol=TIGHT,
        relaxation=cfg.newton.relaxation, krylov_tol=TIGHT,
        krylov_maxiter=4000, **kw)
    u0 = group.shard(torch.as_tensor(plan.localize(u0)))
    u, stats = step(u0, u0, theta)
    u = plan.globalize(group.unshard(u).numpy())
    if perm is not None:
        out = np.empty_like(u)
        out[perm] = u
        u = out
    return u, stats


@pytest.fixture(scope="module")
def rxn():
    """The reaction-diffusion pore with full Newton steps and its
    replicated-seam sharded step at n_dev=4."""
    prog = tpore.build(_cfg("rxn_diff", relaxation=1.0), device="cpu")
    return prog, _sharded_step(prog, 4)


def test_ring_seam_on_permuted_mesh_matches_replicated(rxn):
    prog, (u_rep, st_rep) = rxn
    mesh, perm = _permuted(prog.mesh)
    u_ring, st_ring = _sharded_step(prog, 4, mesh=mesh, perm=perm,
                                    seam="ring")
    assert st_rep[1] and st_ring[1]
    assert st_ring[0] == st_rep[0]
    assert rel_l2(u_ring, u_rep) < 1e-7


def test_bicgstab_jacobi_matches_single_device_step(rxn):
    prog, _ = rxn
    theta = _theta(prog)
    bc = prog._bc_of_theta(theta)
    step1 = make_implicit_step(prog.space, prog.form, prog.config.newton,
                               prog.config.linear, bc_of_theta=lambda th: bc)
    u_ref, st_ref = step1(prog.initial_state(), theta)
    u, (iters, conv, rn, lin) = _sharded_step(prog, 4,
                                              linear="bicgstab_jacobi")
    assert conv and st_ref.converged and iters == st_ref.newton_iters
    assert rel_l2(u, u_ref.numpy()) < 1e-7



@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    return tpore.run(PRODUCTION, out_root=out, n_steps=2, shard=4,
                     device="cpu")


def _keys(run_dir):
    files = sorted(os.listdir(run_dir))
    with np.load(os.path.join(run_dir, "arrays_unscaled.npz")) as z:
        unscaled = sorted(z.files)
    with np.load(os.path.join(run_dir, "arrays_scaled.npz")) as z:
        scaled = sorted(z.files)
    with open(os.path.join(run_dir, "metadata.json")) as fh:
        meta = sorted(json.load(fh))
    return files, unscaled, scaled, meta


def test_run_sharded_writes_the_unsharded_artifacts(sharded_run, tmp_path):
    single = tpore.run(PRODUCTION, out_root=str(tmp_path), n_steps=2,
                       device="cpu")
    assert _keys(sharded_run["run_dir"]) == _keys(single["run_dir"])
    assert sharded_run["metadata"]["all_steps_converged"]
    for nm, a in single["unscaled"].items():
        assert rel_l2(sharded_run["unscaled"][nm][-1], a[-1]) < 1e-6, nm


def test_run_sharded_refuses_missing_cuda_devices():
    with pytest.raises(ValueError, match="devices"):
        tpore.run(PRODUCTION, write=False, n_steps=1, shard=1)


@pytest.mark.parametrize("cli", [tcli, tcli_rxn])
def test_cli_shard_on_the_host(cli, tmp_path):
    res = cli.main(["--L", "50e-9", "--mesh_resolution", "2", "6",
                    "--n_steps", "1", "--shard", "2", "--device", "cpu",
                    "--out_root", str(tmp_path)])
    with np.load(os.path.join(res["run_dir"], "arrays_unscaled.npz")) as z:
        assert z["H"].shape == (2, res["coor_array"].shape[0])
        assert all(np.isfinite(z[k]).all() for k in z.files)
    assert res["metadata"]["all_steps_converged"]


def test_sharded_checkpoint_resume(sharded_run, tmp_path):
    ck = str(tmp_path / "ck")
    cfg = PRODUCTION
    tpore.run(cfg, write=False, n_steps=1, shard=4, device="cpu",
              checkpoint_dir=ck, checkpoint_every=1)
    ck1 = str(tmp_path / "ck1")
    shutil.copytree(ck, ck1)
    res = tpore.run(cfg, write=False, n_steps=2, shard=4, device="cpu",
                    checkpoint_dir=ck, checkpoint_every=1)
    assert res["stats"].newton_iters.shape == (1,)
    for nm, a in sharded_run["unscaled"].items():
        np.testing.assert_array_equal(res["unscaled"][nm][-1], a[-1])
    # the checkpoint holds the global vertex-order state: a single-device
    # run resumes from it
    single = tpore.run(cfg, write=False, n_steps=2, device="cpu",
                       checkpoint_dir=ck1, checkpoint_every=1)
    assert single["stats"].newton_iters.shape == (1,)
    for nm, a in sharded_run["unscaled"].items():
        assert rel_l2(single["unscaled"][nm][-1], a[-1]) < 1e-6, nm
