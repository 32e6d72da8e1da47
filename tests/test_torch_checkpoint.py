"""Checkpoint/resume of the port (io.checkpoint and the models'
``checkpoint_dir``), held to the reference's contract.

- the reference's toy transient (tests/test_utils_io.py::
  test_checkpoint_resume) through both packages: equal results;
- pore exact runs on the (2, 10) mesh: checkpointed in chunks, and killed
  and resumed, bitwise equal to the unchunked run (exact Newton on the CPU
  is deterministic);
- a carried pore resume rebuilds the slab factorization at the resume
  step (checked), so its chord path differs from the uninterrupted run's
  and it stops at another point inside the Newton tolerance: every step
  converged and the final state's residual is under the Newton atol 1e-4.
  The distance to the uninterrupted carried run is the carried mode's own
  distance to exact Newton (1.8088e-4 / 1.8082e-4 here; the reference
  gives 1.8085e-4 / 1.8086e-4 on the same mesh), so it is printed, not
  held to a bar;
- an EDL resume (L_n = 1 um, H_OHP controller on): bitwise equal, the
  proton-current fraction carried through the checkpoint;
- a run resumed at its final step returns one history record and stats
  None; the CLI writes its outputs and the step-numbered checkpoints.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.io.checkpoint import (  # noqa: E402
    TransientCheckpointer,
    config_hash,
    run_transient_checkpointed,
)
from gmpnp_tpu_torch.models import edl_1d, pore_3d  # noqa: E402
from gmpnp_tpu_torch.testing import rel_l2  # noqa: E402

RES = (2, 10)


def _toy_step(u, theta):
    return u + 1.0, {"it": torch.tensor(1)}


def test_toy_checkpoint_resume_matches_reference(tmp_path):
    import jax.numpy as jnp
    from gmpnp_tpu.io import checkpoint as jck

    # the reference's run
    def jstep(u, theta):
        return u + 1.0, {"it": jnp.asarray(1)}

    jc = jck.TransientCheckpointer(str(tmp_path / "ref"), cfg={"model": "toy"})
    (ju, jx), _ = jck.run_transient_checkpointed(
        jstep, (jnp.zeros((4, 2)), jnp.asarray(0.0)), 10, jc, chunk=4)
    jc.close()

    carry0 = (torch.zeros((4, 2), dtype=torch.float64), 0.0)
    ck = TransientCheckpointer(str(tmp_path / "ck"), cfg={"model": "toy"})
    (u, x), ys = run_transient_checkpointed(_toy_step, carry0, 10, ck,
                                            chunk=4)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    assert ck.steps() == [4, 8, 10]
    assert ys[0].shape == (10, 4, 2)
    assert config_hash({"model": "toy"}) == jck.config_hash({"model": "toy"})

    # resume: the latest checkpoint is at step 10 -> nothing to do
    ck2 = TransientCheckpointer(str(tmp_path / "ck"), cfg={"model": "toy"})
    carry2, ys2 = run_transient_checkpointed(_toy_step, carry0, 10, ck2,
                                             chunk=4)
    assert ys2 is None
    np.testing.assert_allclose(carry2[0].numpy(), 10.0)
    # extend the run: resumes from 10, adds 5 more
    carry3, ys3 = run_transient_checkpointed(_toy_step, carry0, 15, ck2,
                                             chunk=4)
    np.testing.assert_allclose(carry3[0].numpy(), 15.0)
    assert ys3[0].shape == (5, 4, 2)
    # an interrupted save leaves only a temporary directory: ignored
    os.makedirs(os.path.join(ck2.dir, ".tmp-99-1"))
    assert ck2.latest()[0] == 15
    # a config change is rejected
    ck3 = TransientCheckpointer(str(tmp_path / "ck"), cfg={"model": "other"})
    with pytest.raises(ValueError):
        run_transient_checkpointed(_toy_step, carry0, 10, ck3, chunk=4)


def _pore(refresh="iter"):
    cfg = pore_3d.Pore3DConfig(mesh_resolution=RES)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh=refresh))
    return pore_3d.build(cfg, device="cpu")


@pytest.fixture(scope="module")
def exact_run():
    """The unchunked 4-step exact run."""
    return _pore().run(n_steps=4)


def test_pore_exact_chunked_and_resumed_bitwise(exact_run, tmp_path):
    _, u_hist, stats, u_final = exact_run
    prog = _pore()
    _, h1, s1, u1 = prog.run(n_steps=4, checkpoint_dir=str(tmp_path / "a"),
                             checkpoint_every=2)
    assert torch.equal(u1, u_final) and torch.equal(h1, u_hist)
    np.testing.assert_array_equal(s1.newton_iters, stats.newton_iters)

    # killed after 2 steps, resumed to 4: only steps 2-3 run again
    d = str(tmp_path / "b")
    prog.run(n_steps=2, checkpoint_dir=d, checkpoint_every=2)
    _, h2, s2, u2 = prog.run(n_steps=4, checkpoint_dir=d, checkpoint_every=2)
    assert h2.shape[0] == 2 and len(s2.newton_iters) == 2
    assert torch.equal(u2, u_final)
    np.testing.assert_array_equal(s2.newton_iters, stats.newton_iters[2:])

    # resumed at the final step: one history record, no stats
    u0, h3, s3, u3 = prog.run(n_steps=4, checkpoint_dir=d,
                              checkpoint_every=2)
    assert s3 is None and h3.shape == (1,) + tuple(u_final.shape)
    assert torch.equal(u3, u_final) and torch.equal(h3[0], u_final)


def test_pore_carried_resume_rebuilds_factorization(tmp_path, exact_run):
    prog = _pore("carried")
    _, _, stats, u_ref = prog.run(n_steps=4)
    d = str(tmp_path / "c")
    prog.run(n_steps=2, checkpoint_dir=d, checkpoint_every=2)
    # the resume builds the factorization at step 2 from the checkpointed
    # state (step_state_init), instead of carrying the old one
    calls = []
    import gmpnp_tpu_torch.models.pore_3d as mod

    orig = mod.run_transient_checkpointed

    def spy(*a, **kw):
        init = kw["step_state_init"]

        def counted(carry, i):
            calls.append(i)
            return init(carry, i)
        kw["step_state_init"] = counted
        return orig(*a, **kw)

    mod.run_transient_checkpointed = spy
    try:
        _, h2, s2, u2 = prog.run(n_steps=4, checkpoint_dir=d,
                                 checkpoint_every=2)
    finally:
        mod.run_transient_checkpointed = orig
    assert calls == [2]
    assert bool(np.all(s2.converged)) and bool(np.all(stats.converged))
    # the last step's residual at the resumed final state
    theta = prog._theta_of_carry((h2[0], 0.0), 3)
    bc = prog._bc_of_theta(theta)
    r = bc.apply_to_residual(
        prog.space.residual(prog.form, u2, h2[0], theta), u2)
    assert float(r.norm()) < prog.config.newton.atol
    print(f"carried resume: {rel_l2(u2.numpy(), u_ref.numpy()):.4e} from "
          f"the uninterrupted carried run, which is "
          f"{rel_l2(u_ref.numpy(), exact_run[3].numpy()):.4e} from exact")


def test_edl_resume_carries_the_controller(tmp_path):
    cfg = edl_1d.EDL1DConfig(L_n=1e-6, H_OHP=1.1)
    prog = edl_1d.build(cfg, device="cpu")
    _, h_ref, stats, chf = prog.run(n_steps=4)
    d = str(tmp_path / "e")
    _, _, _, chf2 = prog.run(n_steps=2, checkpoint_dir=d,
                             checkpoint_every=1)
    ck = TransientCheckpointer(d, cfg=cfg)
    assert ck.steps() == [1, 2] and ck.latest()[1][1] == chf2
    _, h, s, chf4 = prog.run(n_steps=4, checkpoint_dir=d,
                             checkpoint_every=1)
    assert chf4 == chf and chf != 0.001
    assert torch.equal(h[-1], h_ref[-1])
    np.testing.assert_array_equal(s.newton_iters, stats.newton_iters[2:])


def test_cli_with_checkpoint_dir(tmp_path):
    from gmpnp_tpu_torch.cli import pore_3d as cli

    d = str(tmp_path / "ck")
    argv = ["--mesh_resolution", *map(str, RES), "--n_steps", "2",
            "--checkpoint_dir", d, "--checkpoint_every", "1",
            "--out_root", str(tmp_path / "out"), "--device", "cpu"]
    res = cli.main(argv)
    assert sorted(os.listdir(d)) == ["1", "2"]
    for step in ("1", "2"):
        assert sorted(os.listdir(os.path.join(d, step))) == [
            "carry.pt", "meta.json"]
        with open(os.path.join(d, step, "meta.json")) as fh:
            assert json.load(fh)["step"] == int(step)
    with open(os.path.join(res["run_dir"], "metadata.json")) as fh:
        meta = json.load(fh)
    assert not meta["resumed_complete"] and meta["all_steps_converged"]
    with np.load(os.path.join(res["run_dir"], "arrays_unscaled.npz")) as z:
        assert z["H"].shape == (3, res["coor_array"].shape[0])
    # rerun: resumed at the final step, the finished run's outputs again
    res2 = cli.main(argv[:-4] + ["--out_root", str(tmp_path / "out2"),
                                 "--device", "cpu"])
    assert res2["metadata"]["resumed_complete"]
    assert sorted(os.listdir(res2["run_dir"])) == sorted(
        os.listdir(res["run_dir"]))
    np.testing.assert_array_equal(res2["unscaled"]["H"][-1],
                                  res["unscaled"]["H"][-1])
