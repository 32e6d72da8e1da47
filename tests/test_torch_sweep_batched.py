"""Port vs reference: batched sweep lanes (the reference's ``chunk`` vmap
modes) — a lane-batched Newton, CR solve, GMRES and slab solve over a
leading lane axis.

The reference's vmapped sweeps are read from
``goldens/torch_sweeps_batched.json`` (their XLA compiles take minutes on
one CPU core); ``python tests/test_torch_sweep_batched.py`` rewrites that
file from ``gmpnp_tpu``.  The pore's batched reference is ``pore_chunk2``
of ``goldens/torch_sweeps.json``.

Tolerances, each with its reason:
- each batched lane against the reference's vmapped lane: rtol = atol =
  1e-7 with Newton counts within 1 (tests/test_parallel.py's bar between
  the reference's own vmap and chunk modes);
- each batched lane against the port's ``chunk=0`` run of the same lane:
  1e-10 with the same Newton counts (the same arithmetic; batched matrix
  products may round differently from single ones);
- the lane-axis plain twin of the block-ELL product against V single-lane
  calls: exactly equal;
- the lane versions of the CR solve, GMRES, the slab solve and the
  Dirichlet blends against the single-lane functions: 1e-13 (batched
  products round differently) or exactly equal where the arithmetic is
  elementwise;
- host reads per Newton iteration: equal for one lane and for three
  copies of it (the batched loop reads (V,) norms once, never per lane),
  under the Krylov kinds too (one (V,) read per Krylov iteration);
- the batched direct kinds (1D block-Thomas, the slab's cyclic reduction,
  the dense solve) and ``tridiag_mp_solve`` over lanes against chunk=0:
  1e-10 with the same Newton counts.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from gmpnp_tpu_torch.models import edl_1d, pore_3d  # noqa: E402
from gmpnp_tpu_torch.parallel import sweep  # noqa: E402
from gmpnp_tpu_torch.solve import timeloop  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "goldens", "torch_sweeps_batched.json")
SWEEP_GOLDEN = os.path.join(HERE, "goldens", "torch_sweeps.json")
EDL_VOLTS = [-0.5, -1.0, -2.0]
PORE_VOLTS = [-0.5, -1.5]


def _pore_cfg():
    """The (2, 8) pore at tight tolerances, as ``pore_chunk2`` of
    goldens/torch_sweeps.json was written (tests/test_torch_sweep.py)."""
    return pore_3d.Pore3DConfig(
        mesh_resolution=(2, 8),
        newton=timeloop.NewtonConfig(max_iter=50, rtol=1e-11, atol=1e-11,
                                     relaxation=0.9),
        linear=timeloop.LinearConfig(kind="slab_direct", tol=1e-12,
                                     refresh="carried"))


def write_golden():
    from gmpnp_tpu.models import edl_1d as jedl
    from gmpnp_tpu.parallel import sweep as jsweep

    def record(u, st):
        u = np.asarray(u)
        return {"final": u[:, -1].tolist(),
                "newton_iters": np.asarray(st.newton_iters).tolist(),
                "converged": np.asarray(st.converged).tolist()}

    out = {}
    for chunk in (3, 2):
        out[f"edl_chunk{chunk}"] = record(*jsweep.run_edl_voltage_sweep(
            jedl.EDL1DConfig(L_n=1e-6), EDL_VOLTS, n_steps=3, chunk=chunk))
    with open(GOLDEN, "w") as fh:
        json.dump(out, fh)


def _golden(key, path=GOLDEN):
    with open(path) as fh:
        return json.load(fh)[key]


@pytest.fixture(scope="module")
def edl_seq():
    """The port's EDL lanes one at a time (``chunk=0``)."""
    return sweep.run_edl_voltage_sweep(
        edl_1d.EDL1DConfig(L_n=1e-6), EDL_VOLTS, n_steps=3, chunk=0,
        device="cpu")


def _hold(u, stats, ref, u_seq, st_seq):
    """Each batched lane against the reference's vmapped lane (1e-7,
    Newton within 1) and the port's chunk=0 lane (1e-10, same Newton)."""
    np.testing.assert_allclose(u[:, -1].numpy(), np.asarray(ref["final"]),
                               rtol=1e-7, atol=1e-7)
    assert (np.abs(stats.newton_iters - np.asarray(ref["newton_iters"]))
            <= 1).all()
    np.testing.assert_array_equal(stats.converged, ref["converged"])
    np.testing.assert_allclose(u.numpy(), u_seq.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(stats.newton_iters, st_seq.newton_iters)
    np.testing.assert_array_equal(stats.converged, st_seq.converged)


@pytest.mark.parametrize("chunk", [3, 2])
def test_edl_batched_lanes_match_reference_and_chunk0(edl_seq, chunk):
    """chunk=3: one batch of all lanes (the reference's vmap); chunk=2:
    batches of two, the third lane padded with its own voltage and the pad
    dropped (the reference's map of vmap)."""
    info = {}
    u, stats = sweep.run_edl_voltage_sweep(
        edl_1d.EDL1DConfig(L_n=1e-6), EDL_VOLTS, n_steps=3, chunk=chunk,
        device="cpu", info=info)
    assert info == {"chunk": chunk, "refresh": "iter"}
    assert u.shape == (3, 3, 1091, 7)
    assert stats.newton_iters.shape == (3, 3)
    _hold(u, stats, _golden(f"edl_chunk{chunk}"), *edl_seq)


def test_pore_batched_lanes_match_reference_and_chunk0():
    """The (2, 8) pore, carried config downgraded to refresh='step' under
    chunk=2 as in the reference, both lanes in one batch; the -1.5 V
    lane's cold step spends its 50 iterations unconverged in both
    packages and is frozen there while the batch goes on."""
    info = {}
    u, stats = sweep.run_pore_voltage_sweep(
        _pore_cfg(), PORE_VOLTS, n_steps=2, chunk=2, device="cpu", info=info)
    assert info == {"chunk": 2, "refresh": "step"}
    cfg_step = _pore_cfg()
    cfg_step = dataclasses.replace(cfg_step, linear=dataclasses.replace(
        cfg_step.linear, refresh="step"))
    u_seq, st_seq = sweep.run_pore_voltage_sweep(
        cfg_step, PORE_VOLTS, n_steps=2, chunk=0, device="cpu")
    _hold(u, stats, _golden("pore_chunk2", SWEEP_GOLDEN), u_seq, st_seq)


def test_host_reads_per_newton_iteration_do_not_grow_with_lanes():
    """Three copies of one lane take the same host reads as the lane
    alone: one (V,) read of residual norms per Newton iteration (the
    batched CR solve reads nothing)."""
    from gmpnp_tpu_torch import sync

    cfg = edl_1d.EDL1DConfig(L_n=1e-6)
    reads = {}
    for V in (1, 3):
        r0 = sync.READS
        u, stats = sweep.run_edl_voltage_sweep(cfg, [-1.0] * V, n_steps=2,
                                               chunk=V, device="cpu")
        reads[V] = (sync.READS - r0, int(stats.newton_iters[0].sum()))
        assert (stats.newton_iters == stats.newton_iters[0]).all()
    assert reads[3] == reads[1]
    n_reads, newton = reads[1]
    assert n_reads <= 2 * newton + 2     # per step: n0, one per iteration


def test_carried_edl_keeps_lanes_one_at_a_time(monkeypatch):
    """A carried EDL configuration under chunk != 0 runs its lanes one at
    a time (a departure kept on purpose: the reference raises; ROADMAP
    queue 3 item 8), so no lane-batched step is built."""
    def refuse(*a, **k):
        raise AssertionError("a carried EDL sweep built a batched step")

    monkeypatch.setattr(sweep, "make_implicit_step_lanes", refuse)
    cfg = edl_1d.EDL1DConfig(L_n=1e-6)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, refresh="carried"))
    info = {}
    u, stats = sweep.run_edl_voltage_sweep(cfg, EDL_VOLTS[:2], n_steps=1,
                                           chunk=2, device="cpu", info=info)
    assert info == {"chunk": 2, "refresh": "carried"}
    assert stats.converged.all() and u.shape == (2, 1, 1091, 7)


def test_batched_lanes_of_a_kind_without_lane_solver():
    """The EDL's mixed-precision ``tridiag_mp_solve`` (a kind that once ran
    each lane's own single-lane solver inside the batched Newton) runs as
    one lane-batched solve, ``solve.linear.tridiag_mp_solve_lanes``: the
    f32 CR factor and apply of every lane at once under GMRES over the
    lanes.  On the CPU each lane takes its single-lane arithmetic, so the
    lanes equal their chunk=0 runs to the last digits, Krylov counts
    included."""
    cfg = edl_1d.EDL1DConfig(L_n=1e-6)
    cfg = dataclasses.replace(cfg, linear=dataclasses.replace(
        cfg.linear, solve_dtype="f32", tol=1e-10))
    u, stats = sweep.run_edl_voltage_sweep(cfg, EDL_VOLTS[1:], n_steps=1,
                                           chunk=2, device="cpu")
    u0, st0 = sweep.run_edl_voltage_sweep(cfg, EDL_VOLTS[1:], n_steps=1,
                                          chunk=0, device="cpu")
    np.testing.assert_allclose(u.numpy(), u0.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(stats.newton_iters, st0.newton_iters)
    np.testing.assert_array_equal(stats.linear_iters, st0.linear_iters)
    assert stats.converged.all() and (stats.linear_iters > 0).all()


def _with_linear(cfg, **kw):
    return dataclasses.replace(cfg, linear=dataclasses.replace(cfg.linear,
                                                               **kw))


#: direct kinds of the batched sweeps: (model, LinearConfig fields, lanes)
DIRECT_KINDS = {
    "edl tridiag_thomas": ("edl", dict(kind="tridiag_thomas"),
                           EDL_VOLTS[:2]),
    "pore slab cr": ("pore", dict(slab_mode="cr", refresh="step"),
                     [-0.5, -1.0]),
    "pore dense": ("pore", dict(kind="dense"), [-0.5, -1.0]),
}


@pytest.mark.parametrize("kind", list(DIRECT_KINDS))
def test_batched_direct_kinds_match_chunk0(kind):
    """The 1D block-Thomas solve, the slab solver's cyclic reduction and
    the dense solve over lanes, one cold-start step each: every lane
    within 1e-10 of its chunk=0 run with the same Newton counts and flags
    (f64 direct solves; on the CPU each lane takes its single-lane
    arithmetic but for the batched small products of block-Thomas and the
    batched dense LU)."""
    model, kw, volts = DIRECT_KINDS[kind]
    if model == "edl":
        cfg, run = _with_linear(edl_1d.EDL1DConfig(L_n=1e-6), **kw), \
            sweep.run_edl_voltage_sweep
    else:
        cfg, run = _with_linear(pore_3d.Pore3DConfig(
            mesh_resolution=(2, 8)), **kw), sweep.run_pore_voltage_sweep
    u, st = run(cfg, volts, n_steps=1, chunk=len(volts), device="cpu")
    u0, st0 = run(cfg, volts, n_steps=1, chunk=0, device="cpu")
    np.testing.assert_allclose(u.numpy(), u0.numpy(), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_array_equal(st.newton_iters, st0.newton_iters)
    np.testing.assert_array_equal(st.converged, st0.converged)
    assert st.converged.all()


@pytest.mark.parametrize("kind", ["edl tridiag_mp_solve",
                                  "pore gmres amg"])
def test_host_reads_of_batched_krylov_kinds_do_not_grow_with_lanes(kind):
    """Three copies of one lane take the host reads of the lane alone
    under the Krylov kinds too: one (V,) read per Krylov iteration (the
    Hessenberg columns of GMRES) and per Newton iteration, never one per
    lane (BiCGStab's one predicate read per iteration: test_torch_lanes.py)."""
    from gmpnp_tpu_torch import sync

    if kind.startswith("edl"):
        cfg = _with_linear(edl_1d.EDL1DConfig(L_n=1e-6), solve_dtype="f32")
        run = sweep.run_edl_voltage_sweep
    else:
        cfg = _with_linear(pore_3d.Pore3DConfig(mesh_resolution=(2, 8)),
                           kind="gmres", precond="amg", tol=1e-6,
                           maxiter=300)
        run = sweep.run_pore_voltage_sweep
    reads = {}
    for V in (1, 3):
        r0 = sync.READS
        u, stats = run(cfg, [-1.0] * V, n_steps=1, chunk=V, device="cpu")
        reads[V] = sync.READS - r0
        assert (stats.newton_iters == stats.newton_iters[0]).all()
        assert (stats.linear_iters == stats.linear_iters[0]).all()
        assert stats.converged.all() and (stats.linear_iters > 0).all()
    assert reads[3] == reads[1]
    assert reads[1] > int(stats.linear_iters[0].sum())


def test_run_lanes_modes():
    """The reference's three modes: one batch (chunk >= lanes), batches of
    chunk padded with the last voltage and the pad dropped, and one lane
    at a time (chunk 0 or 1)."""
    calls = []

    def single(v):
        calls.append(("single", v))
        return (torch.full((1, 2), v),
                timeloop.StepStats(*([np.asarray([1])] * 5)))

    def batched(vs):
        calls.append(("batched", tuple(vs)))
        return (torch.as_tensor(vs)[:, None, None].expand(len(vs), 1, 2),
                timeloop.StepStats(*([np.ones((len(vs), 1))] * 5)))

    volts = [-0.5, -1.0, -2.0]
    for chunk, want in [
            (3, [("batched", (-0.5, -1.0, -2.0))]),
            (8, [("batched", (-0.5, -1.0, -2.0))]),
            (2, [("batched", (-0.5, -1.0)), ("batched", (-2.0, -2.0))]),
            (1, [("single", v) for v in volts]),
            (0, [("single", v) for v in volts])]:
        calls.clear()
        u, st = sweep._run_lanes(single, batched, volts, chunk, "cpu")
        assert calls == want
        assert u.shape == (3, 1, 2) and st.newton_iters.shape == (3, 1)
        assert u[:, 0, 0].tolist() == volts


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    write_golden()
    print(f"wrote {GOLDEN}")
