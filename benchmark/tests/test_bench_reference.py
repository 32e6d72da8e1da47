"""The plain reference against the program at small sizes on the CPU: the
same meshes, Dirichlet rows and residuals, and every cell judged correct
on a small episode of its own driver."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.reference import check, fem, transport
from benchmark.tests.small import SMALL, manifest, run_small

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name, **program):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg["program"].update(program)
    return cfg


def program(name, volt):
    from gmpnp_tpu_torch.models import edl_1d, pore_3d

    if name == "pore":
        return pore_3d.build(pore_3d.Pore3DConfig(
            L=5e-8, R=5e-9, mesh_resolution=(2, 10),
            voltage_multiplier=volt), device="cpu")
    return edl_1d.build(edl_1d.EDL1DConfig(L_n=1e-6, voltage_multiplier=volt),
                        device="cpu")


CASES = {"pore": ("pore_gmpnp_L50R5", {"mesh_resolution": [2, 10]}, -0.8),
         "edl": ("edl_mpnp_50um", {"L_n": 1e-6}, -1.3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_residual_matches_program(case):
    torch.set_num_threads(1)
    name, over, volt = CASES[case]
    cfg = config(name, **over)
    prog = program(case, volt)
    u0, hist, stats, *_ = prog.run(n_steps=2)
    pb = transport.problem(cfg, volt, "cpu")
    assert np.array_equal(pb.points, prog.mesh.points)
    assert np.array_equal(pb.cells, prog.mesh.cells)
    space = fem.P1Space(pb.points, pb.cells, cfg["program"]["quad_degree"],
                        "cpu", torch.float64)
    for i, (up, un) in enumerate(((u0, hist[0]), (hist[0], hist[1]))):
        th_p = prog._theta_of_carry((up, 0.0), i)
        bc = (prog._bc_of_theta(th_p) if hasattr(prog, "_bc_of_theta")
              else prog.bc)
        th_r = pb.theta(up, i)
        mask, values = pb.dirichlet(th_r)
        assert torch.equal(mask, bc.mask)
        assert torch.allclose(torch.where(mask, values, 0.0),
                              torch.where(bc.mask, bc.values, 0.0),
                              rtol=1e-14, atol=0.0)
        r_p = bc.apply_to_residual(
            prog.space.residual(prog.form, un, up, th_p), un)
        r_r = space.residual(pb, un, up, th_r)
        # the same residual up to the rounding of its cancellations: far
        # inside the Newton bound the step is held to
        r, bound = check.step_measures(space, pb, up, un, i, cfg["guarantee"])
        assert float(fem.l2(r_p - r_r)) <= 1e-5 * bound
        assert r / bound < 1.0
        assert abs(r - float(stats.residual_norm[i])) <= 1e-6 * bound


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_cell_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    # every end-to-end metric of the cell that the host's clock reads (the
    # device's need a card)
    host = {m["name"] for m in manifest()["end_to_end"]
            if cell in m.get("workloads", [cell])
            and m["source"] == "host_clock"}
    assert "setup_s" in host and len(host) >= (1 if "carried" in cell else 3)
    assert set(res["metrics"]) == host
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_small_cell_traced(cell):
    """A traced run is judged like any other and reports the cell's
    per-layer metrics, each read from the window, the spanned round or
    the profiled episode (on the CPU the profiler records the host)."""
    res = run_small(cell, trace=1)
    assert res["correct"], res["checks"]
    layer = {m["name"] for m in manifest()["per_layer"]
             if cell in m.get("workloads", [cell])}
    got = set(res["metrics"])
    assert got <= layer
    base = {n.split(".")[0] for n in got}
    assert {"newton_per_step", "host_syncs_per_step",
            "assembly_ms_per_step", "linear_ms_per_step"} <= base
    if "carried" in cell:
        assert {"lane_steps_per_s", "cold_start_ms", "step_ms_p95"} <= base
    assert "busy_s" in res["device"] and "breakdown" in res
