"""The reaction-diffusion pore cell, ``rxndiff_pore.carried50``, at a small
size on the CPU (the (2, 10) generated mesh, N = 209; 3 steps an episode;
the carried chord path with dt cuts as the cell runs it), the reference's
boundary integrals against the mesh's own areas, and the float32 control
at the cell's own size on the card:

    python -m pytest benchmark/tests/test_bench_rxndiff_carried.py -m cuda -s -p no:cacheprovider

The control's dense Newton (``reference.fem``) takes the boundary fluxes
as constants, so its Jacobian lacks the exit term's derivative (the wall
flux has none): a departure of the control alone, which the judge, a
residual evaluation, does not share.
"""

import json
import math
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness.program import program_config
from benchmark.reference import check, fem, transport
from benchmark.reference.models import rxndiff_pore
from benchmark.tests import test_bench_faults
from benchmark.tests.small import SEED, STEP_FACTORIES
from benchmark.tests.test_bench_control import (
    CARD_SEEDS, CONTROL_MAX_ITER, CONTROL_STEPS, fails)

CELL = "rxndiff_pore.carried50"
SMALL_MESH = [2, 10]
OVERRIDES = {"program": {"mesh_resolution": SMALL_MESH},
             "workload": {"run": {"n_steps": 3, "record_full": False}}}

#: the per-layer metrics a traced run on the CPU has something to read for:
#: no roofline, since the CPU launches no kernel (the idle share reads 100)
CPU_READABLE = {"newton_per_step", "host_syncs_per_step",
                "assembly_ms_per_step", "linear_ms_per_step",
                "krylov_per_step", "device_idle", "lane_steps_per_s",
                "cold_start_ms", "step_ms_p95"}
#: the rooflines the cell lists; segsum_roofline is not one: the harness's
#: reader wants a record of every launch, and the profiler drops those of
#: the episode's last millisecond, which holds the last segment sums
ROOFLINES = {"spmv_roofline", "block_inv_roofline", "residual_roofline"}


def cell_files(small=True):
    wl = run.load_json("benchmark", "workloads", f"{CELL}.json")
    cfg = run.load_json("benchmark", "configs", f"{wl['config']}.json")
    if small:
        cfg["program"]["mesh_resolution"] = SMALL_MESH
    return cfg, wl


def run_carried(trace=0, overrides=OVERRIDES):
    from gmpnp_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    before = dict(profiling.COUNTS)
    res = run.run_cell(run.load_json("BENCHMARK.json"), CELL, SEED, 0.01,
                       trace, "cpu", overrides)
    counts = {k: v - before.get(k, 0) for k, v in profiling.COUNTS.items()
              if v != before.get(k, 0)}
    return res, counts


def test_carried_cell_correct():
    """Correct, every step converged, on the chord path (one factor from
    cold, chord iterations against it)."""
    res, counts = run_carried()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert counts.get("factors.init", 0) > 0 and "factors.iter" not in counts
    # the host-clock end-to-end metrics of the cell (device_ms_per_step
    # needs a card)
    assert set(res["metrics"]) == {"setup_s"}


def test_carried_cell_traced():
    res, _ = run_carried(trace=1)
    assert res["correct"], res["checks"]
    rxn = {m["name"] for m in run.load_json("BENCHMARK.json")["per_layer"]
           if CELL in m.get("workloads", ())}
    assert rxn == {f"{b}.rxn" for b in CPU_READABLE | ROOFLINES}
    assert set(res["metrics"]) == {f"{b}.rxn" for b in CPU_READABLE}


def test_wall_flux_dropped_is_not_correct():
    """The program run without its wall flux (no current on the
    electrode) while the reference keeps it."""
    ov = json.loads(json.dumps(OVERRIDES))
    ov["program"]["current_rough"] = 0.0
    res, _ = run_carried(overrides=ov)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ("unchanged", "altered"))
def test_fault_is_not_correct(monkeypatch, kind):
    """A step from ``models.pore_3d``'s step factories broken below the
    harness, as ``test_bench_faults.py`` plants it."""
    torch.manual_seed(0)
    monkeypatch.setitem(STEP_FACTORIES, CELL,
                        STEP_FACTORIES["pore_gmpnp.carried_schedule"])
    test_bench_faults.plant(monkeypatch, CELL, kind)
    res, _ = run_carried()
    assert not res["correct"], res["checks"]


@pytest.fixture(scope="module")
def small_run():
    """The program and the reference at the small size, and the states of
    a two-step program run from cold."""
    torch.set_num_threads(1)
    cfg, wl = cell_files()
    module, pcfg = program_config(cfg, wl, wl["voltages"][0])
    prog = module.build(pcfg, device="cpu")
    pb = transport.problem(cfg, wl["voltages"][0], "cpu")
    space = fem.P1Space(pb.points, pb.cells, cfg["program"]["quad_degree"],
                        "cpu", torch.float64)
    u0, hist, _, _ = prog.run(n_steps=2)
    states = [(u0, hist[0]), (hist[0], hist[1])]
    return cfg, prog, pb, space, states


@pytest.mark.parametrize("k", range(2))
def test_reference_residual_matches_program(small_run, k):
    """The program's Dirichlet-applied residual against the reference's at
    the states of the program's first two steps, boundary facets
    included: the same residual up to rounding, far inside the step's
    Newton bound, where the facet terms alone move it well outside."""
    cfg, prog, pb, space, states = small_run
    up, un = states[k]
    th_p = prog._theta_of_carry((up, 0.0), k)
    bc = prog._bc_of_theta(th_p)
    r_p = bc.apply_to_residual(
        prog.space.residual(prog.form, un, up, th_p), un)
    th_r = pb.theta(up, k)
    r_r = space.residual(pb, un, up, th_r)
    _, bound = check.step_measures(space, pb, up, un, k, cfg["guarantee"])
    assert float(fem.l2(r_p - r_r)) <= 1e-5 * bound
    mask, _ = pb.dirichlet(th_r)
    facets = pb.add_fluxes(torch.zeros_like(un), un, th_r)
    assert float(fem.l2(torch.where(mask, 0.0, facets))) > 1e-3 * bound


def polygon(n_rings, aspect):
    """(perimeter, area) of the generated disc's outer polygon: 6 n points
    evenly on the circle of radius R/L."""
    m = 6 * n_rings
    return (2 * m * aspect * math.sin(math.pi / m),
            0.5 * m * aspect ** 2 * math.sin(2 * math.pi / m))


def reference_at(mesh):
    cfg, _ = cell_files(small=mesh is not None)
    if mesh is None:
        cfg["program"].pop("mesh_resolution", None)
    pb = transport.problem(cfg, -1.0, "cpu")
    n_rings = mesh[0] if mesh else 4        # the generator's choice at L50R5
    aspect = cfg["program"]["R"] / cfg["program"]["L"]
    return pb, polygon(n_rings, aspect)


@pytest.mark.parametrize("mesh", (SMALL_MESH, None), ids=("small", "cell"))
def test_wall_flux_integral(mesh):
    """At u = 1 the exit term vanishes: the rows sum, species by species,
    to the wall flux times the mesh's own wall area (the outer polygon's
    perimeter over a unit length)."""
    pb, (perimeter, _) = reference_at(mesh)
    u = pb.initial_state()
    rows = pb.add_fluxes(torch.zeros_like(u), u, None)
    assert torch.allclose(rows.sum(0), pb.wall_flux * perimeter,
                          rtol=1e-12, atol=0.0)
    assert pb.wall_flux.abs().sum() > 0


@pytest.mark.parametrize("mesh", (SMALL_MESH, None), ids=("small", "cell"))
def test_exit_robin_on_a_constant_state(mesh):
    """On u = c everywhere the exit rows sum to the Sherwood coefficient
    times (c - 1) times the exit area (the outer polygon's area); the wall
    flux is set to zero for it, so that no wall row cancels."""
    pb, (_, area) = reference_at(mesh)
    pb.wall_flux = torch.zeros_like(pb.wall_flux)
    one = pb.initial_state()
    c = 1.7
    rows = pb.add_fluxes(torch.zeros_like(one), c * one, None)
    assert torch.allclose(rows.sum(0), pb.exit_coeff * (c - 1.0) * area,
                          rtol=1e-12, atol=0.0)
    exit_rows = rows.abs().sum(1) > 0
    assert exit_rows.sum() == len(np.unique(pb.facets["exit"][0]))


def test_boundary_facets_of_a_tet():
    """One tetrahedron's four faces are all boundary faces; only the
    face whose vertices all satisfy a set's test is marked."""
    L, R = 50e-9, 5e-9
    a = R / L
    pts = np.array([[a, 0.0, 0.0], [0.0, a, 0.0], [-a, 0.0, 0.0],
                    [0.0, 0.0, 0.5]])
    facets = rxndiff_pore.boundary_facets(pts, np.array([[0, 1, 2, 3]]), L, R)
    assert len(facets["exit"]) == 0
    # the face (0, 1, 2) lies in z = 0 with its vertices on the rim: the
    # wall mark, applied last, wins over the entry mark
    assert facets["wall"].tolist() == [[0, 1, 2]]


def control_readings(volt, device, small):
    """The float32 control's checks at one voltage (None where its LU
    found the matrix singular) and its unconverged lane-steps."""
    from benchmark.reference import control, judge

    cfg, _ = cell_files(small=small)
    try:
        states, unconverged = control.control_states(
            cfg, [volt], CONTROL_STEPS, device, max_iter=CONTROL_MAX_ITER)
    except torch.linalg.LinAlgError:
        return None, None
    return judge.judge(cfg, states, 0, device), unconverged


def test_control_fails_small():
    torch.set_num_threads(1)
    _, wl = cell_files()
    checks, _ = control_readings(run.draw_voltages(wl, SEED)[0], "cpu", True)
    assert fails(checks), checks


@pytest.mark.cuda
def test_control_fails_on_card():
    """The float32 control at the cell's size, at every voltage a seed
    can put first (the cell has one), reads not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, wl = cell_files(small=False)
    volts = sorted({v for s in CARD_SEEDS for v in run.draw_voltages(wl, s)})
    out = []
    for v in volts:
        t0 = time.perf_counter()
        checks, unconverged = control_readings(v, "cuda", small=False)
        line = {"cell": CELL, "voltage": v, "unconverged": unconverged,
                "seconds": time.perf_counter() - t0}
        line.update({k: c["value"] for k, c in (checks or {}).items()})
        if checks is None:
            line["crashed"] = "float32 LU found the matrix singular"
        print("control", json.dumps(line), flush=True)
        out.append(fails(checks))
        torch.cuda.empty_cache()
    assert all(out)
