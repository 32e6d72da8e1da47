"""The carried double-layer cell, ``edl_mpnp.carried20``, at a small size
on the CPU (L_n = 1 um, 3 steps an episode; the chord path as the cell
runs it), and the float32 control at the cell's own size on the card:

    python -m pytest benchmark/tests/test_bench_edl_carried.py -m cuda -s -p no:cacheprovider
"""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness.program import program_config
from benchmark.reference import check, fem, transport
from benchmark.tests import small, test_bench_faults
from benchmark.tests.small import SEED
from benchmark.tests.test_bench_control import CARD_SEEDS, fails, readings

CELL = "edl_mpnp.carried20"
OVERRIDES = {"program": {"L_n": 1e-6}, "workload": {"run": {"n_steps": 3}}}

#: the per-layer metrics a traced run on the CPU has something to read for:
#: no roofline, since the CPU launches no kernel (the idle share reads 100)
CPU_READABLE = {"newton_per_step", "host_syncs_per_step",
                "assembly_ms_per_step", "linear_ms_per_step", "device_idle",
                "lane_steps_per_s", "cold_start_ms", "step_ms_p95"}


def cell_files():
    wl = run.load_json("benchmark", "workloads", f"{CELL}.json")
    cfg = run.load_json("benchmark", "configs", f"{wl['config']}.json")
    return cfg, wl


def run_carried(trace=0):
    from gmpnp_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    before = dict(profiling.COUNTS)
    res = run.run_cell(run.load_json("BENCHMARK.json"), CELL, SEED, 0.01,
                       trace, "cpu", OVERRIDES)
    built = {k: v - before.get(k, 0) for k, v in profiling.COUNTS.items()
             if k.startswith("factors.") and v != before.get(k, 0)}
    return res, built


def test_carried_cell_correct():
    """Correct, every step converged, on the chord path: the program
    builds a factor once per episode from cold and solves every other
    iteration against it (no per-iteration factor)."""
    res, built = run_carried()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert built.get("factors.init", 0) > 0 and "factors.iter" not in built
    # the host-clock end-to-end metrics of the cell (device_ms_per_step
    # needs a card)
    assert set(res["metrics"]) == {"setup_s"}


def test_carried_cell_traced():
    res, _ = run_carried(trace=1)
    assert res["correct"], res["checks"]
    edl = {m["name"] for m in run.load_json("BENCHMARK.json")["per_layer"]
           if CELL in m.get("workloads", ())}
    assert edl == {f"{b}.edl" for b in CPU_READABLE
                   | {"segsum_roofline", "block_inv_roofline"}}
    assert set(res["metrics"]) == {f"{b}.edl" for b in CPU_READABLE}


@pytest.mark.parametrize("kind", ("unchanged", "altered"))
def test_fault_is_not_correct(monkeypatch, kind):
    """A step from ``models.edl_1d.make_carried_step`` broken below the
    harness, as ``test_bench_faults.py`` plants it."""
    torch.manual_seed(0)
    monkeypatch.setitem(small.STEP_FACTORIES, CELL, (
        "gmpnp_tpu_torch.models.edl_1d", ("make_carried_step",)))
    test_bench_faults.plant(monkeypatch, CELL, kind)
    res, _ = run_carried()
    assert not res["correct"], res["checks"]


def random_state(rng, n, volt, crowded=False):
    """Concentrations log-normal around their bulk values, a potential
    from the OHP voltage to 0 with a random walk on it; crowded: the
    cation and bicarbonate 30 times their bulk over the first third."""
    u = np.empty((n, 7))
    u[:, :6] = np.exp(0.3 * rng.standard_normal((n, 6)))
    x = np.linspace(0.0, 1.0, n)
    walk = np.cumsum(rng.standard_normal(n)) / np.sqrt(n)
    u[:, 6] = volt * (1.0 - x) + 0.5 * (walk - x * walk[-1])
    if crowded:
        u[: n // 3, [2, 5]] *= 30.0
    return torch.as_tensor(u)


@pytest.mark.parametrize("k", range(3))
def test_reference_residual_matches_program(k):
    """The program's Dirichlet-applied residual against the reference's at
    seeded random states of the cell's own 50 um mesh; the third is
    crowded past the steric clip."""
    cfg, wl = cell_files()
    volt = wl["voltages"][k]
    module, pcfg = program_config(cfg, wl, volt)
    prog = module.build(pcfg, device="cpu")
    pb = transport.problem(cfg, volt, "cpu")
    space = fem.P1Space(pb.points, pb.cells, cfg["program"]["quad_degree"],
                        "cpu", torch.float64)
    rng = np.random.default_rng(SEED + k)
    n = pb.num_vertices
    up = random_state(rng, n, volt, crowded=k == 2)
    un = up * torch.as_tensor(np.exp(0.05 * rng.standard_normal(up.shape)))
    if k == 2:
        denom = 1.0 - (pb.scale_vol * un[:, :6]).sum(-1)
        assert (denom < cfg["inputs"]["steric_clip"]).sum() > n // 4
    th_p = prog._theta_of_carry((up, 0.0), 0)
    r_p = prog.bc.apply_to_residual(
        prog.space.residual(prog.form, un, up, th_p), un)
    r_r = space.residual(pb, un, up, pb.theta(up, 0))
    # the same residual up to the rounding of its cancellations: far
    # inside the Newton bound the step is held to
    _, bound = check.step_measures(space, pb, up, un, 0, cfg["guarantee"])
    assert float(fem.l2(r_p - r_r)) <= 1e-5 * bound


@pytest.mark.cuda
def test_control_fails_on_card():
    """The float32 control at the cell's size, at every voltage a seed
    can put first, reads not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, wl = cell_files()
    volts = sorted({v for s in CARD_SEEDS for v in run.draw_voltages(wl, s)})
    out = []
    for v in volts:
        t0 = time.perf_counter()
        checks, unconverged = readings(CELL, v, "cuda", small=False)
        line = {"cell": CELL, "voltage": v, "unconverged": unconverged,
                "seconds": time.perf_counter() - t0}
        line.update({k: c["value"] for k, c in (checks or {}).items()})
        if checks is None:
            line["crashed"] = "float32 LU found the matrix singular"
        print("control", json.dumps(line), flush=True)
        out.append(fails(checks))
        torch.cuda.empty_cache()
    assert all(out)
