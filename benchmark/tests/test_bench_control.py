"""The control comes out not correct: the reference put in the program's
place in float32 (``reference.control``), judged as a run is judged.

On the CPU at the small sizes of ``small.py``; on the card
(``-m cuda``) at each cell's own size, on three seeds, printing the
readings each limit is set against:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -s -p no:cacheprovider
"""

import json
import os
import time

import pytest
import torch

from benchmark import run
from benchmark.reference import control, judge
from benchmark.tests.small import SEED, SMALL, manifest

CONTROL_STEPS = 2          # an episode's first step and the one after it
CONTROL_MAX_ITER = 12      # a float32 Newton that has not converged by
                           # then fails whatever it does next
CARD_SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def cell_inputs(name, small):
    m = manifest()
    cell = next(w for w in m["workloads"] if w["name"] == name)
    wl = run.load_json("benchmark", "workloads", f"{name}.json")
    cfg = run.load_json("benchmark", "configs", f"{cell['config']}.json")
    if small:
        cfg["program"].update(SMALL[name].get("program", {}))
    return cfg, wl


def readings(name, volt, device, small):
    """The control's checks at one voltage of the cell, or None where the
    float32 solve broke down (a control that crashes has failed)."""
    cfg, _ = cell_inputs(name, small)
    try:
        states, unconverged = control.control_states(
            cfg, [volt], CONTROL_STEPS, device, max_iter=CONTROL_MAX_ITER)
    except torch.linalg.LinAlgError:
        return None, None
    return judge.judge(cfg, states, 0, device), unconverged


def fails(checks):
    return checks is None or any(c["value"] > c["limit"]
                                 for c in checks.values())


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_small(name):
    torch.set_num_threads(1)
    _, wl = cell_inputs(name, True)
    checks, _ = readings(name, run.draw_voltages(wl, SEED)[0], "cpu", True)
    assert fails(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_on_card(name):
    """Every seed runs the cell's same voltages in another order, so the
    control at each voltage covers every seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, wl = cell_inputs(name, False)
    volts = sorted({v for s in CARD_SEEDS for v in run.draw_voltages(wl, s)})
    out = []
    for v in volts:
        t0 = time.perf_counter()
        checks, unconverged = readings(name, v, "cuda", small=False)
        line = {"cell": name, "voltage": v, "unconverged": unconverged,
                "seconds": time.perf_counter() - t0}
        line.update({k: c["value"] for k, c in (checks or {}).items()})
        if checks is None:
            line["crashed"] = "float32 LU found the matrix singular"
        print("control", json.dumps(line), flush=True)
        out.append(fails(checks))
        torch.cuda.empty_cache()
    assert all(out)
