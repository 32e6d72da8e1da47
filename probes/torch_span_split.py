"""Per-layer device and host time of a benchmark cell, read from the
program's own spans, and the checks of the spans themselves.

    python probes/torch_span_split.py --workload pore_gmpnp.carried_schedule \
        --seed 1234 [--out out/span_split] [--device cpu --small]

Set-up as ``benchmark/run.py`` (build, one warm-up episode). Then, with
the program's tracing off: one round of the cell (the factor builds per
lane-step, as a window would count them) and the episode that a traced
run profiles (``benchmark/run.py``'s ``traced_episode``); then one more
episode at the same voltage with tracing on
(``benchmark/harness/program_trace.py``). ``--small`` runs the cell at
the sizes of the benchmark's CPU tests (``benchmark/tests/small.py``), to
rehearse on the CPU. Prints one JSON line (also
written to ``<out>/<workload>.json``):

- ``metrics``: what the six readers ``assembly_device_ms_per_step``,
  ``factor_device_ms_per_step``, ``solve_device_ms_per_step``,
  ``assembly_host_ms_per_step``, ``host_wait_ms_per_step`` and
  ``factors_per_step`` read;
- ``device_by_span``, ``idle_by_span`` (seconds);
- ``owned_share`` (device time owned by a span), ``idle_none_share``
  (idle time outside every span), ``foreign_names`` (names that are no
  span of the program, no CUDA call inside one and not ``none``);
- ``layers_ms`` against ``busy_ms``: the per-layer device ms per lane-step
  (assembly + factor + solve + ``step.update`` + ``step`` alone) against
  the profiled episode's busy ms per lane-step;
- ``episode_s``: the profiled and the traced episode's wall times, and
  ``traced_s``, what the traced episode added, its reading included;
- ``bitwise``: the traced episode's first and last states equal the
  profiled episode's;
- ``checks``: the plain reference's checks of the traced episode.
"""

import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the program's spans (``gmpnp_tpu_torch/utils/profiling.py``'s users)
SPANS = ("step", "step.update", "newton.iter", "assembly.residual",
         "assembly.jacobian", "linear.factor", "linear.solve",
         "linear.krylov", "host.read", "sweep.build", "sweep.batch")
READERS = ("assembly_device_ms_per_step", "factor_device_ms_per_step",
           "solve_device_ms_per_step", "assembly_host_ms_per_step",
           "host_wait_ms_per_step", "factors_per_step")


def same_states(a, b):
    """First and last (u_prev, u_new, dt_scale, norms, index) of two
    episodes equal bit for bit."""
    import numpy as np
    import torch

    for x, y in ((a.first, b.first), (a.last, b.last)):
        if not (torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                and np.array_equal(x[2], y[2])
                and np.array_equal(x[3], y[3]) and x[4] == y[4]):
            return False
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", default=os.path.join("out", "span_split"))
    args = p.parse_args(argv)

    import torch

    from benchmark import run as bench
    from benchmark.harness import program_trace, record
    from benchmark.reference import judge

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wl = bench.load_json("benchmark", "workloads", f"{args.workload}.json")
    cfg = bench.load_json("benchmark", "configs", f"{wl['config']}.json")
    if args.small:
        from benchmark.tests.small import SMALL

        torch.set_num_threads(1)
        cfg["program"].update(SMALL[args.workload].get("program", {}))
        wl.update(SMALL[args.workload].get("workload", {}))
    volts = bench.draw_voltages(wl, args.seed)
    print(bench.kernel_line(device), file=sys.stderr)
    driver = importlib.import_module(
        f"benchmark.drivers.{wl['driver']}").Driver(cfg, wl, volts, device)
    driver.warm()
    sync()

    # one round, tracing off: factor builds per lane-step
    rnd = record.Recorder(sync)
    f0 = program_trace.factor_builds()
    with rnd.wrap_run(*driver.loop):
        bench.run_round(driver, rnd)
    data = {"lane_steps": rnd.lane_steps,
            "factor_builds": program_trace.factor_builds() - f0}

    profiled = record.Recorder(sync)
    prof = bench.traced_episode(driver, profiled, sync, cuda)
    t0 = time.perf_counter()
    traced, program = program_trace.traced_program_episode(driver, sync,
                                                           cuda)
    traced_s = time.perf_counter() - t0
    data["program"] = program
    metrics = {name: importlib.import_module(
        f"benchmark.metrics.{name}").read(data) for name in READERS}

    by_dev, by_idle = program["device_by_span"], program["idle_by_span"]
    steps = program["lane_steps"]
    per_step = {k: v * 1e3 / steps for k, v in by_dev.items()}
    layers = (metrics["assembly_device_ms_per_step"]
              + metrics["factor_device_ms_per_step"]
              + metrics["solve_device_ms_per_step"]
              + per_step.get("step.update", 0.0) + per_step.get("step", 0.0))
    idle = sum(by_idle.values())
    names = set(by_dev) | set(by_idle)
    foreign = sorted(n for n in names
                     if n != "none" and n.split("/")[0] not in SPANS)
    states = [(e.volts, e.first, e.last) for e in traced.episodes]
    checks = judge.judge(cfg, states,
                         traced.lane_steps - traced.converged_lane_steps,
                         device)
    result = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(device) if cuda else "cpu",
        "metrics": metrics,
        "device_by_span": program_trace.top(by_dev, 20),
        "idle_by_span": program_trace.top(by_idle, 20),
        "device_ms_per_step_by_span": program_trace.top(per_step, 20),
        "owned_share": (1.0 - by_dev.get("none", 0.0) / program["device_s"]
                        if program["device_s"] else None),
        "idle_none_share": by_idle.get("none", 0.0) / idle if idle else 0.0,
        "foreign_names": foreign,
        "unlinked_ops": program["unlinked_ops"],
        "layers_ms": layers,
        "busy_ms": prof["busy_s"] * 1e3 / profiled.lane_steps,
        "traced_busy_ms": program["busy_s"] * 1e3 / steps,
        "episode_s": {"profiled": prof["window_s"],
                      "traced": program["window_s"]},
        "traced_s": traced_s, "lane_steps": steps,
        "spans": program["spans"], "counts": program["counts"],
        "bitwise": same_states(profiled.episodes[0], traced.episodes[0]),
        "checks": checks,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
