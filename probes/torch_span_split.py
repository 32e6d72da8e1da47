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
- ``checks``: the plain reference's checks of the traced episode;
- ``inclusive``: per span name of ``INCLUSIVE``, its calls, host seconds
  and the device seconds of every operation launched inside it, nested
  spans included (``step.fallback``: the carried step's exact re-solves
  and refactors; ``assembly.facets``: the boundary facet terms), and
  ``chord``: the device seconds of the linear solves outside every
  ``step.fallback`` (the chord GMRES and the refreshes' factors);
- ``chord_counts``: the traced episode's ``chord.failed``,
  ``chord.failed_iters`` and ``chord.failed_krylov``, the abandoned
  chord attempts that ``StepStats`` leaves out.
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
SPANS = ("step", "step.update", "step.fallback", "newton.iter",
         "assembly.residual", "assembly.jacobian", "assembly.facets",
         "linear.factor", "linear.solve", "linear.krylov", "host.read",
         "sweep.build", "sweep.batch")
#: spans whose device time is also summed with everything nested in them
INCLUSIVE = ("step.fallback", "assembly.facets")
CHORD_COUNTS = ("chord.failed", "chord.failed_iters", "chord.failed_krylov")
#: the small sizes of the cells that ``benchmark/tests/small.py`` lacks
SMALL_EXTRA = {
    "rxndiff_pore.carried50": {
        "program": {"mesh_resolution": [2, 10]},
        "workload": {"run": {"n_steps": 3, "record_full": False}}},
}
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


def traced_episode_kept(driver, sync, cuda):
    """``program_trace.traced_program_episode``, also handing back what
    the profiler recorded (the spans and the device operations)."""
    from benchmark.harness import program_trace, record

    volts, episode = driver.episodes()[0]
    rec, out = record.Recorder(sync), {}
    with rec.wrap_run(*driver.loop), program_trace.profiled_program(out,
                                                                    cuda):
        rec.begin(volts)
        episode()
        rec.finish()
        sync()
    return rec, program_trace.summary(out, rec.lane_steps), out


def inclusive_split(out):
    """{name: {calls, host_s, device_s}} for the spans of ``INCLUSIVE``,
    and "chord": the device seconds of ``linear.*`` spans outside every
    ``step.fallback``."""
    from benchmark.harness import program_trace

    spans = out["trace"].spans
    own = program_trace.owners(out["device"], out["calls"], spans)
    split = {n: {"calls": 0, "host_s": 0.0, "device_s": 0.0}
             for n in INCLUSIVE}
    split["chord"] = {"device_s": 0.0}
    for s in spans:
        if s.name in split:
            split[s.name]["calls"] += 1
            split[s.name]["host_s"] += (s.end_ns - s.start_ns) * 1e-9
    for (start, end, *_), i in zip(out["device"], own):
        names = set()
        while i >= 0:
            names.add(spans[i].name)
            i = spans[i].parent
        for n in INCLUSIVE:
            if n in names:
                split[n]["device_s"] += (end - start) * 1e-9
        if ("step.fallback" not in names
                and any(n.startswith("linear.") for n in names)):
            split["chord"]["device_s"] += (end - start) * 1e-9
    return split


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
        small = {**SMALL_EXTRA, **SMALL}[args.workload]
        cfg["program"].update(small.get("program", {}))
        wl.update(small.get("workload", {}))
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
    traced, program, out = traced_episode_kept(driver, sync, cuda)
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
        "inclusive": inclusive_split(out),
        "chord_counts": {k: program["counts"].get(k, 0)
                         for k in CHORD_COUNTS},
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
