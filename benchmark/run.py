"""Run one cell of the port's benchmark once, on the card it is started on.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names its configuration
(``benchmark/configs/<config>.json``) and its traffic
(``benchmark/workloads/<name>.json``), whose ``driver`` is
``benchmark/drivers/<driver>.py``. A metric is read by
``benchmark/endtoend/<base>.py`` (end to end) or
``benchmark/metrics/<base>.py`` (per layer; else the end-to-end reader),
the base being its name up to the first dot. The seed orders the cell's
operating voltages; set-up builds the program and warms every shape up;
the window then runs whole rounds of episodes (each a transient or a
sweep from its cold state; a round covers every voltage once) until
``--seconds`` have passed, and ends with the round in progress. Where an
end-to-end metric of the cell comes from the device, CUPTI records every
operation of the window (``harness/devicebusy.py``). A traced run then
runs one round with spans around the layers and one episode under
``torch.profiler``, which the per-layer metrics read with the window.
Afterwards the plain reference (``benchmark/reference``) judges the states
the window produced. The last line of standard output is the result.

Files: the kernel library is built into, and loaded from,
``build/torch_kernels/`` inside the checkout (the program's own build
cache); the device-busy collector is built into ``build/bench_cache/``,
and Triton's and PyTorch's extension caches are pointed there too. The
profiler's trace stays in memory and nothing else is written: a run
writes nothing beyond the first build (a few MB).

It imports neither JAX nor the JAX package, and exits non-zero without a
result if either is loaded when the window has closed, if the card is
missing, or if the program is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T_IMPORT = time.perf_counter()
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "gmpnp_tpu")


def process_age_s():
    """Seconds since this process started (from /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def draw_voltages(workload, seed):
    """The cell's operating voltages in the seed's order: every seed runs
    the same set (the workload's ``voltages``), so that the seed changes
    the order of the work and not its amount."""
    import numpy as np

    volts = [float(v) for v in workload["voltages"]]
    order = np.random.default_rng(seed % 2 ** 64).permutation(len(volts))
    return [volts[k] for k in order]


def _applies(metric, name):
    return "workloads" not in metric or name in metric["workloads"]


#: where each kind of metric's reader lives: a per-layer metric may be an
#: end-to-end quantity reported per layer in a cell where it is too noisy
#: to bound (``lane_steps_per_s.carried``)
READER_DIRS = {"end_to_end": ("endtoend",),
               "per_layer": ("metrics", "endtoend")}


def reader(kind, name):
    """The module that reads a metric: ``benchmark/<dir>/<base>.py``, the
    base being the metric's name up to its first dot."""
    base = name.split(".")[0]
    for d in READER_DIRS[kind]:
        if os.path.exists(os.path.join(ROOT, "benchmark", d, f"{base}.py")):
            return importlib.import_module(f"benchmark.{d}.{base}")
    raise ModuleNotFoundError(f"no reader for {kind} metric {name!r}")


def kernel_line(device):
    """Load the kernel library (building it only when the cache inside the
    checkout lacks it) and say which."""
    from gmpnp_tpu_torch.ops import _build

    if device.type != "cuda":
        return "kernels: not loaded (the plain versions run on the CPU)"
    path = _build.library_path()
    cached = os.path.exists(path)
    _build.load_library()
    where = os.path.relpath(path, ROOT)
    state = "loaded from the cache" if cached else "built into"
    return f"kernels: {state} {where}"


def run_round(driver, rec):
    """One round: an episode at every voltage, in the seed's order."""
    for volts, episode in driver.episodes():
        rec.begin(volts)
        episode()
        rec.finish()


def spanned_round(driver, sync):
    """One more round with spans around the assembly and linear layers.
    Each span ends in a synchronize, which slows the host, so the spans
    stay out of the window."""
    from benchmark.harness import record

    rec, spans = record.Recorder(sync), record.Spans(sync)
    with rec.wrap_run(*driver.loop), spans.active():
        run_round(driver, rec)
    return rec, spans


def traced_episode(driver, rec, sync, cuda):
    """One more episode (the round's first) under the profiler, recording
    the card's operations and the CUDA calls that launch them: the window
    that the idle share, the rooflines and the breakdown are read from."""
    from benchmark.harness import profile, record

    volts, episode = driver.episodes()[0]
    out = {}
    c0 = record.counters()
    with rec.wrap_run(*driver.loop), profile.profiled(out, cuda):
        rec.begin(volts)
        episode()
        rec.finish()
        sync()
    launches = record.counter_delta(c0, record.counters())["shapes"]
    dev, host = out["device"], out["host"]
    return {"window_s": out["window_s"], "device": dev,
            "busy_s": profile.union_seconds(dev), "launches": launches,
            "top": profile.top_device_ops(dev),
            "idle": profile.idle_by_host(dev, host)}


def run_cell(manifest, name, seed, seconds, trace, device, overrides=None):
    """Set up, run the window and judge it; returns the result dict (the
    checks last). ``overrides`` ({"program": {...}, "workload": {...}})
    shrink a cell for tests on the CPU."""
    import torch

    from benchmark.harness import devicebusy, record
    from benchmark.reference import judge

    device = torch.device(device)
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    wl = load_json("benchmark", "workloads", f"{name}.json")
    cfg = load_json("benchmark", "configs", f"{cell['config']}.json")
    if overrides:
        cfg["program"].update(overrides.get("program", {}))
        wl.update(overrides.get("workload", {}))
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = "per_layer" if trace else "end_to_end"
    wanted = [m for m in manifest[kind] if _applies(m, name)]
    # the card's busy time over the whole window, where an end-to-end
    # metric of the cell reads it (CUPTI; no card, no reading; a traced
    # run leaves CUPTI to the profiler)
    count_busy = cuda and not trace and any(
        m["source"] == "device_trace" for m in wanted)
    volts = draw_voltages(wl, seed)
    print(f"cell {name}: seed {seed} voltages in order {volts}",
          file=sys.stderr)
    print(kernel_line(device), file=sys.stderr)
    if count_busy:
        print(f"device busy from {devicebusy.load()[1]}", file=sys.stderr)

    stage = {"start": time.perf_counter()}
    driver_mod = importlib.import_module(f"benchmark.drivers.{wl['driver']}")
    driver = driver_mod.Driver(cfg, wl, volts, device)
    sync()
    stage["built"] = time.perf_counter()
    driver.warm()
    sync()
    stage["warm"] = time.perf_counter()
    setup_s = process_age_s()

    rec = record.Recorder(sync)
    busy = None
    before = record.counters()
    with contextlib.ExitStack() as stack:
        stack.enter_context(rec.wrap_run(*driver.loop))
        if count_busy:
            busy = stack.enter_context(devicebusy.Window())
        t0 = time.perf_counter()
        while True:                 # whole rounds: the same work every seed
            run_round(driver, rec)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    window = record.counter_delta(before, record.counters())

    stage["window"] = time.perf_counter()
    recs, spans, prof_run = [rec], None, None
    if trace:
        span_rec, spans = spanned_round(driver, sync)
        profiled = record.Recorder(sync)
        prof_run = traced_episode(driver, profiled, sync, cuda)
        recs += [span_rec, profiled]
    stage["traced"] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        kind_name = torch.cuda.get_device_name(device)
    else:
        kind_name = "cpu"

    data = {"setup_s": setup_s, "window_s": window_s, "recorder": rec,
            "lane_steps": rec.lane_steps, "newton_iters": rec.newton_iters,
            "linear_iters": rec.linear_iters, "syncs": window["syncs"],
            "device_busy_s": busy.busy_s if busy else None,
            "span_lane_steps": recs[1].lane_steps if trace else 0,
            "span_s": spans.seconds if spans else None,
            "span_calls": spans.calls if spans else None,
            "profile": prof_run}
    metrics = {}
    for m in wanted:
        v = reader(kind, m["name"]).read(data)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    lane_steps = rec.lane_steps
    failed = rec.lane_steps - rec.converged_lane_steps
    busy_note = (f"device busy {busy.busy_s!r} s over {busy.ops} operations"
                 f" ({busy.n_misread} misread, left out: {busy.misread}), "
                 if busy else "")
    print(f"window: {window_s!r} s, {len(rec.episodes)} episodes, "
          f"{lane_steps} lane-steps, {failed} unconverged, {busy_note}"
          f"newton {rec.newton_iters}, krylov {rec.linear_iters}, "
          f"host syncs {window['syncs']}, episode s "
          f"{[round(e.end - e.start, 3) for e in rec.episodes]}, "
          f"launches {window['shapes']}",
          file=sys.stderr)

    # the program's state goes before the reference runs
    states = [(e.volts, e.first, e.last) for r in recs for e in r.episodes]
    unconverged = sum(r.lane_steps - r.converged_lane_steps for r in recs)
    driver.close()
    del driver, rec, recs, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    stage["freed"] = time.perf_counter()
    checks = judge.judge(cfg, states, unconverged, device)
    stage["judged"] = time.perf_counter()
    lap = {b: stage[b] - stage[a] for a, b in zip(
        ("start", "built", "warm", "window", "traced", "freed"),
        ("built", "warm", "window", "traced", "freed", "judged"))}
    print(f"timing: setup {setup_s!r} s (before the build "
          f"{setup_s - lap['built'] - lap['warm']!r}, build {lap['built']!r},"
          f" warm-up {lap['warm']!r}); window {lap['window']!r}; spanned "
          f"and traced episodes {lap['traced']!r}; free {lap['freed']!r}; "
          f"check {lap['judged']!r}", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": bool(correct), "attempted": int(lane_steps),
              "failed": int(failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": kind_name, "count": int(cell["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace and prof_run is not None:
        result["device"]["busy_s"] = prof_run["busy_s"]
        result["device"]["window_s"] = prof_run["window_s"]
        result["breakdown"] = {"device_ops": prof_run["top"],
                               "idle_gaps": prof_run["idle"]}
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    manifest = load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      args.trace, "cuda")
    found = forbidden_modules()
    if found:
        print(f"no result: loaded {found}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
