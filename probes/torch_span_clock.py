"""Which host clock the profiler's CUDA records are stamped on, and how
closely: each of N short kernel launches is bracketed by reads of the
candidate clocks, and each launch record's start is set against its
bracket.

    python probes/torch_span_clock.py [--n 400]

Prints one line per clock: the share of launch records inside their
bracket and the quartiles of (record start - bracket middle), in us, with
the bracket's median width; then the same for the kernels' ends against a
bracket around the synchronize that waits for them.
"""

import argparse
import json
import statistics
import time

import torch

CLOCKS = {
    "time_ns": time.time_ns,
    "monotonic_ns": time.monotonic_ns,
    "monotonic_raw": lambda: time.clock_gettime_ns(time.CLOCK_MONOTONIC_RAW),
    "perf_counter_ns": time.perf_counter_ns,
}


def read_all():
    return {k: f() for k, f in CLOCKS.items()}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=400)
    args = p.parse_args()
    from torch.profiler import ProfilerActivity, profile

    approx = getattr(torch._C._profiler, "_get_approximate_time", None)
    if approx is not None:
        CLOCKS["approximate"] = approx
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    launches, waits = [], []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.n):
            a = read_all()
            torch.cuda._sleep(20_000)
            b = read_all()
            launches.append((a, b))
            a = read_all()
            torch.cuda.synchronize()
            b = read_all()
            waits.append((a, b))
    ev = list(prof.profiler.kineto_results.events())
    dev = sorted((e for e in ev if e.device_type().name == "CUDA"),
                 key=lambda e: e.start_ns())
    calls = sorted((e for e in ev if e.device_type().name != "CUDA"
                    and "aunch" in e.name()), key=lambda e: e.start_ns())
    out = {"torch": torch.__version__, "n_dev": len(dev),
           "n_calls": len(calls),
           "call_names": sorted({e.name() for e in calls}),
           "dev_names": sorted({e.name()[:60] for e in dev})[:5]}
    for name in CLOCKS:
        for label, recs, brackets, key in (
                ("launch", calls, launches, lambda e: e.start_ns()),
                ("kernel_end", dev, waits,
                 lambda e: e.start_ns() + e.duration_ns())):
            if len(recs) != len(brackets):
                out[f"{name}.{label}"] = f"{len(recs)} records for " \
                                         f"{len(brackets)} brackets"
                continue
            inside, offs, widths = 0, [], []
            for e, (a, b) in zip(recs, brackets):
                t = key(e)
                inside += a[name] <= t <= b[name]
                offs.append((t - 0.5 * (a[name] + b[name])) * 1e-3)
                widths.append((b[name] - a[name]) * 1e-3)
            q = statistics.quantiles(offs, n=4)
            out[f"{name}.{label}"] = {
                "inside": inside / len(recs), "offset_us_q": q,
                "width_us_median": statistics.median(widths)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
