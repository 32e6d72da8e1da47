"""The program's own spans under the profiler: device and host time per
layer, and the card's idle time put down to the layer the host was in.

``traced_program_episode`` runs one more episode (the round's first
voltage) with the program's tracing on (``gmpnp_tpu_torch.utils.profiling
.tracing``) under ``torch.profiler``, with the activities of
``profile.profiled``: on the card its operations and the CUDA calls that
launch and wait for them. The spans are stamped on the clock of the
profiler's host records, so no offset is fitted:

- each device operation belongs to the innermost span open when its
  launching CUDA call started (the two joined by correlation id);
- each idle gap of the card belongs to the innermost span open at the
  gap's middle, or to the CUDA call inside that span running then
  (``<span>/<call>``); ``none`` outside every span.

A program without the recorder gives no data, and the readers then read
nothing. ``probes/torch_span_split.py`` runs it after the episodes that
``benchmark/run.py`` profiles and prints what the readers of
``benchmark/metrics/*_device_ms_per_step.py``, ``assembly_host_ms_per_step``,
``host_wait_ms_per_step`` and ``factors_per_step`` read from it.
"""

from __future__ import annotations

import bisect
import contextlib
import time

from benchmark.harness import profile

#: the span names whose device time each device reader sums
ASSEMBLY = ("assembly.residual", "assembly.jacobian")
FACTOR = ("linear.factor",)
SOLVE = ("linear.solve", "linear.krylov")
NONE = "none"


def recorder():
    """The program's ``utils.profiling`` module, or None if it has no
    recorder."""
    try:
        from gmpnp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def factor_builds():
    """The program's running total of factor builds (every
    ``factors.<reason>`` counter), or None without the counters."""
    prof = recorder()
    if prof is None:
        return None
    return sum(v for k, v in prof.COUNTS.items() if k.startswith("factors."))


@contextlib.contextmanager
def profiled_program(out, cuda=True):
    """The body with the program's tracing on, under the profiler. Fills
    ``out`` with ``window_s``, ``trace`` (the program's ``Trace``),
    ``device`` [(start_ns, end_ns, name, correlation)] and ``calls`` (the
    CUDA calls: [(start_ns, end_ns, name, correlation)]), each sorted by
    start, all on one clock. Without a card (tests) there are neither."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        with recorder().tracing() as trace:
            t0 = time.perf_counter()
            yield
            out["window_s"] = time.perf_counter() - t0
    dev, calls = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if e.device_type().name == "CUDA":
            dev.append((start, start + e.duration_ns(), e.name(),
                        e.correlation_id() or e.linked_correlation_id()))
        elif e.name().startswith("cu"):
            # CUDA runtime and driver calls; the profiler's own records
            # (buffer requests) have ids of their own, which may repeat
            calls.append((start, start + e.duration_ns(), e.name(),
                          e.correlation_id()))
    dev.sort()
    calls.sort()
    out["trace"], out["device"], out["calls"] = trace, dev, calls


def innermost(spans, times):
    """For each time (sorted), the index of the innermost span open then,
    or -1. ``spans`` nest (one thread's spans)."""
    bounds = []
    for i, s in enumerate(spans):
        bounds.append((s.start_ns, 1, i))
        bounds.append((s.end_ns, 0, i))
    bounds.sort()
    out, stack, b = [], [], 0
    for t in times:
        while b < len(bounds) and bounds[b][0] <= t:
            _, opens, i = bounds[b]
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            b += 1
        out.append(stack[-1] if stack else -1)
    return out


def owners(device, calls, spans):
    """Each device operation's owning span index (-1: none): the innermost
    span at the start of the CUDA call that launched it (an operation
    with no such call: at its own start)."""
    launch = {c[3]: c[0] for c in calls if c[3]}
    at = [launch.get(d[3], d[0]) for d in device]
    order = sorted(range(len(at)), key=at.__getitem__)
    found = innermost(spans, [at[k] for k in order])
    own = [-1] * len(at)
    for k, i in zip(order, found):
        own[k] = i
    return own


def device_by_span(device, own, spans):
    """{span name or 'none': device seconds}."""
    by = {}
    for (s, e, *_), i in zip(device, own):
        name = spans[i].name if i >= 0 else NONE
        by[name] = by.get(name, 0.0) + (e - s) * 1e-9
    return by


def idle_by_span(device, calls, spans, scan=400):
    """{span, '<span>/<CUDA call>' or 'none': idle seconds of the card},
    each gap put down at its middle."""
    gaps = profile.gaps([d[:3] for d in device])
    mids = [0.5 * (s + e) for s, e in gaps]
    where = innermost(spans, mids)
    starts = [c[0] for c in calls]
    by = {}
    for (s, e), mid, i in zip(gaps, mids, where):
        name = NONE
        if i >= 0:
            name = spans[i].name
            j = bisect.bisect_right(starts, mid)
            for k in range(j - 1, max(-1, j - 1 - scan), -1):
                c = calls[k]
                if c[0] < spans[i].start_ns:
                    break
                if c[1] >= mid:
                    name = f"{name}/{c[2]}"
                    break
        by[name] = by.get(name, 0.0) + (e - s) * 1e-9
    return by


def host_ms(spans, prefix):
    """ms of host time in the spans named ``prefix*`` less the host reads
    inside them; spans of the same prefix inside another count once."""
    inside = [False] * len(spans)
    total = 0
    for i, s in enumerate(spans):
        p = s.parent
        inside[i] = p >= 0 and (inside[p] or spans[p].name.startswith(prefix))
        if s.name.startswith(prefix) and not inside[i]:
            total += s.end_ns - s.start_ns
        elif s.name == "host.read" and inside[i]:
            total -= s.end_ns - s.start_ns
    return total * 1e-6


def summary(out, lane_steps):
    """What the readers read: ``data["program"]``."""
    trace, dev, calls = out["trace"], out["device"], out["calls"]
    spans = trace.spans
    own = owners(dev, calls, spans)
    by_dev = device_by_span(dev, own, spans)
    reads = sum(s.end_ns - s.start_ns for s in spans
                if s.name == "host.read") * 1e-6
    linked = {c[3] for c in calls if c[3]}
    return {"lane_steps": lane_steps, "window_s": out["window_s"],
            "busy_s": profile.union_seconds([d[:3] for d in dev]) * 1e-3,
            "device_s": sum(by_dev.values()),
            "unlinked_ops": sum(1 for d in dev if d[3] not in linked),
            "spans": len(spans), "counts": dict(trace.counts),
            "device_by_span": by_dev,
            "idle_by_span": idle_by_span(dev, calls, spans),
            "assembly_host_ms": host_ms(spans, "assembly."),
            "host_read_ms": reads}


def top(by, n=12):
    return sorted(([k[:120], v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:n]


def traced_program_episode(driver, sync, cuda):
    """One more episode (the round's first) with the program's tracing on,
    under the profiler: (its ``record.Recorder``, ``data["program"]``), or
    (None, None) when the program has no recorder."""
    from benchmark.harness import record

    if recorder() is None:
        return None, None
    volts, episode = driver.episodes()[0]
    rec, out = record.Recorder(sync), {}
    with rec.wrap_run(*driver.loop), profiled_program(out, cuda):
        rec.begin(volts)
        episode()
        rec.finish()
        sync()
    return rec, summary(out, rec.lane_steps)
