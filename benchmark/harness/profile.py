"""Reading ``torch.profiler`` over one episode: device busy time, kernel
time by name, and the idle gaps with the host call running in them.

Everything stays in memory; no trace file is written.
"""

from __future__ import annotations

import bisect
import contextlib
import time

@contextlib.contextmanager
def profiled(out, cuda=True):
    """Profile the body on the card: its operations, and on the host the
    CUDA calls that launch and wait for them (host-side torch operations
    are not recorded: they slow the host several-fold). Fills ``out`` with
    the window's length and the events, read straight from the profiler's
    records: ``device`` and ``host``, each [(start_us, end_us, name)]
    sorted by start. Without a card (tests) it records the host."""
    from torch.profiler import ProfilerActivity, profile

    act = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        t0 = time.perf_counter()
        yield
        out["window_s"] = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    base = min((e.start_ns() for e in events), default=0)
    dev, host = [], []
    for e in events:
        start = (e.start_ns() - base) * 1e-3
        item = (start, start + e.duration_ns() * 1e-3, e.name())
        (dev if e.device_type().name == "CUDA" else host).append(item)
    dev.sort()
    host.sort()
    out["device"], out["host"] = dev, host


def union_seconds(intervals):
    """Seconds covered by the union of the intervals (microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(intervals):
    """[(start_us, end_us)] between the merged device intervals."""
    out, cur_e = [], None
    for s, e, _ in intervals:
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def top_device_ops(intervals, n=10):
    by = {}
    for s, e, name in intervals:
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return sorted(([k[:120], v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:n]


def idle_by_host(intervals, host, n=10, scan=400):
    """Idle seconds of the card grouped by the innermost host call running
    at each gap's middle (a CUDA call, such as a copy that waits for the
    card; 'python' where none is)."""
    starts = [h[0] for h in host]
    by = {}
    for s, e in gaps(intervals):
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        name = "python"
        for j in range(i - 1, max(-1, i - 1 - scan), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return sorted(([k[:120], v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:n]


def kernel_seconds(intervals, needle):
    """Device seconds and count of the kernels whose name holds needle."""
    t, k = 0.0, 0
    for s, e, name in intervals:
        if needle in name:
            t += (e - s) * 1e-6
            k += 1
    return t, k
