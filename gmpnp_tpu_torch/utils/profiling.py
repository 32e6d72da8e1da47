"""Phase timers and ``torch.profiler`` traces.

Replaces the reference's per-step wall-clock prints
(3D/MPNP_CO2ER_pore.py:857) with phase accounting, and optional trace
capture of a run on the card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulating wall-clock phase timer.

        t = PhaseTimer()
        with t.phase("assembly"):
            ...
        print(t.report())

    Times are host wall clock: work queued on the card is counted only as
    far as the phase waits for it (end a phase with
    ``torch.cuda.synchronize()`` to count it whole).
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {tot:9.3f} s  ({n} calls, "
                         f"{tot / max(n, 1) * 1e3:8.2f} ms/call)")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the enclosed work (host and,
    when a CUDA device is present, card activity) and write it to
    ``<logdir>/trace.json`` (Chrome trace format; open it in Perfetto or
    ``chrome://tracing``).  No-op for a falsy logdir."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
