"""The port's spans and counters, and ``torch.profiler`` traces that hold
both.

A span marks where the host is: ``with span("assembly.residual"): ...``,
or ``@span("linear.factor")`` on a function (the span then carries the
function's name as its ``kind``).  Spans are off by default.
``tracing()`` turns them on for its body and hands back what they
recorded; ``trace_profile(logdir)`` does the same under
``torch.profiler`` and writes the spans into the profiler's
``trace.json``, beside the card's operations.

Off, a span costs one test of a module-level flag, made when the span
opens: no clock read, no record, no device call (a span with attributes
makes one small object, the carrier of its attributes).  On, a span reads
the host clock twice and appends one record; it never synchronises,
reads the card or launches, so what the program computes is the same bit
for bit with tracing on or off.

Each span records its name, start and end in ns, the index of its parent
(the innermost span open when it opened; -1 at the top), the id of its
time step (``begin_step``, in ``solve.timeloop.run_transient``: every
span of one step shares it; 0 outside every step) and its attributes.

Clock: ``time.time_ns()``, CLOCK_REALTIME, the clock on which
``torch.profiler`` stamps its host records (its CUDA runtime calls and
host operations), so a span and a kernel's launch record can be compared
without an offset.  The card test
``tests/test_torch_profiling.py::test_spans_share_the_profilers_clock``
checks it on the H100: a kernel's launch record lies inside the span that
launched it, and its end inside the span that synchronised after it.

``count(name, n)`` adds to ``COUNTS``, always (an integer add, as
``sync.SYNCS`` and ``ops.COUNTERS`` are).  Two families, both of
``solve.timeloop``: the factor builds, per lane and by reason:
``factors.init``, ``factors.fallback`` and ``factors.refresh`` of the
carried chord step, ``factors.step`` and ``factors.iter`` of the refresh
modes; and the carried step's abandoned chord attempts: ``chord.failed``,
with their Newton and Krylov iterations in ``chord.failed_iters`` and
``chord.failed_krylov``.  A trace
reads these counters, ``sync.SYNCS`` / ``READS`` and the kernels' launches
(``ops.COUNTERS``) at its start and end, and keeps the differences.

Spans are recorded by the thread that runs the transient; the port runs
one.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
from time import time_ns as _now
from typing import Dict, List, NamedTuple, Optional

#: on while a ``tracing()`` context is open
_ON = False
#: records of the open trace, [name, start_ns, end_ns, parent, step, attrs]
_RECORDS: list = []
#: indices in ``_RECORDS`` of the spans open now, innermost last
_STACK: List[int] = []
#: the id of the time step in progress (0: none) and the last id given
_STEP = 0
_LAST_STEP = 0

#: always-on counters: name -> running total
COUNTS: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (whether tracing is on or off)."""
    COUNTS[name] = COUNTS.get(name, 0) + n


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    #: index of the enclosing span in the same trace, -1 at the top
    parent: int
    #: time step id, shared by the spans of one step; 0 outside steps
    step: int
    attrs: dict


class _Open:
    """A span while tracing is on."""
    __slots__ = ("name", "attrs", "rec")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rec = [self.name, 0, 0, _STACK[-1] if _STACK else -1, _STEP,
                    self.attrs]
        _STACK.append(len(_RECORDS))
        _RECORDS.append(self.rec)
        self.rec[1] = _now()
        return self

    def __exit__(self, *exc):
        self.rec[2] = _now()
        if _STACK:
            _STACK.pop()
        return False

    def __call__(self, fn):
        return _Off(self.name, self.attrs)(fn)


class _Off:
    """A span while tracing is off: it records nothing; as a decorator it
    wraps the function in a span that tests the flag on every call."""
    __slots__ = ("name", "attrs")

    def __init__(self, name, attrs=None):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name
        attrs = dict(self.attrs or {}, kind=fn.__name__)

        @functools.wraps(fn)
        def spanned(*args, **kw):
            if not _ON:
                return fn(*args, **kw)
            with _Open(name, attrs):
                return fn(*args, **kw)
        return spanned


_OFF: Dict[str, _Off] = {}


def span(name: str, **attrs):
    """A span named ``name``: a context manager, or a decorator (whose
    spans carry the function's name as ``kind``).  Records only while
    tracing is on."""
    if _ON:
        return _Open(name, attrs)
    if attrs:
        return _Off(name, attrs)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def begin_step() -> int:
    """Give the spans opened from now on a new time step id; returns the
    id in force before, for ``end_step``."""
    global _STEP, _LAST_STEP
    if not _ON:
        return 0
    prev = _STEP
    _LAST_STEP += 1
    _STEP = _LAST_STEP
    return prev


def end_step(prev: int) -> None:
    """Restore the step id that ``begin_step`` returned."""
    global _STEP
    if _ON:
        _STEP = prev


def _counters() -> Dict[str, int]:
    from gmpnp_tpu_torch import ops, sync

    out = {"host.syncs": sync.SYNCS, "host.reads": sync.READS}
    for kernel, (by_dtype, _) in ops.COUNTERS.items():
        out[f"launches.{kernel}"] = sum(by_dtype.values())
    out.update(COUNTS)
    return out


class Trace:
    """What one ``tracing()`` context recorded: ``spans`` (``Span``, in
    the order they opened; a parent comes before its children),
    ``counts`` (each counter's change over the context) and the context's
    ``start_ns`` / ``end_ns`` on the spans' clock."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.start_ns = self.end_ns = 0

    def self_ns(self) -> List[int]:
        """Each span's duration less its children's."""
        own = [s.end_ns - s.start_ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                own[s.parent] -= s.end_ns - s.start_ns
        return own

    def totals(self) -> Dict[str, dict]:
        """Per name: ``calls``, ``total_ns`` and ``self_ns``."""
        out: Dict[str, dict] = {}
        for s, own in zip(self.spans, self.self_ns()):
            t = out.setdefault(s.name, {"calls": 0, "total_ns": 0,
                                        "self_ns": 0})
            t["calls"] += 1
            t["total_ns"] += s.end_ns - s.start_ns
            t["self_ns"] += own
        return out

    def report(self) -> str:
        """One line per span name, by host self time."""
        tot = self.totals()
        lines = []
        for name in sorted(tot, key=lambda k: -tot[k]["self_ns"]):
            t = tot[name]
            lines.append(f"{name:20s} {t['self_ns'] * 1e-9:9.3f} s self "
                         f"{t['total_ns'] * 1e-9:9.3f} s total "
                         f"({t['calls']} calls)")
        return "\n".join(lines)


@contextlib.contextmanager
def tracing():
    """Record spans for the body; yields a ``Trace``, filled in when the
    body ends.  A trace opened inside another gets the spans of its own
    body."""
    global _ON, _RECORDS, _STACK, _STEP
    trace = Trace()
    outer = _ON
    if not outer:
        _RECORDS, _STACK, _STEP = [], [], 0
    first = len(_RECORDS)
    before = _counters()
    _ON = True
    trace.start_ns = _now()
    try:
        yield trace
    finally:
        trace.end_ns = _now()
        _ON = outer
        after = _counters()
        trace.counts = {k: v - before.get(k, 0) for k, v in after.items()
                        if v - before.get(k, 0)}
        trace.spans = [
            Span(r[0], r[1], r[2] or trace.end_ns,
                 r[3] - first if r[3] >= first else -1, r[4], r[5])
            for r in _RECORDS[first:]]
        if not outer:
            _RECORDS, _STACK = [], []


def _span_events(trace: Trace, base_ns: int, pid: int) -> list:
    """The trace's spans as Chrome-trace complete events on one row."""
    tid = 0
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "gmpnp_tpu_torch spans"}}]
    for s in trace.spans:
        args = {k: v if isinstance(v, (int, float, str, bool)) else str(v)
                for k, v in s.attrs.items()}
        args["step"] = s.step
        events.append({"ph": "X", "cat": "gmpnp_span", "name": s.name,
                       "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base_ns) * 1e-3,
                       "dur": (s.end_ns - s.start_ns) * 1e-3, "args": args})
    return events


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the enclosed work (host and,
    when a CUDA device is present, card activity) with the program's
    spans on, and write both to ``<logdir>/trace.json`` (Chrome trace
    format; open it in Perfetto or ``chrome://tracing``): the spans are a
    row of their own, on the profiler's clock.  Yields the ``Trace``; a
    no-op yielding None for a falsy logdir."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=acts) as prof:
        with tracing() as trace:
            yield trace
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    doc["traceEvents"].extend(_span_events(
        trace, int(doc.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as fh:
        json.dump(doc, fh)
