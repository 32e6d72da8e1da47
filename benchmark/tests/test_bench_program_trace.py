"""The program-span readers on synthetic spans and device records:
attribution of device time by correlation id, idle gaps by the span (and
CUDA call) at their middle, the ``none`` class, host self time, and the
six readers, which read nothing where the program has no recorder."""

import importlib
from collections import namedtuple

import pytest

from benchmark.harness import program_trace as pt

Span = namedtuple("Span", "name start_ns end_ns parent step attrs")

#: a step 100..1000 ns: a residual (launches at 110 and 150), a host read
#: inside it (300..400), then a factor (500..700) and a solve with a
#: Krylov child (720..900 / 750..880); a step.update after (1000..1100)
SPANS = [
    Span("step", 100, 1000, -1, 1, {"index": 0, "lanes": 1}),
    Span("assembly.residual", 105, 450, 0, 1, {"kind": "residual"}),
    Span("assembly.residual", 120, 200, 1, 1, {"kind": "residual"}),
    Span("host.read", 300, 400, 1, 1, {}),
    Span("linear.factor", 500, 700, 0, 1, {"kind": "slab_prepare"}),
    Span("linear.solve", 720, 900, 0, 1, {"kind": "slab_apply_f32"}),
    Span("linear.krylov", 750, 880, 5, 1, {"kind": "gmres"}),
    Span("step.update", 1000, 1100, -1, 1, {}),
]
#: CUDA calls (start, end, name, correlation)
CALLS = [
    (110, 115, "cudaLaunchKernel", 1),
    (150, 155, "cudaLaunchKernel", 2),
    (310, 395, "cudaMemcpyAsync", 3),
    (510, 515, "cudaLaunchKernel", 4),
    (760, 765, "cudaLaunchKernel", 5),
    (1010, 1015, "cudaLaunchKernel", 6),
]
#: device operations (start, end, name, correlation): the second runs
#: while the host is in the host read, the last has no launching call
DEVICE = [
    (120, 140, "k_res", 1),
    (300, 390, "k_res2", 2),
    (390, 398, "Memcpy DtoH", 3),
    (520, 620, "getrf", 4),
    (770, 800, "ell_spmv", 5),
    (1020, 1030, "sort", 6),
    (1200, 1210, "stray", 0),
]


def test_owners_join_by_correlation():
    own = pt.owners(DEVICE, CALLS, SPANS)
    names = [SPANS[i].name if i >= 0 else "none" for i in own]
    assert names == ["assembly.residual", "assembly.residual",
                     "host.read", "linear.factor", "linear.krylov",
                     "step.update", "none"]
    # k_res2 ran inside the read, but its launch was in the inner residual
    assert own[1] == 2


def test_device_by_span_and_none():
    by = pt.device_by_span(DEVICE, pt.owners(DEVICE, CALLS, SPANS), SPANS)
    assert by == pytest.approx({
        "assembly.residual": 110e-9, "host.read": 8e-9,
        "linear.factor": 100e-9, "linear.krylov": 30e-9,
        "step.update": 10e-9, "none": 10e-9}, rel=1e-12)


def test_idle_by_span_at_gap_middles():
    by = pt.idle_by_span(DEVICE, CALLS, SPANS)
    # gaps: 140..300 (mid 220: residual), 398..520 (459: step),
    # 620..770 (695: factor), 800..1020 (910: step), 1030..1200 (1115:
    # outside every span); a gap inside a CUDA call is put to the call
    assert by == pytest.approx({
        "assembly.residual": 160e-9, "step": 122e-9 + 220e-9,
        "linear.factor": 150e-9, "none": 170e-9}, rel=1e-12)
    dev = [(300, 320, "a", 0), (380, 390, "b", 0)]
    assert pt.idle_by_span(dev, CALLS, SPANS) == pytest.approx(
        {"host.read/cudaMemcpyAsync": 60e-9})


def test_host_time_counts_nested_assembly_once_less_reads():
    # outer residual 345 ns, less the 100 ns read inside it
    assert pt.host_ms(SPANS, "assembly.") == pytest.approx(245e-6)


def test_innermost_outside_and_inside():
    assert pt.innermost(SPANS, [50, 130, 350, 760, 1050, 2000]) == [
        -1, 2, 3, 6, 7, -1]


class _Trace:
    spans = SPANS
    counts = {"factors.init": 1}


def _data():
    out = {"trace": _Trace(), "device": DEVICE, "calls": CALLS,
           "window_s": 2e-6}
    return {"lane_steps": 4, "factor_builds": 2,
            "program": pt.summary(out, 2)}


EXPECTED = {
    "assembly_device_ms_per_step": 110e-9 * 1e3 / 2,
    "factor_device_ms_per_step": 100e-9 * 1e3 / 2,
    "solve_device_ms_per_step": 30e-9 * 1e3 / 2,
    "assembly_host_ms_per_step": 245e-6 / 2,
    "host_wait_ms_per_step": 100e-6 / 2,
    "factors_per_step": 0.5,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(_data()) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name):
    """A run without the program's recorder (no ``program``, no factor
    counter) gives no number, never 0."""
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read({"lane_steps": 4, "factor_builds": None}) is None
    assert reader.read({"lane_steps": 0, "program": None}) is None


def test_summary_counts_and_unlinked():
    prog = _data()["program"]
    assert prog["unlinked_ops"] == 1
    assert prog["counts"] == {"factors.init": 1}
    assert prog["busy_s"] == pytest.approx(268e-9, rel=1e-12)
    assert prog["device_s"] == pytest.approx(268e-9, rel=1e-12)


def test_no_recorder_no_episode(monkeypatch):
    monkeypatch.setattr(pt, "recorder", lambda: None)
    assert pt.factor_builds() is None
    assert pt.traced_program_episode(None, None, False) == (None, None)
