"""The metric arithmetic on a recorded fixture: the readers, the frozen
bounds and the profiler reductions."""

import importlib
import shutil
import subprocess
import types

import pytest

from benchmark import run as bench_run
from benchmark.harness import bounds, devicebusy, profile

#: a traced run as run.py hands it to the readers (numbers recorded from a
#: small pore sweep on the CPU, with a made-up device trace)
FIXTURE = {
    "lane_steps": 6, "newton_iters": 32, "linear_iters": 96, "syncs": 48,
    "span_lane_steps": 6,
    "span_s": {"assembly": 1.8, "linear": 0.6},
    "span_calls": {"assembly": 40, "linear": 30},
    "profile": {
        "window_s": 0.010,
        "busy_s": 0.004,
        "device": [(0.0, 1000.0, "void ell_spmv_kernel<double, 9, 1>"),
                   (1000.0, 1500.0, "segment_sum_packed_kernel<double, 32>"),
                   (2000.0, 4000.0, "void ell_spmv_kernel<double, 9, 1>"),
                   (5000.0, 5500.0, "void segment_sum_kernel<double, 1>")],
        "launches": {"ell_spmv": {(3, 2501, 15, 9, "float64"): 2},
                     "segment_sum": {(46080, 2501, 9, "float64"): 1,
                                     (184320, 37515, 81, "float64"): 1}},
    },
}

EXPECTED = {
    "newton_per_step": 32 / 6,
    "host_syncs_per_step": 8.0,
    "krylov_per_step": 16.0,
    "assembly_ms_per_step": 300.0,
    "linear_ms_per_step": 100.0,
    "device_idle": 60.0,
    "spmv_roofline": 100.0 * 2 * bounds.spmv_bound_s(
        (3, 2501, 15, 9, "float64")) / 3e-3,
    "segsum_roofline": 100.0 * (
        bounds.segment_bound_s((46080, 2501, 9, "float64"))
        + bounds.segment_bound_s((184320, 37515, 81, "float64"))) / 1e-3,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(FIXTURE) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name):
    """Nothing to read gives no number, never 0."""
    empty = {"lane_steps": 0, "newton_iters": 0, "linear_iters": 0,
             "syncs": 0, "span_lane_steps": 0, "span_s": {"assembly": 0.0, "linear": 0.0},
             "span_calls": {"assembly": 0, "linear": 0}, "profile": None}
    reader = importlib.import_module(f"benchmark.metrics.{name}")
    assert reader.read(empty) is None


def test_roofline_needs_matching_launches():
    run = dict(FIXTURE, profile=dict(FIXTURE["profile"], launches={
        "ell_spmv": {(3, 2501, 15, 9, "float64"): 3}}))
    reader = importlib.import_module("benchmark.metrics.spmv_roofline")
    assert reader.read(run) is None


def test_bounds_match_the_kernel_table():
    """The frozen arithmetic gives the bounds PERF.md's kernel table lists
    (microseconds, all bound by bytes)."""
    assert bounds.spmv_bound_s((2501, 15, 9, "float32")) * 1e6 == \
        pytest.approx(3.727, abs=1e-3)
    assert bounds.spmv_bound_s((3, 2501, 15, 9, "float64")) * 1e6 == \
        pytest.approx(22.137, abs=1e-3)
    assert bounds.segment_bound_s((184320, 37515, 81, "float64")) * 1e6 == \
        pytest.approx(43.530, abs=1e-3)
    assert bounds.segment_bound_s((46080, 2501, 9, "float64")) * 1e6 == \
        pytest.approx(1.166, abs=1e-3)
    assert bounds.block_inv_bound_s((2501, 9, "float64")) * 1e6 == \
        pytest.approx(0.968, abs=1e-3)


def test_profile_reductions():
    iv = [(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "a")]
    assert profile.union_seconds(iv) == pytest.approx(30e-6)
    assert profile.gaps(iv) == [(20.0, 30.0)]
    host = [(0.0, 100.0, "outer"), (18.0, 35.0, "aten::item")]
    assert profile.idle_by_host(iv, host) == [["aten::item",
                                               pytest.approx(10e-6)]]
    assert profile.top_device_ops(iv)[0] == ["a", pytest.approx(20e-6)]
    assert profile.kernel_seconds(iv, "a") == (pytest.approx(20e-6), 2)


def test_device_ms_per_step():
    reader = bench_run.reader("end_to_end", "device_ms_per_step")
    rec = types.SimpleNamespace(lane_steps=4000)
    assert reader.read({"device_busy_s": 4.4, "recorder": rec}) == \
        pytest.approx(1.1, rel=1e-12)
    assert reader.read({"device_busy_s": None, "recorder": rec}) is None


@pytest.mark.parametrize("kind,name,module", [
    ("end_to_end", "lane_steps_per_s", "benchmark.endtoend.lane_steps_per_s"),
    ("per_layer", "newton_per_step.carried",
     "benchmark.metrics.newton_per_step"),
    ("per_layer", "step_ms_p95.carried", "benchmark.endtoend.step_ms_p95"),
])
def test_reader_by_base_name(kind, name, module):
    """A metric is read by the file of its name up to the first dot; a
    per-layer metric falls back to the end-to-end readers."""
    assert bench_run.reader(kind, name).__name__ == module


def test_reader_missing():
    with pytest.raises(ModuleNotFoundError):
        bench_run.reader("end_to_end", "newton_per_step")


#: a stand-in for libcupti with CUPTI's ABI: each flush hands the
#: collector one buffer of 32-byte records (kind, start at 16, end at 24)
FAKE_CUPTI = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
typedef void (*req_t)(uint8_t **, size_t *, size_t *);
typedef void (*done_t)(void *, uint32_t, uint8_t *, size_t, size_t);
static req_t req; static done_t done; static int enabled;
static uint64_t recs[64][3]; static int n_recs;
void fake_add(uint32_t kind, uint64_t s, uint64_t e) {
    recs[n_recs][0] = kind; recs[n_recs][1] = s; recs[n_recs][2] = e;
    n_recs++;
}
int cuptiActivityRegisterCallbacks(req_t r, done_t d) {
    req = r; done = d; return 0;
}
int cuptiActivityEnable(int k) { (void)k; enabled = 1; return 0; }
int cuptiActivityDisable(int k) { (void)k; enabled = 0; return 0; }
int cuptiActivityFlushAll(uint32_t f) {
    uint8_t *buf; size_t size, max, valid = 32 * (size_t)n_recs; int i;
    (void)f;
    if (!n_recs) return 0;
    req(&buf, &size, &max);
    memset(buf, 0, valid);
    for (i = 0; i < n_recs; i++) {
        uint32_t kind = (uint32_t)recs[i][0];
        memcpy(buf + 32 * i, &kind, 4);
        memcpy(buf + 32 * i + 16, &recs[i][1], 8);
        memcpy(buf + 32 * i + 24, &recs[i][2], 8);
    }
    n_recs = 0;
    done(NULL, 0, buf, size, valid);
    return 0;
}
int cuptiActivityGetNextRecord(uint8_t *buf, size_t valid, void **rec) {
    uint8_t *next = *rec ? (uint8_t *)*rec + 32 : buf;
    if (next >= buf + valid) return 1;
    *rec = next; return 0;
}
"""


def test_device_busy_collector(tmp_path, monkeypatch):
    """The collector's record reading and union, against a stand-in for
    libcupti: overlapping kernels count once, copies and sets count,
    other kinds do not, and a record that ends before it starts is
    refused."""
    cc = shutil.which("cc") or shutil.which("gcc")
    assert cc, "the collector is built with the system's C compiler"
    src, fake = tmp_path / "fake.c", tmp_path / "libfakecupti.so"
    src.write_text(FAKE_CUPTI)
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(fake), str(src)],
                   check=True)
    monkeypatch.setattr(devicebusy, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(devicebusy, "cupti_path", lambda: str(fake))
    monkeypatch.setattr(devicebusy, "_lib", None)
    import ctypes

    add = ctypes.CDLL(str(fake)).fake_add
    add.argtypes = [ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64]
    with devicebusy.Window() as w:
        add(10, 1000, 3000)         # kernel
        add(10, 2000, 4000)         # overlapping kernel
        add(1, 6000, 6500)          # copy
        add(2, 7000, 7100)          # set
        add(5, 0, 100000)           # a runtime call: not the device's
    assert w.ops == 4 and w.n_misread == 0
    assert w.busy_s == pytest.approx(3600e-9, rel=1e-12)
    # a misread record is left out and listed, within a share of the rest
    share = devicebusy.MISREAD_SHARE
    monkeypatch.setattr(devicebusy, "MISREAD_SHARE", 2.0)
    with devicebusy.Window() as w:
        add(10, 1000, 2000)
        add(10, 5000, 4000)
        add(1, 0, 200000000000)
    assert (w.ops, w.n_misread) == (1, 2)
    assert w.misread == [[10, 5000, 4000], [1, 0, 200000000000]]
    assert w.busy_s == pytest.approx(1000e-9, rel=1e-12)
    monkeypatch.setattr(devicebusy, "MISREAD_SHARE", share)
    with pytest.raises(RuntimeError, match="1 misread"):
        with devicebusy.Window():
            add(10, 1000, 2000)
            add(10, 5000, 4000)
    with pytest.raises(RuntimeError, match="0 recorded"):
        with devicebusy.Window():
            pass
