"""The manifest's form, and that every name in it resolves to its file.

Run from the root of the checkout:
    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import ast
import importlib
import json
import os
import re

import pytest

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def test_keys_and_names():
    m = manifest()
    assert set(m) == KEYS
    assert 1 <= m["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in m[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        own = [n for g, n in names if g == group]
        assert len(own) == len(set(own)), group
    metric_names = [e["name"] for e in m["end_to_end"] + m["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric["unit"]
        assert metric["better"] in ("lower", "higher")
    for cell in m["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] in (1, 4)
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"]
    for cfg in m["configs"]:
        assert all(NAME.match(k) for k in cfg["reduced"])
        assert len(cfg["source"]) <= 200


def test_bounds_and_sources():
    m = manifest()
    names = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in names
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    cells = {c["name"] for c in m["workloads"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in names
        assert set(metric.get("workloads", cells)) <= cells
        if metric["name"].split(".")[0].endswith("_roofline"):
            assert metric["unit"] == "%"
    layers = {}
    for metric in m["per_layer"]:
        assert "\n" not in metric["layer"]
        layers.setdefault(metric["layer"].lower(), set()).add(metric["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [c["name"] for c in manifest()["workloads"]])
def test_cell_resolves(cell):
    """Each cell finds its traffic, configuration, driver and every metric
    reader by name, and every cell reports setup_s, another end-to-end
    metric and a per-layer metric."""
    m = manifest()
    entry = next(c for c in m["workloads"] if c["name"] == cell)
    wl = load("benchmark", "workloads", f"{cell}.json")
    assert wl["config"] == entry["config"]
    cfg_entry = next(c for c in m["configs"] if c["name"] == entry["config"])
    cfg = load(cfg_entry["file"])
    assert cfg["name"] == entry["config"]
    assert set(cfg_entry["reduced"]) <= set(cfg)
    driver = importlib.import_module(f"benchmark.drivers.{wl['driver']}")
    assert hasattr(driver, "Driver")
    importlib.import_module(f"benchmark.reference.models.{cfg['model']}")
    e2e = [x["name"] for x in m["end_to_end"]
           if cell in x.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [x for x in m["per_layer"] if cell in x.get("workloads", [cell])]
    assert layer
    for metric in layer:
        assert metric["moves"] in e2e
    for kind, group in (("end_to_end", e2e), ("per_layer",
                                               [x["name"] for x in layer])):
        for metric in group:
            assert callable(run.reader(kind, metric).read)


@pytest.mark.parametrize("path", sorted(os.listdir(
    os.path.join(ROOT, "benchmark", "workloads"))))
def test_every_workload_file_resolves(path):
    """Every traffic file, in the manifest or kept for later, names a
    configuration file, a driver and a reference model that exist."""
    wl = load("benchmark", "workloads", path)
    cfg = load("benchmark", "configs", f"{wl['config']}.json")
    assert cfg["name"] == wl["config"]
    assert hasattr(importlib.import_module(
        f"benchmark.drivers.{wl['driver']}"), "Driver")
    importlib.import_module(f"benchmark.reference.models.{cfg['model']}")
    assert len(wl["voltages"]) >= 1
    assert set(cfg["checks"]) == {"newton_ratio", "residual_gap",
                                  "start_gap", "unconverged"}


def test_configs_used_and_files_distinct():
    m = manifest()
    used = {c["config"] for c in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(tuple(p + "/" for p in m["paths"]))


def test_command_inside_paths():
    m = manifest()
    assert m["command"][0].startswith("python")
    script = m["command"][1]
    assert script.startswith(tuple(p + "/" for p in m["paths"]))
    assert os.path.exists(os.path.join(ROOT, script))
    ast.parse(open(os.path.join(ROOT, script)).read())
