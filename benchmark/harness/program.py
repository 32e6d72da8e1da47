"""The program's configuration of a cell: the configuration file's
``program`` settings, the cell's overrides on top, at an operating
voltage. ``newton`` and ``linear`` override fields of the program's own
defaults for them."""

from __future__ import annotations

import dataclasses
import importlib


def program_config(cfg, workload, voltage=None):
    """(the entry's module, its configuration object)."""
    mod = importlib.import_module(cfg["entry"]["module"])
    cls = getattr(mod, cfg["entry"]["config"])
    kw = dict(cfg["program"])
    kw.update(workload.get("program", {}))
    defaults = cls()
    for key in ("newton", "linear"):
        if key in kw:
            kw[key] = dataclasses.replace(getattr(defaults, key), **kw[key])
    if kw.get("mesh_resolution") is not None:
        kw["mesh_resolution"] = tuple(kw["mesh_resolution"])
    if voltage is not None:
        kw["voltage_multiplier"] = float(voltage)
    return mod, cls(**kw)
