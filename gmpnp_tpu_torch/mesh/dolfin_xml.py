"""DOLFIN XML mesh IO.

Reads the reference's mesh format (``utilities/*.xml``, ``*.xml.gz``):
interval meshes (1D EDL / rxn-diff, ref 1D/MPNP_CO2ER_EDL.py:231-234) and
tetrahedral cylinder meshes (3D pore, ref 3D/MPNP_CO2ER_pore.py:329-332).
A writer is provided so generated meshes interoperate with FEniCS tooling.

A fast C++ parser lives in native/ (used automatically when built); this
pure-Python expat path is the always-available fallback and the correctness
oracle.
"""

from __future__ import annotations

import gzip
import xml.parsers.expat
from typing import Optional

import numpy as np

from gmpnp_tpu_torch.mesh.core import Mesh, fix_cell_orientation

_CELL_ATTRS = {
    "interval": ("v0", "v1"),
    "triangle": ("v0", "v1", "v2"),
    "tetrahedron": ("v0", "v1", "v2", "v3"),
}
_CELL_DIM = {"interval": 1, "triangle": 2, "tetrahedron": 3}


def read_dolfin_xml(path: str) -> Mesh:
    """Parse a DOLFIN XML (optionally gzipped) mesh file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()

    # fast path: native C++ parser (falls through to expat when absent)
    try:
        from gmpnp_tpu_torch import native
        parsed = native.parse_dolfin_xml(data)
    except Exception:
        parsed = None
    if parsed is not None:
        points, cells = parsed
        cells = fix_cell_orientation(points, cells)
        return Mesh(points=points, cells=cells).with_boundary()

    state = {
        "celltype": None,
        "dim": None,
        "points": None,
        "cells": None,
    }

    def start(name, attrs):
        if name == "mesh":
            state["celltype"] = attrs["celltype"]
            state["dim"] = int(attrs["dim"])
        elif name == "vertices":
            n = int(attrs["size"])
            state["points"] = np.empty((n, state["dim"]), dtype=np.float64)
        elif name == "vertex":
            i = int(attrs["index"])
            p = state["points"]
            p[i, 0] = float(attrs["x"])
            if state["dim"] > 1:
                p[i, 1] = float(attrs["y"])
            if state["dim"] > 2:
                p[i, 2] = float(attrs["z"])
        elif name == "cells":
            n = int(attrs["size"])
            nv = _CELL_DIM[state["celltype"]] + 1
            state["cells"] = np.empty((n, nv), dtype=np.int32)
        elif name in _CELL_ATTRS:
            i = int(attrs["index"])
            row = state["cells"][i]
            for j, a in enumerate(_CELL_ATTRS[name]):
                row[j] = int(attrs[a])

    parser = xml.parsers.expat.ParserCreate()
    parser.StartElementHandler = start
    parser.Parse(data, True)

    if state["points"] is None or state["cells"] is None:
        raise ValueError(f"no mesh found in {path}")

    cells = fix_cell_orientation(state["points"], state["cells"])
    return Mesh(points=state["points"], cells=cells).with_boundary()


def write_dolfin_xml(mesh: Mesh, path: str) -> None:
    """Write a mesh in DOLFIN XML format (gzipped if path ends in .gz)."""
    celltype = {1: "interval", 2: "triangle", 3: "tetrahedron"}[mesh.dim]
    coords = ("x", "y", "z")[: mesh.dim]
    vattrs = _CELL_ATTRS[celltype]

    lines = ['<?xml version="1.0"?>']
    lines.append('<dolfin xmlns:dolfin="http://fenicsproject.org">')
    lines.append(f'  <mesh celltype="{celltype}" dim="{mesh.dim}">')
    lines.append(f'    <vertices size="{mesh.num_vertices}">')
    for i, p in enumerate(mesh.points):
        attrs = " ".join(
            f'{c}="{v:.15e}"' for c, v in zip(coords, p))
        lines.append(f'      <vertex index="{i}" {attrs} />')
    lines.append("    </vertices>")
    lines.append(f'    <cells size="{mesh.num_cells}">')
    for i, cell in enumerate(mesh.cells):
        attrs = " ".join(f'{a}="{v}"' for a, v in zip(vattrs, cell))
        lines.append(f'      <{celltype} index="{i}" {attrs} />')
    lines.append("    </cells>")
    lines.append("  </mesh>")
    lines.append("</dolfin>")
    text = "\n".join(lines).encode()

    if str(path).endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(text)
    else:
        with open(path, "wb") as f:
            f.write(text)
