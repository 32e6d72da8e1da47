"""Minimal VTK (legacy + XML VTU) writers for 3D field export.

Replaces the reference's ``File('solution_<sp>.pvd') << u`` VTK dumps
(3D/MPNP_CO2ER_pore.py:862-880) without the dolfin io stack.  Produces
ASCII .vtu files (one per field or multi-field) readable by ParaView, plus a
trivial .pvd wrapper for drop-in compatibility with reference tooling.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

_VTK_CELL = {1: 3, 2: 5, 3: 10}  # line, triangle, tetra


def write_vtu(path: str, points: np.ndarray, cells: np.ndarray,
              point_data: Dict[str, np.ndarray]) -> None:
    points = np.asarray(points, dtype=np.float64)
    cells = np.asarray(cells)
    N, dim = points.shape
    C, nv = cells.shape
    xyz = np.zeros((N, 3))
    xyz[:, :dim] = points
    ctype = _VTK_CELL[dim]

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{N}" NumberOfCells="{C}">\n')
        f.write("      <Points>\n")
        f.write('        <DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        for p in xyz:
            f.write(f"          {p[0]:.15e} {p[1]:.15e} {p[2]:.15e}\n")
        f.write("        </DataArray>\n      </Points>\n")
        f.write("      <Cells>\n")
        f.write('        <DataArray type="Int32" Name="connectivity" '
                'format="ascii">\n')
        for c in cells:
            f.write("          " + " ".join(str(int(v)) for v in c) + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="Int32" Name="offsets" format="ascii">\n')
        f.write("          " + " ".join(str((i + 1) * nv) for i in range(C)) + "\n")
        f.write("        </DataArray>\n")
        f.write('        <DataArray type="UInt8" Name="types" format="ascii">\n')
        f.write("          " + " ".join(str(ctype) for _ in range(C)) + "\n")
        f.write("        </DataArray>\n      </Cells>\n")
        f.write("      <PointData>\n")
        for name, arr in point_data.items():
            arr = np.asarray(arr, dtype=np.float64).reshape(N, -1)
            ncomp = arr.shape[1]
            f.write(f'        <DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            for row in arr:
                f.write("          " + " ".join(f"{v:.15e}" for v in row) + "\n")
            f.write("        </DataArray>\n")
        f.write("      </PointData>\n")
        f.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


def write_pvd(path: str, vtu_relpath: str) -> None:
    """Single-timestep .pvd wrapper (matches the reference's final-state
    export pattern)."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="Collection" version="0.1">\n')
        f.write("  <Collection>\n")
        f.write(f'    <DataSet timestep="0" part="0" file="{vtu_relpath}" />\n')
        f.write("  </Collection>\n</VTKFile>\n")
