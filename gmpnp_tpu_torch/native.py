"""ctypes bindings for the native mesh/graph engine (native/gmpnp_native.cpp).

Auto-builds the shared library with the repo Makefile on first use when a
compiler is available; all callers fall back to the pure-Python/numpy
implementations when the library is absent, so the framework never *requires*
the native path — it accelerates host-side preprocessing on large meshes
(XML parsing, boundary-facet extraction, adjacency, coloring).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libgmpnp_native.so")

_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.parse_dolfin_xml.restype = ctypes.c_int
    lib.parse_dolfin_xml.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_void_p, ctypes.c_void_p]
    lib.boundary_facets.restype = ctypes.c_int64
    lib.boundary_facets.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.vertex_adjacency_csr.restype = ctypes.c_int64
    lib.vertex_adjacency_csr.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.greedy_color.restype = ctypes.c_int32
    lib.greedy_color.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_dolfin_xml(text: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(points, cells) or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    nv = ctypes.c_int32()
    nc = ctypes.c_int32()
    dim = lib.parse_dolfin_xml(text, len(text), ctypes.byref(nv),
                               ctypes.byref(nc), None, None)
    if dim <= 0:
        raise ValueError("native DOLFIN XML parse failed")
    points = np.empty((nv.value, dim), dtype=np.float64)
    cells = np.empty((nc.value, dim + 1), dtype=np.int32)
    dim2 = lib.parse_dolfin_xml(text, len(text), ctypes.byref(nv),
                                ctypes.byref(nc), _ptr(points), _ptr(cells))
    if dim2 != dim:
        raise ValueError("native DOLFIN XML parse failed (fill pass)")
    return points, cells


def boundary_facets(cells: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc, nvc = cells.shape
    count = lib.boundary_facets(_ptr(cells), nc, nvc, None, None)
    facets = np.empty((count, nvc - 1), dtype=np.int32)
    owners = np.empty(count, dtype=np.int32)
    lib.boundary_facets(_ptr(cells), nc, nvc, _ptr(facets), _ptr(owners))
    return facets, owners


def vertex_adjacency_csr(cells: np.ndarray, n_verts: int):
    lib = _load()
    if lib is None:
        return None
    cells = np.ascontiguousarray(cells, dtype=np.int32)
    nc, nvc = cells.shape
    offsets = np.zeros(n_verts + 1, dtype=np.int64)
    nnz = lib.vertex_adjacency_csr(_ptr(cells), nc, nvc, n_verts,
                                   _ptr(offsets), None)
    cols = np.empty(nnz, dtype=np.int32)
    lib.vertex_adjacency_csr(_ptr(cells), nc, nvc, n_verts,
                             _ptr(offsets), _ptr(cols))
    return offsets, cols


def greedy_color(offsets: np.ndarray, cols: np.ndarray, n_verts: int):
    lib = _load()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    colors = np.empty(n_verts, dtype=np.int32)
    lib.greedy_color(_ptr(offsets), _ptr(cols), n_verts, _ptr(colors))
    return colors
