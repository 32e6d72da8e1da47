"""Build and load the port's CUDA kernels.

The sources under ``gmpnp_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, into ``build/torch_kernels/``
at the root of the checkout; the library's name carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing is fetched: ``nvcc`` comes from ``PATH`` or the CUDA
toolkit under ``$CUDA_HOME`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
SOURCES = tuple(os.path.join(_PKG, "csrc", name) for name in (
    "ell_spmv.cu", "segment_sum.cu", "block_inv.cu", "pore_residual.cu",
    "sechenov.cu", "cr_apply.cu"))
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: flags of each source's compile (-Xptxas -v: registers, shared memory and
#: spills of every kernel in BUILD_LOG) and of the link
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (name, restype, argtypes) of every C entry point
_SIGNATURES = (
    # u, u_prev, dt_lanes, dt_value, cells, gradN, vols, Nq, wq, consts,
    # out, n_cells, Q, f, lanes, lane_state, lane_out, stream
    ("pore_volume_residual_f64", ctypes.c_int,
     [_P] * 3 + [ctypes.c_double] + [_P] * 7 + [_LL, _I, _I, _I, _LL, _LL,
                                               _P]),
    # u, out, medians, n, f, consts (host doubles), stream
    ("sechenov_co2_f64", ctypes.c_int,
     [_P] * 3 + [_LL, _I, ctypes.POINTER(ctypes.c_double), _P]),
) + tuple(
    (f"{kernel}_{t}", ctypes.c_int, argtypes)
    for kernel, argtypes in (
        # flat, adj, x, y, N, K, f, tile, mode, lanes, lane_stride, stream
        ("ell_spmv", [_P] * 4 + [_I] * 6 + [_LL, _P]),
        # values, order, start, end, out, n_dest, d, lanes, lane_values,
        # lane_out, rows_per_warp, depth, stream
        ("segment_sum", [_P] * 5 + [_LL, _I, _I, _LL, _LL, _I, _I, _P]),
        # A, out, batch, f, blocks_per_warp, stream
        ("block_inv", [_P, _P, _LL, _I, _I, _P]),
        # ptrs, strides, levels, rhs, out, ws, n, f, lanes, cluster, tail,
        # stream
        ("cr_apply", [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]))
    for t in ("f32", "f64"))

_lib = None
#: what the last build in this process printed (empty when the library
#: came from an earlier build)
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME) to build")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libgmpnp_torch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless an up-to-date library exists; returns its
    path.  Raises with nvcc's output when a compile or the link fails."""
    global BUILD_LOG
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in SOURCES:
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], None
    for cmd, _, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed is None:
            cmd = [nvcc, *LINK_FLAGS, "-o", f"{tmp}.so", *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed = (cmd, proc.returncode)
        BUILD_LOG = "".join(logs)
        if failed is not None:
            raise RuntimeError(f"nvcc failed ({failed[1]}):\n"
                               f"{' '.join(failed[0])}\n{BUILD_LOG}")
        os.replace(f"{tmp}.so", out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return out


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, restype, argtypes in _SIGNATURES:
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib
