"""Build and load the port's CUDA kernels.

The sources under ``gmpnp_tpu_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface, loaded
with ``ctypes``.  The build runs at first use, into ``build/torch_kernels/``
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
SOURCES = (os.path.join(_PKG, "csrc", "ell_spmv.cu"),)
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (name, restype, argtypes) of every C entry point
_SIGNATURES = tuple(
    (name, ctypes.c_int,
     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
     + [ctypes.c_longlong, ctypes.c_void_p])
    for name in ("ell_spmv_f32", "ell_spmv_f64"))

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libgmpnp_torch_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless an up-to-date library exists; returns its
    path.  Raises with nvcc's output when the compile fails."""
    global BUILD_LOG
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_LOG}")
    os.replace(tmp, out)
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
