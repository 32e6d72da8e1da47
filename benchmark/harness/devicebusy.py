"""Device busy seconds over a whole window, from CUPTI's activity records
(``devicebusy.c``): the union of the intervals in which a kernel, a copy
or a set ran on the card.

Unlike ``torch.profiler``, which keeps every host and device event in
Python objects (~24 GB and minutes for one 40 s window of the carried
cell), the collector keeps 16 bytes per operation and reduces them in C.

The collector is built once into ``build/bench_cache/`` inside the
checkout (a file named by the source's hash) and loaded from there after.
It opens the libcupti that PyTorch has loaded, so both use one copy; it
must not run while ``torch.profiler`` does.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SOURCE = os.path.join(HERE, "devicebusy.c")
BUILD_DIR = os.path.join(ROOT, "build", "bench_cache")
FLAGS = ["-O2", "-shared", "-fPIC"]

_lib = None


def library_path():
    with open(SOURCE, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"devicebusy_{h.hexdigest()[:16]}.so")


def _compiler():
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("no C compiler (cc, gcc or nvcc) for the collector")


def build():
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    cc = _compiler()
    flags = FLAGS if not cc.endswith("nvcc") else [
        "-O2", "-shared", "-Xcompiler", "-fPIC"]
    cmd = [cc, *flags, "-o", tmp, SOURCE, "-ldl", "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the collector failed: {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def cupti_path():
    """The libcupti this process has mapped (PyTorch's), else the one
    beside PyTorch, else the CUDA toolkit's."""
    try:
        with open("/proc/self/maps") as fh:
            for line in fh:
                path = line.split()[-1]
                if "libcupti" in os.path.basename(path):
                    return path
    except OSError:
        pass
    import torch

    site = os.path.dirname(os.path.dirname(torch.__file__))
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for pattern in (os.path.join(site, "nvidia", "cuda_cupti", "lib",
                                 "libcupti.so*"),
                    os.path.join(cuda, "extras", "CUPTI", "lib64",
                                 "libcupti.so*")):
        found = sorted(glob.glob(pattern))
        if found:
            return found[0]
    raise RuntimeError("libcupti not found")


def load():
    """(the collector, the libcupti it opened)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.db_open.argtypes = [ctypes.c_char_p]
        lib.db_busy_seconds.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        lib.db_busy_seconds.restype = ctypes.c_double
        lib.db_misread.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_int]
        path = cupti_path()
        if lib.db_open(path.encode()) != 0:
            raise RuntimeError(f"CUPTI's entry points not found in {path}")
        _lib = (lib, path)
    return _lib


#: misread records (an end before the start, or over 100 s long) that a
#: window may hold, per operation recorded: they are left out and listed
MISREAD_SHARE = 1e-5


class Window:
    """``with Window() as w: ...`` records the body's device operations;
    afterwards ``w.busy_s`` is their union in seconds, ``w.ops`` their
    number and ``w.misread`` the first records that could not be placed
    in time ([kind, start ns, end ns]), which are left out. Raises where
    CUPTI refused, dropped a record, recorded nothing, or misread more
    than a share ``MISREAD_SHARE`` of the records."""

    def __enter__(self):
        self._lib = load()[0]
        rc = self._lib.db_start()
        if rc:
            raise RuntimeError(f"CUPTI refused to record (error {rc})")
        return self

    def __exit__(self, *exc):
        rc = self._lib.db_stop()
        info = (ctypes.c_uint64 * 4)()
        self.busy_s = self._lib.db_busy_seconds(info)
        self.ops, self.n_misread, dropped, out_of_memory = list(info)
        listed = (ctypes.c_uint64 * 24)()
        k = self._lib.db_misread(listed, 8)
        self.misread = [list(listed[3 * i:3 * i + 3]) for i in range(k)]
        if exc[0] is None and (
                rc or dropped or out_of_memory or not self.ops
                or self.n_misread > MISREAD_SHARE * self.ops):
            raise RuntimeError(
                f"device record incomplete: CUPTI error {rc}, {self.ops} "
                f"recorded, {self.n_misread} misread {self.misread}, "
                f"{dropped} dropped, out of memory {bool(out_of_memory)}")
        return False
