"""The yardstick of the kernels' rooflines, frozen with the benchmark.

The least time one H100 could take for a launch: every input byte read
once and every output byte written once at the memory rate, or the
operations at the peak rate of their type, whichever is larger. Peaks are
NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s of
HBM3, 67 TFLOP/s in float32 outside the tensor cores, 34 TFLOP/s in
float64 outside them. The arithmetic is that of the port's kernel checks
as the benchmark was written; it stays here when those move.

Shapes are the launch keys the program's counters use: ``(N, K, f,
dtype)`` or ``(lanes, N, K, f, dtype)`` for the block-ELL product,
``(M, n_dest, d, dtype)`` or ``(lanes, M, n_dest, d, dtype)`` for the
segment sum, ``(batch, f, dtype)`` for the block inverse.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def _lanes(key, n):
    """(lanes, rest) of a launch key whose plain form has n entries."""
    return (key[0], key[1:]) if len(key) == n + 1 else (1, key)


def _bound(nbytes, ops, dtype):
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def spmv_bound_s(key):
    """One block-ELL product y = A x: the lanes' blocks, x and y, and the
    shared adjacency once; 2 N f K f operations per lane."""
    lanes, (N, K, f, dtype) = _lanes(key, 4)
    size = ITEMSIZE[dtype]
    nbytes = lanes * (N * f * K * f * size + 2 * N * f * size) + N * K * 4
    return _bound(nbytes, 2 * lanes * N * f * K * f, dtype)


def segment_bound_s(key):
    """One sorted-segment sum of M rows of width d onto n_dest rows: every
    value, the order table (M entries) and the segment bounds (2 n_dest),
    8 bytes each, and the output once; M d additions per lane."""
    lanes, (M, n_dest, d, dtype) = _lanes(key, 4)
    size = ITEMSIZE[dtype]
    nbytes = lanes * (M + n_dest) * d * size + (M + 2 * n_dest) * 8
    return _bound(nbytes, lanes * M * d, dtype)


def block_inv_bound_s(key):
    """A batch of f x f inverses: every block read and written once, or
    2 f^2 (2 f - 1) operations per block."""
    batch, f, dtype = key
    size = ITEMSIZE[dtype]
    return _bound(2 * batch * f * f * size, batch * 2 * f * f * (2 * f - 1),
                  dtype)
