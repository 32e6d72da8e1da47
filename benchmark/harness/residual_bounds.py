"""The yardstick of the pore residual kernel's roofline, frozen with the
benchmark beside ``bounds.py`` (whose peaks it uses).

The launch key is the program's counter key ``(C, Q, f, dtype)``, or
``(lanes, C, Q, f, dtype)`` over lanes: C tetrahedra, Q quadrature points,
f fields. The bound counts the bytes that the launch has to move whatever
the state: the cells (C x 4 int64), their shape gradients (C x 4 x 3) and
volumes (C), read once and shared by the lanes, and the element residuals
(C x 4 x f per lane), written once. The states u and u_prev, the
quadrature table and the constants are left out, so that it stays a lower
bound; the arithmetic, a few hundred operations an element and field,
lies far under the float64 peak at these bytes.
"""

from __future__ import annotations

from benchmark.harness.bounds import HBM_BYTES_PER_S, ITEMSIZE

INDEX_BYTES = 8


def pore_residual_bytes(key):
    """Bytes read or written once by one launch."""
    lanes, (C, Q, f, dtype) = (key[0], key[1:]) if len(key) == 5 \
        else (1, key)
    size = ITEMSIZE[dtype]
    tables = C * 4 * INDEX_BYTES + C * 4 * 3 * size + C * size
    return tables + lanes * C * 4 * f * size


def pore_residual_bound_s(key):
    """The least time of one launch at the HBM rate."""
    return pore_residual_bytes(key) / HBM_BYTES_PER_S
