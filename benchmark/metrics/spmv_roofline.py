"""The block-ELL kernel's share of its roofline over one profiled episode:
the least time of every launch (``harness.bounds.spmv_bound_s`` at the
launch's shape, from ``ops.COUNTERS``) over the kernel's device time."""

from benchmark.harness import bounds, roofline


def read(run):
    return roofline.share(run, "ell_spmv", "ell_spmv_kernel",
                          bounds.spmv_bound_s)
