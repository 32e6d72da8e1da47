"""The block-inverse kernel's share of its roofline over one profiled
episode: the least time of every launch (``harness.bounds.block_inv_bound_s``
at the launch's (batch, f, dtype), from ``ops.COUNTERS``) over the
kernel's device time. The profiled episode starts cold, so it holds at
least the factor that a carried chord episode builds first."""

from benchmark.harness import bounds, roofline


def read(run):
    return roofline.share(run, "block_inv", "block_inv_kernel",
                          bounds.block_inv_bound_s)
