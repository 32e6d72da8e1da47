"""The segment-sum kernel's share of its roofline over one profiled
episode: the least time of every launch (``harness.bounds.segment_bound_s``
at the launch's shape, from ``ops.COUNTERS``) over the kernel's device
time."""

from benchmark.harness import bounds, roofline


def read(run):
    return roofline.share(run, "segment_sum", "segment_sum",
                          bounds.segment_bound_s)
