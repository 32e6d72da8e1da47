"""``metrics/block_inv_roofline.py`` on synthetic profiles: the launches
of one cyclic-reduction factor at N = 5,991 (batches 4,096 down to 1,
and the top block) and made-up kernel times."""

import pytest

from benchmark.harness import bounds
from benchmark.metrics import block_inv_roofline

KERNEL = ("void block_inv_kernel<double, 7>(double const*, double*, "
          "long long, int)")
#: (batch, f, dtype) -> launches: one factor's 13 levels and its top block
FACTOR = {(2 ** k, 7, "float64"): 1 for k in range(1, 13)}
FACTOR[(1, 7, "float64")] = 2


def profile(launches, n_kernels, us=2.0):
    """A profiled episode: n_kernels block inverses of ``us`` each, among
    other kernels of the step."""
    device, t = [], 0.0
    for k in range(n_kernels):
        device.append((t, t + us, KERNEL))
        device.append((t + us, t + us + 5.0,
                       "segment_sum_packed_kernel<double, 32>"))
        t += 10.0
    return {"profile": {"window_s": 1e-3, "busy_s": 1e-4,
                        "device": device, "launches": launches}}


def test_counts_that_match_give_the_share():
    n = sum(FACTOR.values())
    run = profile({"block_inv": dict(FACTOR), "segment_sum": {}}, n)
    least = sum(c * bounds.block_inv_bound_s(k) for k, c in FACTOR.items())
    assert block_inv_roofline.read(run) == pytest.approx(
        100.0 * least / (n * 2e-6), rel=1e-12)
    assert 0.0 < block_inv_roofline.read(run) <= 100.0


def test_bound_of_the_largest_level():
    """The frozen bound at the factor's first level is the kernel table's
    (4,096, 7, 7) f64 row: bound by bytes."""
    assert bounds.block_inv_bound_s((4096, 7, "float64")) * 1e6 == \
        pytest.approx(0.959, abs=1e-3)


@pytest.mark.parametrize("launches,n_kernels", [
    ({"block_inv": dict(FACTOR)}, sum(FACTOR.values()) - 1),  # one unseen
    ({"block_inv": dict(FACTOR)}, sum(FACTOR.values()) + 1),  # one extra
    ({"block_inv": {}}, 0),                                   # no launch
    ({}, 3),                                                  # no counter
])
def test_mismatch_or_no_launch_reads_nothing(launches, n_kernels):
    assert block_inv_roofline.read(profile(launches, n_kernels)) is None


def test_no_profile_reads_nothing():
    assert block_inv_roofline.read({"profile": None}) is None
