"""``metrics/residual_roofline.py`` on synthetic profiles: the pore
residual kernel's launches at the L50R5 mesh (C = 11,520 tets, Q = 4
points) and made-up kernel times."""

import pytest

from benchmark.harness import residual_bounds
from benchmark.metrics import residual_roofline

KERNEL = ("void (anonymous namespace)::pore_volume_residual_kernel<double>"
          "(double const*, double const*, double const*, double, long long "
          "const*, double const*, double const*, double const*, double "
          "const*, double const*, double*, int, int, int, int, long long, "
          "long long)")
RXN = (11520, 4, 7, "float64")


def profile(launches, n_kernels, us=8.0):
    """A profiled episode: n_kernels residual launches of ``us`` each,
    among other kernels of the step."""
    device, t = [], 0.0
    for _ in range(n_kernels):
        device.append((t, t + us, KERNEL))
        device.append((t + us, t + us + 5.0,
                       "segment_sum_packed_kernel<double, 32>"))
        t += 20.0
    return {"profile": {"window_s": 1e-3, "busy_s": 1e-4,
                        "device": device, "launches": launches}}


def test_bytes_of_the_rxn_diff_launch():
    """Cells (8 B), gradients (3 x 8 B) and volumes of 11,520 tets read
    once, the element residuals (4 x 7 x 8 B each) written once; u and
    u_prev left out."""
    C = 11520
    assert residual_bounds.pore_residual_bytes(RXN) == (
        C * 4 * 8 + C * 4 * 3 * 8 + C * 8 + C * 4 * 7 * 8)
    assert residual_bounds.pore_residual_bound_s(RXN) * 1e6 == \
        pytest.approx(1.238, abs=1e-3)


def test_lanes_share_the_tables():
    one = residual_bounds.pore_residual_bytes((11520, 4, 9, "float64"))
    three = residual_bounds.pore_residual_bytes((3, 11520, 4, 9, "float64"))
    assert three - one == 2 * 11520 * 4 * 9 * 8


def test_counts_that_match_give_the_share():
    run = profile({"pore_residual": {RXN: 5}}, 5)
    least = 5 * residual_bounds.pore_residual_bound_s(RXN)
    assert residual_roofline.read(run) == pytest.approx(
        100.0 * least / (5 * 8e-6), rel=1e-12)
    assert 0.0 < residual_roofline.read(run) <= 100.0


@pytest.mark.parametrize("n_kernels", [4, 1])
def test_records_the_profiler_dropped_read_the_seen_launches(n_kernels):
    """Launches whose records fell outside the profiler's window: the
    share of those seen, the same as where every record is there."""
    run = profile({"pore_residual": {RXN: 5}}, n_kernels)
    least = n_kernels * residual_bounds.pore_residual_bound_s(RXN)
    assert residual_roofline.read(run) == pytest.approx(
        100.0 * least / (n_kernels * 8e-6), rel=1e-12)
    assert residual_roofline.read(run) == pytest.approx(
        residual_roofline.read(profile({"pore_residual": {RXN: 5}}, 5)),
        rel=1e-12)


def test_mixed_launches_read_the_mean_least_time():
    three = (3,) + RXN
    run = profile({"pore_residual": {RXN: 2, three: 2}}, 3)
    mean = (2 * residual_bounds.pore_residual_bound_s(RXN)
            + 2 * residual_bounds.pore_residual_bound_s(three)) / 4
    assert residual_roofline.read(run) == pytest.approx(
        100.0 * 3 * mean / (3 * 8e-6), rel=1e-12)


@pytest.mark.parametrize("launches,n_kernels", [
    ({"pore_residual": {RXN: 5}}, 6),       # one extra
    ({"pore_residual": {}}, 0),             # no launch
    ({}, 3),                                # no counter
])
def test_mismatch_or_no_launch_reads_nothing(launches, n_kernels):
    assert residual_roofline.read(profile(launches, n_kernels)) is None


def test_no_profile_reads_nothing():
    assert residual_roofline.read({"profile": None}) is None
