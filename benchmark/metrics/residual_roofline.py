"""The pore residual kernel's share of its roofline over one profiled
episode: the mean least time of a launch
(``harness.residual_bounds.pore_residual_bound_s`` at the launch's (C, Q, f,
dtype), from ``ops.COUNTERS``) times the launches the profiler saw, over
their device time.

The profiler drops the records of a long episode's first or last
milliseconds where its device clock has drifted outside the capture
window (Kineto's "Out-of-range" count; on the H100, about a millisecond
over a 30 s episode of the 3D reaction-diffusion pore, whose last residual
launch lies 2-4 ms before the episode's end). So fewer records than
launches read the share of those seen; more records than launches mean
that the kernel's name matched something else, and read nothing."""

from benchmark.harness import profile, residual_bounds

COUNTER, NEEDLE = "pore_residual", "pore_volume_residual_kernel"


def read(run):
    prof = run.get("profile")
    if not prof:
        return None
    launches = prof["launches"].get(COUNTER, {})
    n = sum(launches.values())
    if not n:
        return None
    seconds, seen = profile.kernel_seconds(prof["device"], NEEDLE)
    if not 0 < seen <= n or seconds <= 0:
        return None
    least = sum(count * residual_bounds.pore_residual_bound_s(key)
                for key, count in launches.items())
    return 100.0 * least * seen / n / seconds
