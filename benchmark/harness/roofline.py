"""A kernel's share of its roofline from the profiled episode's launches
and device intervals."""

from benchmark.harness import profile


def share(run, counter, needle, bound_s):
    """100 * (sum of the launches' least times) / (the kernel's device
    seconds); None where the episode launched the kernel nowhere, or
    where the profiler saw another number of launches than the counter."""
    prof = run.get("profile")
    if not prof:
        return None
    launches = prof["launches"].get(counter, {})
    n = sum(launches.values())
    if not n:
        return None
    seconds, seen = profile.kernel_seconds(prof["device"], needle)
    if seen != n or seconds <= 0:
        return None
    least = sum(count * bound_s(key) for key, count in launches.items())
    return 100.0 * least / seconds
