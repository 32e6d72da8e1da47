"""Share of one profiled episode in which no operation ran on the card:
100 (1 - busy / window), busy the union of the device intervals."""


def read(run):
    prof = run.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
