"""Device-to-host reads per lane-step (the change of ``sync.SYNCS``)."""


def read(run):
    if run["lane_steps"]:
        return run["syncs"] / run["lane_steps"]
    return None
