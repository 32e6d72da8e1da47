"""Factor builds per lane-step over the window: the change of the
program's ``factors.<reason>`` counters (``harness/program_trace.py``'s
``factor_builds``), each build counted per lane."""


def read(run):
    n = run.get("factor_builds")
    if n is None or not run["lane_steps"]:
        return None
    return n / run["lane_steps"]
