"""Krylov iterations per lane-step (``StepStats.linear_iters``); nothing
to read on a path that runs no Krylov solve."""


def read(run):
    if run["lane_steps"] and run["linear_iters"]:
        return run["linear_iters"] / run["lane_steps"]
    return None
