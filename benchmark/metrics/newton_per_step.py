"""Newton iterations per lane-step (``StepStats.newton_iters``)."""


def read(run):
    if run["lane_steps"]:
        return run["newton_iters"] / run["lane_steps"]
    return None
