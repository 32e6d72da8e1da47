"""Wall ms per lane-step in residual and Jacobian assembly: the spans
around ``FemSpace.residual``, ``jacobian``, ``residual_lanes`` and
``jacobian_lanes``, each ended in a synchronize, over the round that a
traced run adds after the window."""


def read(run):
    if run["span_lane_steps"] and run["span_calls"]["assembly"]:
        return run["span_s"]["assembly"] * 1e3 / run["span_lane_steps"]
    return None
