"""Wall ms per lane-step in the linear solvers the time loop calls (slab
factor and apply, GMRES, the 1D cyclic-reduction factor and solve), each
span ended in a synchronize, over the round that a traced run adds
after the window."""


def read(run):
    if run["span_lane_steps"] and run["span_calls"]["linear"]:
        return run["span_s"]["linear"] * 1e3 / run["span_lane_steps"]
    return None
