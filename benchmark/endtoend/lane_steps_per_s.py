"""Converged lane-steps completed in the window over the window's whole
elapsed seconds (a single transient is one lane; a step that did not
converge is not counted)."""


def read(w):
    return w["recorder"].converged_lane_steps / w["window_s"]
