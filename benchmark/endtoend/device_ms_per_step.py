"""Milliseconds in which the card ran some operation (a kernel, a copy or
a set: the union of their intervals, CUPTI's record of the whole window)
per lane-step of the window: the device's cost of the work, which the
host's speed does not move. None without a card."""


def read(w):
    if w["device_busy_s"] is None or not w["recorder"].lane_steps:
        return None
    return 1e3 * w["device_busy_s"] / w["recorder"].lane_steps
