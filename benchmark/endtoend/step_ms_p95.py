"""95th percentile of the wall time of every step in the window (linear
interpolation between order statistics)."""

import numpy as np


def read(w):
    return 1e3 * float(np.percentile(w["recorder"].step_s, 95))
