"""End to end: the 95th percentile of the host-clock latency of every frame
completed in the window, every kind of frame, taken once over all of them."""

import numpy as np


def read(run):
    ms = [f["ms"] for f in run["frames"]]
    return float(np.percentile(ms, 95)) if ms else None
