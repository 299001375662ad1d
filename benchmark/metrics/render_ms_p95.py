"""The 95th percentile of every render's latency in the window, from the
call to the image on the host, in milliseconds (linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
