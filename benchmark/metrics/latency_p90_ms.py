"""90th percentile of the host time of every request completed in the window,
from when the request was due (in a closed loop: its call) to the returned
numpy array (numpy's linear interpolation)."""

import numpy as np

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(rec):
    lat = rec.get("latencies_s")
    return float(np.percentile(np.asarray(lat) * 1e3, 90)) if lat else None
