"""sweep_ms_p95: request_ms_p95 as the traced run reads it, for the sweep
cell, whose runs spread too widely for request_ms_p95 to hold a bound end
to end: the 95th percentile (linear interpolation) of every call of the
window from its start to its counts on the host, the profiled stretch's
calls left out; in ms."""

import numpy as np

UNIT = "ms"


def read(t):
    u = t.untraced
    if not u or not u["lat_ms"]:
        return None
    return float(np.percentile(np.asarray(u["lat_ms"], dtype=np.float64), 95))
