"""90th percentile of submit-to-result time over every request that
finished in the window, in ms."""
import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 90.0)) * 1e3
