"""95th percentile (nearest rank) of the latency of every request sent
in the window."""
import math


def read(ctx):
    lat = sorted(d.done - d.sent for d in ctx.sent)
    if not lat:
        return None
    return 1e3 * lat[max(1, math.ceil(0.95 * len(lat))) - 1]
