"""The 95th percentile (nearest rank) of every window request's time from
the call to its answer, on the caller's clock, in ms."""

import math


def read(ctx):
    lat = sorted(ctx.window["latencies"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
