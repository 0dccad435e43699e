"""The share of the traced segment in which nothing ran on the device, in %
(device trace)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
