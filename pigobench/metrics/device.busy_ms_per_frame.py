"""The union of the device's activity (kernels, copies, sets) over the
traced frames, per frame, in ms (device trace)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["busy_s"] <= 0.0:
        return None
    return t["busy_s"] / t["frames"] * 1e3
