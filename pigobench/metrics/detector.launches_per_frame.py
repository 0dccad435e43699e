"""Kernels launched on the device per frame over the traced frames (device
trace; copies and sets not counted)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["launches"] == 0:
        return None
    return t["launches"] / t["frames"]
