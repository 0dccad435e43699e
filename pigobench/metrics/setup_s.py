"""Seconds from the start of run.py to the window's first frame: imports,
kernel builds, the cascades and the frame pool, and the warm-up."""


def read(ctx):
    return ctx.setup_s
