"""Frames answered in the window over the window's seconds, from its start
to the last answer (host clock)."""


def read(ctx):
    w = ctx.window
    return w["answers"] / w["seconds"] if w["answers"] else None
