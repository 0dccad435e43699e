"""The device stream's frame programs that ran as CUDA graph replays, in
%: 100 times the program's counter `stream.graph_replays` (a frame whose
face stage and frame program were each one replay) over
`stream.dispatches` (frame programs dispatched, the ladder's
re-dispatches included) in the traced frames (lib/spans.py)."""

from pigobench.lib import spans


def read(ctx):
    return spans.share(ctx, "stream.graph_replays", "stream.dispatches")
