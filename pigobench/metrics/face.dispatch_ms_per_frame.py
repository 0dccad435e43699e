"""The face stage's enqueue a frame, in ms: the self time of the
program's `face.dispatch` span (plan lookup, staging copy and upload, the
routed launches, compaction, download enqueue) over the traced frames
(lib/spans.py)."""

from pigobench.lib import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("face.dispatch",), "self_seconds")
