"""The post stage's enqueue a frame, in ms: the self time of the
program's `post.dispatch` span (eye anchors or the stream's jitter draw,
the uploads, the walks or the frame program, download enqueue) over the
traced frames (lib/spans.py)."""

from pigobench.lib import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("post.dispatch",), "self_seconds")
