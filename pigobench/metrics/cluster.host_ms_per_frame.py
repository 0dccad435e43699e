"""Host clustering a frame, in ms: the self time of the program's
`cluster.host` span around `cluster_detections` over the traced frames
(lib/spans.py)."""

from pigobench.lib import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("cluster.host",), "self_seconds")
