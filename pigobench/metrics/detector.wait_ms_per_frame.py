"""How long the host blocked on the card a frame, in ms: the summed
durations of the program's wait spans, `face.wait`, `post.wait` and
`stream.wait`, over the traced frames (lib/spans.py)."""

from pigobench.lib import spans


def read(ctx):
    return spans.ms_per_frame(ctx, ("face.wait", "post.wait",
                                    "stream.wait"))
