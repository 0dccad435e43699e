"""The whole frame's share of the card's float32 peak outside the tensor
cores: the operations of the face cascade and both walks that the traced
frames need (lib/work.py), over the traced segment's seconds, in %."""

from pigobench.lib import work


def read(ctx):
    t = ctx.trace
    if t is None or ctx.work is None or t["busy_s"] <= 0.0:
        return None
    peak = work.peaks(ctx.kind)
    if peak is None:
        return None
    return 100.0 * work.frame_ops(ctx) / t["window_s"] / peak["f32_ops_per_s"]
