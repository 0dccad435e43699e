"""The program's own spans and counters, read after the traced segment.

The program records them (`pigo_tpu_torch.utils.profiling.span` and
`count`) only while a torch.profiler records, so what
`profiling.TRACE` holds at the end of a run is what the traced segment's
frames did: the sums of each span's duration and self time (its duration
less that of its child spans), by name, and each counter. A program that
records nothing, or has no such module, gives no reading, nor does a run
without a device trace, as with every per-layer metric. This is the third
place in pigobench/ that imports the program, after lib/program.py and the
drivers.
"""

from __future__ import annotations


def recorded(ctx):
    """(stages, counts) of profiling.TRACE's as_dict, or None where the
    traced run has no device trace or the program recorded nothing."""
    t = ctx.trace
    if t is None or t["busy_s"] <= 0.0:
        return None
    try:
        from pigo_tpu_torch.utils import profiling
    except ImportError:
        return None
    trace = getattr(profiling, "TRACE", None)
    if trace is None:
        return None
    d = trace.as_dict()
    if not d["stages"] and not d["counts"]:
        return None
    return d["stages"], d["counts"]


def ms_per_frame(ctx, names: tuple[str, ...], key: str = "seconds"):
    """The spans `names`' summed `key` ("seconds" or "self_seconds") over
    the traced frames, in ms; None where none of them was recorded."""
    got = recorded(ctx)
    if got is None:
        return None
    found = [got[0][n] for n in names if n in got[0]]
    if not found:
        return None
    return sum(s[key] for s in found) / ctx.trace["frames"] * 1e3


def share(ctx, part: str, whole: str):
    """100 * counter `part` / counter `whole`, in %; None where `whole`
    was not counted."""
    got = recorded(ctx)
    if got is None or not got[1].get(whole):
        return None
    return 100.0 * got[1].get(part, 0) / got[1][whole]
