"""Reduction of a torch.profiler trace to what the per-layer metrics read.

The traced segment runs a fixed number of frames after the window, under
`torch.profiler.profile` with CPU and CUDA activities. From its device
events (kernels, copies, sets): the union of their intervals (busy), the
kernels launched, each kernel's durations by name; from its host events:
what the host was doing in each idle gap of the device, named by the
harness's span and the innermost host operation at the gap's middle.
"""

from __future__ import annotations

import collections

MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")


def _is_device(ev) -> bool:
    return getattr(ev.device_type, "name", str(ev.device_type)) == "CUDA"


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events, t0_us: float, t1_us: float, spans: tuple[str, ...],
           frames: int) -> dict:
    """events: FunctionEvents of the profile (times in microseconds); the
    segment ran from t0_us to t1_us and served `frames` frames. `spans`
    are the harness's span names. Returns seconds and counts."""
    dev, host = [], []
    for ev in events:
        a, b = ev.time_range.start, ev.time_range.end
        if _is_device(ev):
            if b > a and ev.name not in spans:  # not a span's device range
                dev.append((a, b, ev.name))
        else:
            host.append((a, b, ev.name))
    kernels = collections.defaultdict(list)
    for a, b, name in dev:
        kernels[name].append((b - a) * 1e-6)
    launches = sum(len(v) for k, v in kernels.items()
                   if not k.startswith(MEMORY_OPS))
    merged = [(max(a, t0_us), min(b, t1_us)) for a, b in
              union([(a, b) for a, b, _ in dev])]
    merged = [(a, b) for a, b in merged if b > a]
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps = []
    edge = t0_us
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if t1_us > edge:
        gaps.append((edge, t1_us))
    idle = collections.Counter()
    for (a, b), name in zip(gaps, _host_at([(a + b) / 2 for a, b in gaps],
                                           host, spans)):
        idle[name] += (b - a) * 1e-6
    device_ops = collections.Counter({k: sum(v) for k, v in kernels.items()})
    return {
        "frames": frames, "window_s": (t1_us - t0_us) * 1e-6, "busy_s": busy,
        "launches": launches, "kernels": dict(kernels),
        "breakdown": {
            "device_ops": [[k[:64], v] for k, v in device_ops.most_common(10)],
            "idle_gaps": [[k[:64], v] for k, v in idle.most_common(10)]},
    }


def _host_at(points: list[float], host, spans) -> list[str]:
    """For each time point: "<span> / <innermost host op>", where span is
    the harness span that holds the point ("harness" outside them) and the
    op is "python" where no host operation holds it."""
    order = sorted(range(len(points)), key=points.__getitem__)
    evs = sorted(host)
    out = [""] * len(points)
    active: list[tuple[float, float, str]] = []
    j = 0
    for k in order:
        p = points[k]
        while j < len(evs) and evs[j][0] <= p:
            active.append(evs[j])
            j += 1
        active = [e for e in active if e[1] >= p]
        span = "harness"
        inner, inner_start = "python", float("-inf")
        for a, _, name in active:
            if name in spans:
                span = name
            elif a > inner_start:
                inner, inner_start = name, a
        out[k] = f"{span} / {inner}"
    return out
