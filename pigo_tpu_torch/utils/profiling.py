"""Per-stage counters for a detection pipeline, and the program's spans.

``PipelineStats`` collects calls, seconds, self seconds and items per
named stage, and named counts; ``stage(...)`` is the context-manager timer
that feeds it and ``add`` records a stage timed elsewhere. Stages that
enqueue device work must end in a synchronisation (a host read of the
result) for their seconds to include the device time. ``FpsMeter`` is the
rolling frames/sec the web server's /stats route reports.

``span(name)`` and ``count(name, n)`` are how the detector, the models and
the ops record themselves. They record only while a ``torch.profiler``
profile runs, the one switch: off, ``span`` returns one shared null
context and ``count`` returns at once. On, a span is a host event of the
profile (a ``FUNCTION``-scope record function, so it never becomes a
device range) and its duration and self time (its duration less that of
its child spans on the same thread) are added to ``TRACE``; a count is
added to ``TRACE``'s counts. ``TRACE`` keeps sums per name; each single
span, with its nesting, is in the profile's trace
(``export_chrome_trace``).

    with torch.profiler.profile() as prof:
        det.detect(frame, rows, cols)
    profiling.TRACE.report(sys.stdout)
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from collections import deque

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast


@dataclasses.dataclass
class StageStat:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0
    self_seconds: float = 0.0

    @property
    def items_per_second(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


class PipelineStats:
    """Per-stage counters for a detection pipeline.

    >>> stats = PipelineStats()
    >>> with stats.stage("run_cascade", items=218449):
    ...     pass
    >>> stats.as_dict()["stages"]["run_cascade"]["items"]
    218449
    """

    def __init__(self):
        self.stages: dict[str, StageStat] = {}
        self.counts: dict[str, int] = {}
        self._t0 = time.perf_counter()
        # the web server's handler threads time their stages concurrently
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, items)

    def add(self, name: str, seconds: float, items: int = 0,
            self_seconds: float | None = None):
        """One call of stage `name` that took `seconds`, of them
        `self_seconds` (default: all) outside its child stages."""
        with self._lock:
            st = self.stages.get(name)
            if st is None:
                st = self.stages[name] = StageStat()
            st.calls += 1
            st.seconds += seconds
            st.self_seconds += seconds if self_seconds is None \
                else self_seconds
            st.items += items

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def reset(self):
        with self._lock:
            self.stages.clear()
            self.counts.clear()
            self._t0 = time.perf_counter()

    def as_dict(self) -> dict:
        total = time.perf_counter() - self._t0
        with self._lock:
            stages = {
                k: {
                    "calls": v.calls,
                    "seconds": v.seconds,
                    "self_seconds": v.self_seconds,
                    "items": v.items,
                    "items_per_second": v.items_per_second,
                }
                for k, v in self.stages.items()
            }
            counts = dict(self.counts)
        return {"total_seconds": total, "stages": stages, "counts": counts}

    def report(self, file=None) -> str:
        text = json.dumps(self.as_dict(), indent=2)
        if file is not None:
            print(text, file=file)
        return text


# What the program's spans and counts add up to, process-wide.
TRACE = PipelineStats()

_OFF = contextlib.nullcontext()
_local = threading.local()  # .stack: the thread's open spans


class _Span:
    """One recording span; `items` may be set inside it."""

    __slots__ = ("name", "items", "_child", "_t0", "_rf")

    def __init__(self, name: str, items: int):
        self.name = name
        self.items = items
        self._child = 0.0

    def __enter__(self):
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        try:
            _local.stack.append(self)
        except AttributeError:
            _local.stack = [self]
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1]._child += dt
        TRACE.add(self.name, dt, self.items, dt - self._child)
        self._rf.__exit__(*exc)
        return False


def span(name: str, items: int = 0):
    """A context that records stage `name` while a torch.profiler records
    (module docstring); entered, it gives the span, whose `items` may be
    set, or None when nothing records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, items)


def count(name: str, n: int = 1):
    """Add n to count `name` while a torch.profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        TRACE.count(name, n)


class FpsMeter:
    """Rolling frames/sec over a sliding window (stats.js equivalent)."""

    def __init__(self, window: int = 30):
        self._times: deque[float] = deque(maxlen=window)

    def tick(self) -> float:
        self._times.append(time.perf_counter())
        return self.value

    @property
    def value(self) -> float:
        """Current rolling frames/sec (without registering a frame)."""
        if len(self._times) < 2:
            return 0.0
        span = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / span if span > 0 else 0.0
