"""Per-stage wall-clock counters for a detection pipeline.

``PipelineStats`` collects calls, seconds and items per named stage;
``stage(...)`` is the context-manager timer that feeds it. Stages that
enqueue device work must end in a synchronisation (a host read of the
result) for their seconds to include the device time. ``FpsMeter`` is the
rolling frames/sec the web server's /stats route reports.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque


@dataclasses.dataclass
class StageStat:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0

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
        self._t0 = time.perf_counter()
        # the web server's handler threads time their stages concurrently
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        with self._lock:
            st = self.stages.setdefault(name, StageStat())
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                st.seconds += dt
                st.calls += 1
                st.items += items

    def as_dict(self) -> dict:
        total = time.perf_counter() - self._t0
        with self._lock:
            stages = {
                k: {
                    "calls": v.calls,
                    "seconds": v.seconds,
                    "items": v.items,
                    "items_per_second": v.items_per_second,
                }
                for k, v in self.stages.items()
            }
        return {"total_seconds": total, "stages": stages}


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
