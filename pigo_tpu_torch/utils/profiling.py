"""Per-stage wall-clock counters for a detection pipeline.

``PipelineStats`` collects calls, seconds and items per named stage;
``stage(...)`` is the context-manager timer that feeds it. Stages that
enqueue device work must end in a synchronisation (a host read of the
result) for their seconds to include the device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


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

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        st = self.stages.setdefault(name, StageStat())
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            st.seconds += time.perf_counter() - t0
            st.calls += 1
            st.items += items

    def as_dict(self) -> dict:
        total = time.perf_counter() - self._t0
        return {
            "total_seconds": total,
            "stages": {
                k: {
                    "calls": v.calls,
                    "seconds": v.seconds,
                    "items": v.items,
                    "items_per_second": v.items_per_second,
                }
                for k, v in self.stages.items()
            },
        }

