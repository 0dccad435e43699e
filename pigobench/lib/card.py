"""The card a run measures: its presence, its name and power limit, and its
SM clock sampled through the window by nvidia-smi."""

from __future__ import annotations

import shutil
import statistics
import subprocess


def describe() -> str:
    """`name, power.limit` of the first card as nvidia-smi prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return proc.stdout.strip().splitlines()[0] if proc.stdout else "unknown"


class ClockSampler:
    """nvidia-smi polling clocks.sm and power.draw of card 0 every
    `period_ms` while it runs; `stop()` ends and reaps it and returns the
    samples as (sm MHz, power W) pairs."""

    def __init__(self, period_ms: int = 500):
        self.proc = None
        if shutil.which("nvidia-smi"):
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms",
                 str(period_ms)], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> list[tuple[float, float]]:
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        samples = []
        for line in out.splitlines():
            try:
                sm, pw = (float(v) for v in line.split(","))
            except ValueError:
                continue
            samples.append((sm, pw))
        return samples


def clock_summary(samples: list[tuple[float, float]]) -> dict:
    """Samples, SM clock min/median/max and the share at the max, median
    power draw."""
    if not samples:
        return {"samples": 0}
    sm = [s for s, _ in samples]
    top = max(sm)
    return {"samples": len(sm), "sm_mhz_min": min(sm),
            "sm_mhz_median": statistics.median(sm), "sm_mhz_max": top,
            "share_at_max": sum(v == top for v in sm) / len(sm),
            "power_w_median": statistics.median(p for _, p in samples)}
