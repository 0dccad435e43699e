"""The readers of the program's spans and counters (lib/spans.py and the
metrics that use it), on a TRACE filled by hand and a stand-in for the
traced segment's reduction.

    python -m pytest pigobench/tests -q
"""

from __future__ import annotations

import os
import sys
import types

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)

from pigobench.lib import manifest  # noqa: E402
from pigo_tpu_torch.utils import profiling  # noqa: E402

FRAMES = 4
# each reader and what it reads from `_fill`'s TRACE over FRAMES frames
READS = {
    "detector.wait_ms_per_frame": (2.0 + 1.0 + 3.0) / FRAMES,
    "face.dispatch_ms_per_frame": 6.0 / FRAMES,
    "post.dispatch_ms_per_frame": 4.0 / FRAMES,
    "cluster.host_ms_per_frame": 2.5 / FRAMES,
    "post.slot_fill": 100.0 * 24 / 64,
}


def _read(name, ctx):
    return manifest.load_module(
        os.path.join(BENCH, "metrics", name + ".py"),
        "test_metric_" + name.replace(".", "_")).read(ctx)


def _ctx(busy_s=1e-3):
    return types.SimpleNamespace(trace={"frames": FRAMES, "busy_s": busy_s,
                                        "window_s": 0.04})


@pytest.fixture
def trace():
    t = profiling.TRACE
    t.reset()
    yield t
    t.reset()


def _fill(t):
    """Seconds and self seconds as the program's spans would sum them."""
    t.add("face.wait", 0.002)
    t.add("post.wait", 0.001)
    t.add("stream.wait", 0.003)
    t.add("face.dispatch", 0.010, self_seconds=0.006)
    t.add("post.dispatch", 0.008, self_seconds=0.004)
    t.add("cluster.host", 0.0025)
    t.add("detect", 0.030, self_seconds=0.001)
    t.count("post.slots", 64)
    t.count("post.faces", 24)


def test_manifest_has_no_problems():
    m = manifest.load()
    assert manifest.problems(m) == []
    for name in READS:
        [e] = [e for e in m["per_layer"] if e["name"] == name]
        assert e["moves"] == "frames_per_s"
        assert e["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_the_trace(name, trace):
    _fill(trace)
    assert _read(name, _ctx()) == pytest.approx(READS[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READS))
@pytest.mark.parametrize("case", ["no_trace", "no_device", "empty",
                                  "no_recorder"])
def test_reader_gives_nothing_without_a_reading(name, case, trace,
                                                monkeypatch):
    """No device trace (a CPU run), a program that recorded nothing, or a
    program without the recorder (the parent of the change that added
    it): no reading, and nothing raised."""
    ctx = _ctx()
    if case == "no_trace":
        _fill(trace)
        ctx.trace = None
    elif case == "no_device":
        _fill(trace)
        ctx = _ctx(busy_s=0.0)
    elif case == "no_recorder":
        _fill(trace)
        monkeypatch.delattr(profiling, "TRACE")
    assert _read(name, ctx) is None
