"""The reader of `stream.graph_share` (metrics/stream.graph_share.py) on a
TRACE filled by hand: the program's counters of the device stream's frame
programs and of those that ran as CUDA graph replays.

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

NAME = "stream.graph_share"


def _read(ctx):
    return manifest.load_module(
        os.path.join(BENCH, "metrics", NAME + ".py"),
        "test_metric_stream_graph_share").read(ctx)


def _ctx(busy_s=1e-3):
    return types.SimpleNamespace(trace={"frames": 4, "busy_s": busy_s,
                                        "window_s": 0.04})


@pytest.fixture
def trace():
    t = profiling.TRACE
    t.reset()
    yield t
    t.reset()


def test_manifest_entry():
    m = manifest.load()
    assert manifest.problems(m) == []
    [e] = [e for e in m["per_layer"] if e["name"] == NAME]
    assert (e["unit"], e["better"], e["source"], e["layer"], e["moves"],
            e["workloads"]) == ("%", "higher", "program_counter",
                                "detector", "frames_per_s",
                                ["video-1080p.stream"])
    assert m["per_layer"][-1] is e


@pytest.mark.parametrize("replays,dispatches", [(5, 5), (3, 4), (0, 2)])
def test_reads_replays_over_dispatches(trace, replays, dispatches):
    trace.add("stream.dispatch", 0.004)
    if replays:
        trace.count("stream.graph_replays", replays)
    trace.count("stream.dispatches", dispatches)
    trace.count("stream.graph_captures", 1)
    assert _read(_ctx()) == pytest.approx(100.0 * replays / dispatches,
                                          rel=1e-12)


@pytest.mark.parametrize("case", ["no_dispatches", "no_trace", "no_device",
                                  "no_recorder"])
def test_gives_nothing_without_a_reading(trace, monkeypatch, case):
    """A program that counts no dispatches (the parent of the change that
    added the counters, or a run of `detect`), no device trace, or no
    recorder: no reading, and nothing raised."""
    trace.add("stream.dispatch", 0.004)
    trace.count("post.slots", 8)
    ctx = _ctx()
    if case != "no_dispatches":
        trace.count("stream.dispatches", 4)
        trace.count("stream.graph_replays", 4)
    if case == "no_trace":
        ctx.trace = None
    elif case == "no_device":
        ctx = _ctx(busy_s=0.0)
    elif case == "no_recorder":
        monkeypatch.delattr(profiling, "TRACE")
    assert _read(ctx) is None
