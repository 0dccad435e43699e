"""The port's recorder (pigo_tpu_torch/utils/profiling.py) and the spans
and counters the detector, the face model and host clustering record.

Off (no torch.profiler recording) nothing is recorded and `span` hands
out one shared null context; on, each span is a FUNCTION-scope host event
of the profile (never a user annotation, which the card would turn into a
device range) and its sums go to `profiling.TRACE`, with self time kept
per thread.
"""

import contextlib
import io
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import RecordScope
from torch.profiler import ProfilerActivity, profile

from pigo_tpu_torch import FaceDetector
from pigo_tpu_torch.detector import CascadeParams
from pigo_tpu_torch.utils import profiling
from pigo_tpu_torch.utils.profiling import PipelineStats
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

JOIN_S = 60
# the sample frame at a coarse pyramid: one face with eyes and 15 points
PARAMS = (CascadeParams(100, 400, 0.2, 1.2), 0.1)
P = 15  # perturbations per anchor, as tests/test_torch_detector.py

# Each entry point's spans with their parent span (None: a root); at
# these parameters the host tail engine scans every scale.
DETECT_SPANS = {
    "detect": None, "face.dispatch": "detect", "face.collect": "detect",
    "face.wait": "face.collect", "cluster.host": "detect",
    "post.dispatch": "detect", "post.collect": "detect",
    "post.wait": "post.collect"}
SPANS = {
    "detect": DETECT_SPANS,
    "detect_host_tail": dict(DETECT_SPANS, **{"face.tail": "face.dispatch"}),
    "stream": {
        "stream.dispatch": None, "face.dispatch": "stream.dispatch",
        "post.dispatch": "stream.dispatch", "stream.collect": None,
        "stream.wait": "stream.collect"},
}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def trace():
    profiling.TRACE.reset()
    yield profiling.TRACE
    profiling.TRACE.reset()


def test_off_records_nothing(trace):
    ctx = profiling.span("detect", items=3)
    assert isinstance(ctx, contextlib.nullcontext)
    assert profiling.span("face.wait") is ctx
    with ctx as sp:
        assert sp is None
        profiling.count("post.slots", 4)
    assert trace.stages == {} and trace.counts == {}


def test_on_nested_spans_self_time_counts_and_reset(trace):
    with _cpu_profile():
        for _ in range(2):
            with profiling.span("outer", items=1):
                with profiling.span("inner") as sp:
                    sp.items = 5
                    time.sleep(0.01)
                profiling.count("slots", 3)
        profiling.count("slots")
    outer, inner = trace.stages["outer"], trace.stages["inner"]
    assert (outer.calls, outer.items) == (2, 2)
    assert (inner.calls, inner.items) == (2, 10)
    assert inner.seconds >= 0.02 and inner.self_seconds == inner.seconds
    assert outer.seconds > inner.seconds
    assert outer.self_seconds == pytest.approx(
        outer.seconds - inner.seconds, rel=0, abs=1e-12)
    assert trace.counts == {"slots": 7}
    d = trace.as_dict()
    assert d["stages"]["outer"]["self_seconds"] == outer.self_seconds
    assert d["counts"] == {"slots": 7}
    trace.reset()
    assert trace.stages == {} and trace.counts == {}


def test_spans_are_function_scope_host_events(trace):
    names = ("detect", "face.dispatch", "face.wait")
    with _cpu_profile() as prof:
        with profiling.span(names[0]):
            with profiling.span(names[1]):
                torch.ones(4).add_(1)
            with profiling.span(names[2]):
                pass
    events = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in events) == sorted(names)
    for e in events:
        assert e.device_type.name == "CPU"
        assert e.scope == int(RecordScope.FUNCTION)
        assert e.scope != int(RecordScope.USER_SCOPE)
    inner = [e for e in events if e.name == "face.dispatch"][0]
    assert inner.cpu_parent.name == "detect"


def test_pipeline_stats_add_and_report():
    """As the JAX package's PipelineStats: `stage`, `add` and `report`."""
    stats = PipelineStats()
    with stats.stage("detect", items=100):
        pass
    stats.add("detect", 0.5, items=50)
    stats.add("cluster", 0.25, self_seconds=0.125)
    d = stats.as_dict()
    st = d["stages"]["detect"]
    assert st["calls"] == 2 and st["items"] == 150
    assert st["seconds"] >= 0.5 and st["items_per_second"] > 0
    assert st["self_seconds"] == st["seconds"]
    assert d["stages"]["cluster"]["self_seconds"] == 0.125
    buf = io.StringIO()
    text = stats.report(buf)
    assert json.loads(text)["stages"]["detect"]["calls"] == 2
    assert buf.getvalue() == text + "\n"


def test_spans_under_threads_keep_their_own_parents(trace):
    """The web server's handler threads record into one TRACE: no update
    is lost and each thread's child time goes to its own parent."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        pass
                profiling.count("n")

        with _cpu_profile():
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(JOIN_S)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    outer, inner = trace.stages["outer"], trace.stages["inner"]
    assert outer.calls == inner.calls == 3200
    assert trace.counts == {"n": 3200}
    assert 0.0 <= outer.self_seconds <= outer.seconds
    assert outer.self_seconds == pytest.approx(
        outer.seconds - inner.seconds, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("entry", sorted(SPANS))
def test_detector_records_the_spans_once_a_frame(entry, sample_gray, trace):
    params, iou = PARAMS
    det = FaceDetector(device="cpu", host_tail=entry == "detect_host_tail",
                       host_threads=1)
    frames = [np.roll(sample_gray, i, axis=1) for i in range(2)]
    with _cpu_profile() as prof:
        if entry != "stream":
            got = [det.detect(f, f.shape[0], f.shape[1], params,
                              iou_threshold=iou, perturbs=P,
                              generator=torch.Generator().manual_seed(i))
                   for i, f in enumerate(frames)]
        else:
            got = list(det.detect_stream_device(
                iter(frames), params, iou_threshold=iou, perturbs=P,
                seed=0, depth=2))
    assert [len(r) for r in got] == [1, 1]
    want = SPANS[entry]
    assert {k: v.calls for k, v in trace.stages.items()} == dict.fromkeys(
        want, 2)
    events = [e for e in prof.events() if e.name in want]
    assert sorted(e.name for e in events) == sorted(list(want) * 2)
    for e in events:
        parent = e.cpu_parent.name if e.cpu_parent is not None else None
        assert parent == want[e.name], e.name
    counts = trace.counts
    assert counts["post.faces"] == 2
    assert counts["post.slots"] >= counts["post.faces"]
    if entry != "stream":
        assert trace.stages["face.collect"].items >= 2  # hits decoded
