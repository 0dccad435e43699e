"""The port's serving surface (pigo_tpu_torch.web) on the CPU.

CudaStreamEngine(device="cpu") against FaceDetector.detect with seed + i,
bit for bit, at 1 and 3 caller threads with off-stream requests among
them; its shutdown and its error paths; the port's NativeEngine against
the JAX package's (examples/common.py, loaded by path: the same C++
engine and seed); results_to_json against examples/web/main.py's; and the
server in this process on the CPU engine, route by route. Frames go to the
server as PNG, which Pillow and OpenCV decode alike.
"""

import contextlib
import importlib.util
import io
import json
import os
import struct
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceDetector
from pigo_tpu_torch.cascade.assets import asset_path
from pigo_tpu_torch.detector import CascadeParams, DeviceStream
from pigo_tpu_torch.io.image import get_image
from pigo_tpu_torch.utils import profiling
from pigo_tpu_torch.web import bench_client, engines, main as web_main
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the web server's defaults (examples/common.py:49-53)
CFG = dict(min_size=100, max_size=600, shift=0.1, scale=1.1, iou=0.2)
REQUESTS = 7  # the largest number of requests one engine below takes
JOIN_S = 120  # a caller that waits longer than this has hung


@pytest.fixture(scope="module")
def frames():
    """The sample frame as BGR (on-stream) and a 320x320 cut of it with
    the same face (another shape: off-stream)."""
    gray = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                "sample_gray.npy"))
    on = np.repeat(gray[:, :, None], 3, axis=2)
    return {"on": on, "off": np.ascontiguousarray(on[40:360])}


def _reference(det, frame_bgr, seed):
    rows, cols = frame_bgr.shape[:2]
    return engines.result_dicts(det.detect(
        engines.bgr_to_gray(frame_bgr), rows, cols,
        CascadeParams(CFG["min_size"], CFG["max_size"], CFG["shift"],
                      CFG["scale"]),
        iou_threshold=CFG["iou"], perturbs=engines.PERTURBS,
        generator=torch.Generator().manual_seed(seed)))


@pytest.fixture(scope="module")
def refs(frames):
    """detect(frame, seed i) of both frames for i < REQUESTS."""
    det = FaceDetector(device="cpu")
    return {kind: [_reference(det, f, i) for i in range(REQUESTS)]
            for kind, f in frames.items()}


def _matched(answers, refs) -> bool:
    """The answers take request indices 0..len(answers)-1, each once."""
    return bench_client.match_once(
        answers, {kind: v[:len(answers)] for kind, v in refs.items()})


@pytest.mark.parametrize("callers", [1, 3])
def test_stream_engine_equals_detect_with_seed_plus_i(frames, refs, callers):
    """Request i, in the worker's order, equals detect(frame, seed + i) bit
    for bit, on-stream and off-stream (another shape runs `detect` on the
    worker), as a multiset over concurrent callers."""
    if callers == 1:
        plans = [[("on", frames["on"]), ("off", frames["off"]),
                  ("on", frames["on"]), ("on", frames["on"])]]
    else:
        plans = [[("on", frames["on"]), ("on", frames["on"])]
                 for _ in range(callers)]
        plans[1].insert(1, ("off", frames["off"]))
    engine = engines.CudaStreamEngine(device="cpu", depth=2, **CFG)
    try:
        answers, _ = bench_client.run_engine(engine, plans, JOIN_S, **CFG)
    finally:
        engine.close()
    assert len(answers) == sum(len(p) for p in plans)
    if callers == 1:  # one caller: the worker's order is the caller's
        assert [got for _, got, _ in answers] == [
            refs[kind][i] for i, (kind, _) in enumerate(plans[0])]
    assert _matched(answers, refs)
    assert all(got and got[0]["eyes"] and got[0]["landmarks"]
               for _, got, _ in answers)


def test_stream_engine_close_drains_frames_in_flight(frames, refs):
    """Frames taken before close() are answered: close() waits for the
    frames in flight, then ends the worker; later calls raise."""
    engine = engines.CudaStreamEngine(device="cpu", depth=3, **CFG)
    det = engine.det
    gate = threading.Event()
    dispatch = det._dispatch_frame_device

    def gated(*a, **kw):
        gate.wait(JOIN_S)
        return dispatch(*a, **kw)

    det._dispatch_frame_device = gated
    answers, threads = [], []
    for _ in range(3):
        threads.append(threading.Thread(target=lambda: answers.append(
            ("on", engine.detect(frames["on"], **CFG)))))
        threads[-1].start()
    deadline = time.monotonic() + JOIN_S
    while engine._inq.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)  # one request in the worker, two queued
    assert engine._inq.qsize() == 2
    closer = threading.Thread(target=engine.close)
    closer.start()
    while engine._inq.qsize() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)  # close()'s stop behind them
    gate.set()
    for t in threads + [closer]:
        t.join(JOIN_S)
        assert not t.is_alive(), "a caller or close() hung"
    assert not engine._worker.is_alive()
    assert _matched(answers, refs) and len(answers) == 3
    with pytest.raises(RuntimeError, match="closed"):
        engine.detect(frames["on"], **CFG)


def test_device_stream_collects_the_first_frame_before_a_second(frames,
                                                                  refs):
    """DeviceStream, the stream detect_stream_device and the engine share:
    full after its first frame until that frame is collected, then full
    at `depth` frames; submit on a full stream raises; frames come back
    oldest first, each equal to detect with its seed."""
    det = FaceDetector(device="cpu")
    gray = engines.bgr_to_gray(frames["on"]).reshape(frames["on"].shape[:2])
    stream = DeviceStream(det, (
        CascadeParams(CFG["min_size"], CFG["max_size"], CFG["shift"],
                      CFG["scale"]), 0.0, CFG["iou"], engines.PERTURBS), 2)
    stream.submit(gray, 0)
    assert stream.full and len(stream) == 1
    with pytest.raises(RuntimeError, match="full"):
        stream.submit(gray, 1)
    assert engines.result_dicts(stream.collect_oldest()) == refs["on"][0]
    stream.submit(gray, 1)
    assert not stream.full
    stream.submit(gray, 2)
    assert stream.full and len(stream) == 2
    assert [engines.result_dicts(stream.collect_oldest())
            for _ in range(2)] == refs["on"][1:3]
    assert len(stream) == 0 and not stream.full


def test_match_once_needs_each_index_once():
    """match_once: a crossing that needs an augmenting path matches; more
    answers of a value than indices that hold it, or a value no index
    holds, do not."""
    x, y = [{"face": (1, 2, 3, 4.0)}], [{"face": (5, 6, 7, 8.0)}]
    assert bench_client.match_once([("a", y), ("b", y)],
                                   {"a": [x, y], "b": [y, None]})
    assert bench_client.match_once([("a", x, 0.1), ("b", x, 0.2)],
                                   {"a": [x, x], "b": [x, None]})
    assert not bench_client.match_once(
        [("a", x), ("a", x), ("b", x)],
        {"a": [x, x, None], "b": [x, None, None]})
    assert not bench_client.match_once([("a", [])], {"a": [x, y]})


def _call_with_timeout(fn):
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # handed to the test below
            box["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "the call hung"
    return box


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_stream_engine_hands_worker_errors_to_the_caller(frames, refs):
    """A dispatch that raises fails its own request, in its caller; the
    worker serves the next request; a worker that ends (here by SystemExit)
    fails the waiting caller instead of hanging it. No request falls back
    to another path."""
    engine = engines.CudaStreamEngine(device="cpu", depth=2, **CFG)
    det = engine.det
    dispatch = det._dispatch_frame_device
    calls = []

    def failing(*a, **kw):
        calls.append(a[2])  # the request's seed
        if len(calls) == 2:
            raise ValueError("launch failed")
        if len(calls) == 4:
            raise SystemExit
        return dispatch(*a, **kw)

    det._dispatch_frame_device = failing
    detect = lambda: engine.detect(frames["on"], **CFG)  # noqa: E731
    assert _call_with_timeout(detect)["value"] == refs["on"][0]
    err = _call_with_timeout(detect)["error"]
    assert isinstance(err, ValueError) and "launch failed" in str(err)
    assert _call_with_timeout(detect)["value"] == refs["on"][2]
    err = _call_with_timeout(detect)["error"]
    assert isinstance(err, RuntimeError) and "stopped" in str(err)
    assert calls == [0, 1, 2, 3]
    assert not engine._worker.is_alive()
    engine.close()


def test_card_engines_raise_without_a_card():
    """The card is the default device: without one, the engines and the
    server raise (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.CudaStreamEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engines.make_engine("cuda", with_pupils=True, with_landmarks=True)
    args = web_main.build_parser().parse_args([])
    assert args.engine == "cuda-stream" and args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        web_main.make_server(args, ("127.0.0.1", 0))


@contextlib.contextmanager
def _jax_examples():
    """examples/common.py and examples/web/main.py of the JAX package,
    loaded by path; sys.path and sys.modules restored after."""
    saved_path, saved_common = list(sys.path), sys.modules.get("common")
    try:
        mods = {}
        for name, rel in (("common", ("examples", "common.py")),
                          ("web_main", ("examples", "web", "main.py"))):
            spec = importlib.util.spec_from_file_location(
                f"_jax_examples_{name}", os.path.join(ROOT, *rel))
            mod = importlib.util.module_from_spec(spec)
            if name == "common":  # main.py imports it as `common`
                sys.modules["common"] = mod
            spec.loader.exec_module(mod)
            mods[name] = mod
        yield mods
    finally:
        sys.path[:] = saved_path
        if saved_common is None:
            sys.modules.pop("common", None)
        else:
            sys.modules["common"] = saved_common


@pytest.mark.parametrize("seed", [0, 7])
def test_native_engine_matches_the_jax_examples(seed):
    """The port's NativeEngine equals examples/common.py's on the same BGR
    frame (the same C++ engine and seed), bit for bit."""
    from pigo_tpu.native import native_available

    if not native_available():
        pytest.fail("the JAX package's native engine did not build")
    rgb = get_image(asset_path("testdata", "sample.jpg"))[:, :, :3]
    bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    with _jax_examples() as jax_ex:
        theirs = jax_ex["common"].NativeEngine(
            with_pupils=True, with_landmarks=True, seed=seed)
        ours = engines.make_engine("native", with_pupils=True,
                                   with_landmarks=True, seed=seed,
                                   device="cpu", depth=4, **CFG)
        for cfg in (CFG, dict(CFG, min_size=60, iou=0.1)):
            want = theirs.detect(bgr, **cfg)
            got = ours.detect(bgr, **cfg)
            assert got == want
            assert want and want[0]["eyes"] and want[0]["landmarks"]
        assert engines.pupil_lean_angle((10, 20), (14, 60)) == \
            jax_ex["common"].pupil_lean_angle((10, 20), (14, 60))


def test_results_to_json_matches_the_jax_server(refs):
    """results_to_json equals examples/web/main.py's on the engines'
    result dicts: real ones, and faces without eyes or points, an odd
    size, coordinates at 0."""
    made = [
        [],
        [{"face": (10, 12, 21, 7.5), "eyes": [], "landmarks": []}],
        [{"face": (0, 0, 40, 9.0), "eyes": [(3, 0, 4.75)],
          "landmarks": []},
         {"face": (50, 60, 33, 12.0), "eyes": [],
          "landmarks": [(1, 2, 3.9)]}],
    ]
    with _jax_examples() as jax_ex:
        for results in made + refs["on"][:2] + refs["off"][:1]:
            assert json.dumps(web_main.results_to_json(results)) == \
                json.dumps(jax_ex["web_main"].results_to_json(results))


@pytest.fixture(scope="module")
def server():
    """web.main's server on the CPU cuda-stream engine, in this process."""
    args = web_main.build_parser().parse_args(["--device", "cpu",
                                               "--depth", "2"])
    srv, engine = web_main.make_server(args, ("127.0.0.1", 0))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        thread.join(JOIN_S)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=JOIN_S) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _png(frame_bgr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame_bgr[:, :, ::-1])).save(
        buf, format="PNG")
    return buf.getvalue()


def test_server_detect_equals_detect_of_the_png(server, frames, refs):
    """POST /detect of a PNG answers results_to_json(detect(frame, seed
    i)) for the i-th request; /stats then counts it and carries fps."""
    payload = _png(frames["on"])
    bodies = [json.loads(bench_client.post(server + "/detect", payload))
              for _ in range(2)]
    assert bodies == [web_main.results_to_json(refs["on"][i])
                      for i in range(2)]
    status, ctype, body = _get(server, "/stats")
    stats = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert "fps" in stats and stats["stages"]["detect"]["calls"] == 2


def test_server_serves_cascades_byte_exact(server):
    for rel, parts in [("/cascade/facefinder", ("cascade", "facefinder")),
                       ("/cascade/puploc", ("cascade", "puploc")),
                       ("/cascade/lps/lp42", ("cascade", "lps", "lp42"))]:
        status, _, body = _get(server, rel)
        with open(asset_path(*parts), "rb") as fh:
            assert status == 200 and body == fh.read(), rel


def test_server_gray_packet_equals_the_jax_servers(server):
    status, _, body = _get(server, "/testdata/sample.gray")
    with _jax_examples() as jax_ex:
        want = jax_ex["web_main"]._sample_gray_packet()
    assert status == 200 and body == want
    rows, cols = struct.unpack_from("<II", body)
    assert (rows, cols) == (400, 320)


def test_server_page_static_and_fixture(server):
    status, ctype, body = _get(server, "/?engine=client")
    assert status == 200 and ctype == "text/html"
    assert body.decode() == web_main.PAGE
    for route, path in (
            ("/static/pico.js", ("examples", "web", "static", "pico.js")),
            ("/selftest", ("examples", "web", "static", "selftest.html")),
            ("/golden/sample.json", ("tests", "golden", "sample.json"))):
        status, _, body = _get(server, route)
        with open(os.path.join(ROOT, *path), "rb") as fh:
            assert status == 200 and body == fh.read(), route


def test_server_unknown_paths_and_bad_images(server):
    for method, path, data, code in (
            ("GET", "/nope", None, 404),
            ("GET", "/static/none.js", None, 404),
            ("GET", "/cascade/none", None, 404),
            ("POST", "/nope", b"x", 404),
            ("POST", "/detect", b"not an image", 400)):
        req = urllib.request.Request(server + path, data=data, method=method)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=JOIN_S)
        assert err.value.code == code, (method, path)


def test_server_answers_500_when_detection_fails(frames):
    """An engine error fails its request with 500; the server serves on."""

    class Failing:
        calls = 0

        def detect(self, frame_bgr, **cfg):
            Failing.calls += 1
            if Failing.calls == 1:
                raise RuntimeError("the card went away")
            return []

    args = web_main.build_parser().parse_args(["--device", "cpu"])
    srv = ThreadingHTTPServer(("127.0.0.1", 0), web_main.make_handler(
        Failing(), args, None, profiling.PipelineStats(),
        profiling.FpsMeter()))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/detect"
    try:
        payload = _png(frames["off"][:64, :64])
        with pytest.raises(urllib.error.HTTPError) as err:
            bench_client.post(url, payload)
        assert err.value.code == 500
        assert b"the card went away" in err.value.read()
        assert json.loads(bench_client.post(url, payload)) == []
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(JOIN_S)


def test_bench_client_runs_and_reports_latency(server, frames):
    """bench_client.run spreads the requests over its threads and
    latency_ms reports best <= median <= p90."""
    payload = _png(np.zeros((48, 64, 3), np.uint8))  # no window: quick
    bodies, seconds, total = bench_client.run(server + "/detect", payload,
                                              5, 2)
    assert [json.loads(b) for b in bodies] == [[]] * 5
    assert len(seconds) == 5 and total > 0
    lat = bench_client.latency_ms([0.004, 0.001, 0.003, 0.002, 0.010])
    assert lat == {"best_ms": 1.0, "median_ms": 3.0, "p90_ms": 10.0}


def test_fps_meter_matches_the_jax_package(monkeypatch):
    from pigo_tpu.utils import profiling as jax_profiling

    ticks = iter([1.0, 1.5, 2.0, 2.25, 3.0] * 2)
    clock = types.SimpleNamespace(perf_counter=lambda: next(ticks))
    for mod in (profiling, jax_profiling):
        monkeypatch.setattr(mod, "time", clock)
    ours = profiling.FpsMeter(window=3)
    theirs = jax_profiling.FpsMeter(window=3)
    assert ours.value == theirs.value == 0.0
    got = [ours.tick() for _ in range(5)]
    assert got == [theirs.tick() for _ in range(5)]
    assert got[-1] == 2 / 1.0


def test_pipeline_stats_counts_every_stage_under_threads():
    """The server's handler threads time their stages into one
    PipelineStats: no update is lost."""
    stats = profiling.PipelineStats()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with stats.stage("detect", items=2):
                    pass
                stats.as_dict()

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    st = stats.as_dict()["stages"]["detect"]
    assert st["calls"] == 16 * 500 and st["items"] == 2 * 16 * 500
