"""The port's demos (pigo_tpu_torch.demos) on the CPU.

Each demo against the JAX package's (examples/, loaded by path and fresh
for every run: blinkdet keeps its counters in a module global there): on
the native engine, the written image pixel for pixel; on the cuda engine
with device="cpu" (the kernels' plain versions), frame i's results equal
to FaceDetector.detect with seed + i and its drawing equal to the JAX
demo's per_frame on the same results. Then blinkdet's counters, the
helpers of masquerade and talk_detector, and the cuda engine without a
card.
"""

import contextlib
import importlib
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceDetector
from pigo_tpu_torch.demos import blinkdet, common, masquerade, talk_detector
from pigo_tpu_torch.detector import CascadeParams
from pigo_tpu_torch.web import engines
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "assets", "testdata", "sample.jpg")
# the port's demo -> (the JAX demo under examples/, with_pupils,
# with_landmarks)
DEMOS = {
    "facedet": ("facedet/demo.py", False, False),
    "faceblur": ("facedet/faceblur.py", False, False),
    "puploc": ("puploc/demo.py", True, False),
    "facial_landmark": ("facial_landmark/demo.py", True, True),
    "blinkdet": ("blinkdet/demo.py", True, False),
    "masquerade": ("masquerade/demo.py", True, False),
    "talk_detector": ("talk_detector/demo.py", True, True),
}
# the demos' defaults (examples/common.py:49-53)
CFG = dict(min_size=100, max_size=600, shift=0.1, scale=1.1, iou=0.2)


@contextlib.contextmanager
def jax_demo(name):
    """The JAX demo of the port's `name`, loaded fresh by path with a
    fresh examples/common.py as `common` (the demo imports it so);
    sys.path, sys.argv and sys.modules["common"] restored after."""
    saved_path, saved_argv = list(sys.path), list(sys.argv)
    saved_common = sys.modules.get("common")
    try:
        mods = []
        for mod_name, rel in (("common", "common.py"),
                              (name, DEMOS[name][0])):
            spec = importlib.util.spec_from_file_location(
                f"_jax_examples_{mod_name}",
                os.path.join(ROOT, "examples", rel))
            mod = importlib.util.module_from_spec(spec)
            if mod_name == "common":
                sys.modules["common"] = mod
            spec.loader.exec_module(mod)
            mods.append(mod)
        yield mods[1]
    finally:
        sys.path[:] = saved_path
        sys.argv[:] = saved_argv
        if saved_common is None:
            sys.modules.pop("common", None)
        else:
            sys.modules["common"] = saved_common


def port_demo(name):
    return importlib.import_module(f"pigo_tpu_torch.demos.{name}")


@pytest.mark.parametrize("name", list(DEMOS))
def test_native_demo_writes_the_jax_demos_image(name, tmp_path):
    """--engine native on the sample image: the port's image equals the
    JAX demo's pixel for pixel (the same C++ engine and seed)."""
    from pigo_tpu.native import native_available

    if not native_available():
        pytest.fail("the JAX package's native engine did not build")
    flags = ["--engine", "native", "--source", SAMPLE, "--frames", "1",
             "--min-size", "20"]
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    stats = port_demo(name).main(flags + ["--out", str(ours)])
    assert stats["frames"] == 1
    with jax_demo(name) as jax_mod:
        sys.argv[:] = ["demo.py", *flags, "--out", str(theirs)]
        jax_mod.main()
    got, want = cv2.imread(str(ours)), cv2.imread(str(theirs))
    assert got is not None and want is not None
    assert np.array_equal(got, want)
    assert (got != cv2.imread(SAMPLE)).any(), "nothing was drawn"


@pytest.fixture(scope="module")
def frames():
    """Two BGR frames: the sample image and the same rolled by 5 columns."""
    bgr = cv2.imread(SAMPLE)
    return [np.ascontiguousarray(np.roll(bgr, k, axis=1)) for k in (0, 5)]


@pytest.fixture(scope="module")
def references(frames):
    """FaceDetector(device="cpu").detect(frame_i, seed i) of both frames
    at the demos' defaults, for each of the demos' three pipelines."""
    out = {}
    for _, pupils, landmarks in DEMOS.values():
        if (pupils, landmarks) in out:
            continue
        det = FaceDetector(with_pupils=pupils, with_landmarks=landmarks,
                           device="cpu")
        out[pupils, landmarks] = [engines.result_dicts(det.detect(
            engines.bgr_to_gray(f), f.shape[0], f.shape[1],
            CascadeParams(CFG["min_size"], CFG["max_size"], CFG["shift"],
                          CFG["scale"]),
            iou_threshold=CFG["iou"], perturbs=engines.PERTURBS,
            generator=torch.Generator().manual_seed(i)))
            for i, f in enumerate(frames)]
    return out


@pytest.mark.parametrize("name", list(DEMOS))
def test_cuda_demo_on_cpu_equals_detect_and_the_jax_drawing(
        name, frames, references):
    """--engine cuda --device cpu over two frames: frame i's results equal
    detect(frame_i, seed + i), and each annotated frame equals the JAX
    demo's per_frame on a copy of the input with those results."""
    _, pupils, landmarks = DEMOS[name]
    sink = common.KeepSink()
    stats = port_demo(name).main(["--engine", "cuda", "--device", "cpu"],
                                 source=[f.copy() for f in frames],
                                 sink=sink)
    assert stats["frames"] == len(frames) == len(sink.frames)
    want = references[pupils, landmarks]
    assert sink.results == want
    assert all(len(r) == 1 for r in want)
    assert all(bool(r[0]["eyes"]) == pupils for r in want)
    assert all(bool(r[0]["landmarks"]) == landmarks for r in want)
    with jax_demo(name) as jax_mod:
        for i, f in enumerate(frames):
            drawn = f.copy()
            jax_mod.per_frame(cv2, drawn, want[i])
            assert np.array_equal(sink.frames[i], drawn), i
            assert not np.array_equal(drawn, f), "nothing was drawn"


def _blink_results():
    """Four frames of results on the sample image: a face without eyes,
    then its eyes where the iris shows, then eyes on flat skin (no iris:
    a blink), then no eyes again."""
    face = (202, 154, 243, 340.8)
    seen = [(185, 113, 20.04), (182, 204, 20.04)]
    flat = [(150, 100, 20.0), (60, 250, 20.0)]
    return [[{"face": face, "eyes": eyes, "landmarks": []}]
            for eyes in ([], seen, flat, [])]


class ReplayEngine:
    """An engine that answers each call with the next of `results`."""

    def __init__(self, results):
        self._results = iter(results)

    def detect(self, frame_bgr, **cfg):
        return next(self._results)


def test_blinkdet_counts_blinks_per_run(monkeypatch):
    """blinkdet's per_frame over four frames of results draws the JAX
    demo's frames and leaves its counters after every frame; a second
    main in one process draws the first one's frames (its counters are
    per run), where the JAX demo's second run starts from the first one's
    counts."""
    bgr = cv2.imread(SAMPLE)
    seq = _blink_results()
    state = blinkdet.new_state()
    ours, flags = [], []
    with jax_demo("blinkdet") as jax_mod:
        for results in seq:
            got, want = bgr.copy(), bgr.copy()
            blinkdet.per_frame(cv2, got, results, state)
            jax_mod.per_frame(cv2, want, results)
            assert np.array_equal(got, want)
            assert state == jax_mod.state
            ours.append(got)
            flags.append(tuple(state[s] < blinkdet.EYE_CLOSED_CONSEC_FRAMES
                               for s in ("left", "right")))
        assert flags == [(False, False), (False, False), (True, True),
                         (True, True)]
        # the JAX demo's second run starts blinking at its first frame
        again = bgr.copy()
        jax_mod.per_frame(cv2, again, seq[0])
        assert not np.array_equal(again, ours[0])

    runs = []
    for _ in range(2):
        monkeypatch.setattr(engines, "make_engine",
                            lambda *a, **kw: ReplayEngine(seq))
        sink = common.KeepSink()
        blinkdet.main(["--engine", "native"],
                      source=[bgr.copy() for _ in seq], sink=sink)
        runs.append(sink.frames)
    for first, second, per_frame in zip(*runs, ours):
        assert np.array_equal(first, second)
        assert np.array_equal(first, per_frame)


def test_mouth_aspect_ratio_matches_the_jax_demo():
    """On seeded points, with 0 to 6 of them, coincident pairs (dist2 ==
    0) among them."""
    rng = np.random.default_rng(11)
    with jax_demo("talk_detector") as jax_mod:
        cases = []
        for n in range(7):
            for _ in range(6):
                cases.append([tuple(int(v) for v in rng.integers(0, 50, 3))
                              for _ in range(n)])
        coincident = [(1, 2, 3), (4, 5, 6), (7, 8, 9), (7, 8, 9), (0, 0, 1)]
        cases.append(coincident)
        for pts in cases:
            got = talk_detector.mouth_aspect_ratio(pts)
            assert got == jax_mod.mouth_aspect_ratio(pts)
        assert talk_detector.mouth_aspect_ratio(coincident) == float("inf")
        assert talk_detector.mouth_aspect_ratio(
            [(0, 0, 1), (3, 4, 1), (10, 0, 1), (10, 5, 1), (13, 4, 1)]) \
            == 10 / 5 * talk_detector.MAR_SCALE
        assert talk_detector.MOUTH_SLICE == jax_mod.MOUTH_SLICE


def test_talk_detector_takes_mouth_points_by_position():
    """A face whose 15 points lost one of the first ten: the port, as the
    JAX demo, takes the mouth points by position, so the shifted list
    gives it lp82 where lp81 was, and both draw the same frame."""
    bgr = cv2.imread(SAMPLE)
    pts = [(186, 132, 32.4), (185, 187, 32.4), (186, 96, 32.4),
           (183, 223, 32.4), (166, 137, 32.4), (165, 181, 32.4),
           (156, 107, 32.4), (154, 213, 32.4), (171, 78, 32.4),
           (168, 241, 32.4), (275, 161, 32.4), (296, 161, 32.4),
           (282, 124, 32.4), (236, 160, 32.4), (280, 200, 32.4)]
    lost = pts[:3] + pts[4:]
    results = [{"face": (202, 154, 243, 340.8),
                "eyes": [(185, 113, 20.0), (182, 204, 20.0)],
                "landmarks": lost}]
    mouth = lost[talk_detector.MOUTH_SLICE] + lost[-1:]
    assert mouth[0] == pts[11] != pts[10]
    with jax_demo("talk_detector") as jax_mod:
        got, want = bgr.copy(), bgr.copy()
        talk_detector.per_frame(cv2, got, results)
        jax_mod.per_frame(cv2, want, results)
    assert np.array_equal(got, want)


def test_masquerade_sprite_and_overlay_match_the_jax_demo():
    """make_sunglasses at several widths and overlay_rotated on seeded
    frames, angles and centres (inside, across an edge, outside)."""
    rng = np.random.default_rng(5)
    with jax_demo("masquerade") as jax_mod:
        for width in (24, 25, 57, 100, 131):
            sprite = masquerade.make_sunglasses(width)
            assert np.array_equal(sprite, jax_mod.make_sunglasses(width))
        for center in ((60.5, 80.0), (5.0, 150.25), (118.0, 3.0),
                       (-40.0, 70.0), (60.0, 400.0)):
            frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
            sprite = masquerade.make_sunglasses(int(rng.integers(24, 90)))
            angle = float(rng.uniform(-120.0, 60.0))
            got, want = frame.copy(), frame.copy()
            masquerade.overlay_rotated(cv2, got, sprite, center, angle)
            jax_mod.overlay_rotated(cv2, want, sprite, center, angle)
            assert np.array_equal(got, want)
        assert (got == frame).all()  # the last centre is off the frame


@pytest.mark.parametrize("name", list(DEMOS))
def test_cuda_demo_raises_without_a_card(name):
    """The demos default to the card: without one, main raises before it
    takes a frame (no fallback to the CPU or to the native engine)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    taken = []

    def source():
        taken.append(1)
        yield np.zeros((480, 640, 3), np.uint8)

    args = common.build_argparser("").parse_args([])
    assert args.engine == "cuda" and args.device is None
    for argv in (["--engine", "cuda"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_demo(name).main(argv, source=source(),
                                 sink=common.KeepSink())
    assert not taken
    with pytest.raises(SystemExit):
        common.build_argparser("").parse_args(["--engine", "cuda-stream"])
