"""Shared plumbing of the demos: flags, frame source, sink, drawing, loop.

The port's copy of the JAX package's examples/common.py:57-134 (the frame
source and the sink) and :365-396 (the drawing and the loop). The engines
and the flags the demos share with the web server are
pigo_tpu_torch.web.engines': a demo runs on the card through
`FaceDetector.detect` (`--engine cuda`, the default; `--device cpu` runs
the kernels' plain PyTorch versions) or on the host C++ engine
(`--engine native`). Without a card the cuda engine raises; no demo falls
back to the host.

A demo's `main` and `fps_loop` take an optional frame iterable and sink,
so a caller can drive a demo without a camera or a file; from the command
line they are the FrameSource of `--source`/`--frames` and the Sink of
`--out`. OpenCV is imported inside the functions that read, draw or write
frames.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from pigo_tpu_torch.web import engines

# The demos' engines: the counterparts of the JAX demos' native and tpu
# (examples/common.py:43). The stream engine serves many callers and needs
# the full pipeline, so it is the web server's only.
DEMO_ENGINES = ("native", "cuda")


def build_argparser(description: str) -> argparse.ArgumentParser:
    """web.engines.build_argparser's flags with the demos' engines and
    their --out and --frames."""
    p = argparse.ArgumentParser(
        description=description, add_help=False, conflict_handler="resolve",
        parents=[engines.build_argparser(description)])
    p.add_argument("--engine", default="cuda", choices=DEMO_ENGINES,
                   help="detection engine (native C++ on the host; cuda on "
                        "the card, or on the CPU with --device cpu)")
    p.add_argument("--out", default="",
                   help="write annotated output here instead of a window")
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = until EOF/keypress)")
    return p


class FrameSource:
    """Webcam / video / still-image frame iterator (BGR uint8)."""

    def __init__(self, source: str, max_frames: int = 0):
        import cv2

        self.max_frames = max_frames
        self._image = None
        self._cap = None
        if source.isdigit():
            self._cap = cv2.VideoCapture(int(source))
            if not self._cap.isOpened():
                raise SystemExit(
                    f"cannot open webcam {source}; pass --source <video|image>"
                )
        elif os.path.splitext(source.lower())[1] in (".jpg", ".jpeg", ".png",
                                                     ".bmp"):
            self._image = cv2.imread(source)
            if self._image is None:
                raise SystemExit(f"cannot read image {source}")
            if self.max_frames == 0:
                self.max_frames = 1
        else:
            self._cap = cv2.VideoCapture(source)
            if not self._cap.isOpened():
                raise SystemExit(f"cannot open video {source}")

    def __iter__(self):
        n = 0
        while self.max_frames == 0 or n < self.max_frames:
            if self._image is not None:
                frame = self._image.copy()
            else:
                ok, frame = self._cap.read()
                if not ok:
                    return
            yield frame
            n += 1

    def release(self):
        if self._cap is not None:
            self._cap.release()


class Sink:
    """Window or file sink for annotated frames."""

    def __init__(self, out: str, title: str):
        import cv2

        self._cv2 = cv2
        self.out = out
        self.title = title
        self._writer = None

    def show(self, frame, results=None) -> bool:
        """Show or write one annotated frame (`results`, what was drawn on
        it, is for sinks that keep it). Returns False when the loop should
        stop (window closed / 'q')."""
        cv2 = self._cv2
        if self.out:
            ext = os.path.splitext(self.out.lower())[1]
            if ext in (".jpg", ".jpeg", ".png"):
                cv2.imwrite(self.out, frame)
            else:
                if self._writer is None:
                    h, w = frame.shape[:2]
                    self._writer = cv2.VideoWriter(
                        self.out, cv2.VideoWriter_fourcc(*"mp4v"), 20, (w, h)
                    )
                self._writer.write(frame)
            return True
        cv2.imshow(self.title, frame)
        return (cv2.waitKey(1) & 0xFF) != ord("q")

    def release(self):
        if self._writer is not None:
            self._writer.release()


class KeepSink:
    """A sink that keeps every annotated frame and its results in memory,
    for a program that drives a demo (`main(argv, source=frames,
    sink=KeepSink())`)."""

    def __init__(self):
        self.frames, self.results = [], []

    def show(self, frame, results) -> bool:
        self.frames.append(frame)
        self.results.append(results)
        return True


def draw_face_box(cv2, frame, face, color=(0, 0, 255)):
    r, c, s = int(face[0]), int(face[1]), int(face[2])
    cv2.rectangle(frame, (c - s // 2, r - s // 2), (c + s // 2, r + s // 2),
                  color, 2)


def draw_point(cv2, frame, pt, color=(0, 255, 0), radius=4):
    cv2.circle(frame, (int(pt[1]), int(pt[0])), radius, color, -1, 8, 0)


def fps_loop(args, engine, per_frame, title: str, *, source=None,
             sink=None) -> dict:
    """The demo loop: source -> engine -> per_frame(cv2, frame, results)
    -> sink, which draws on each frame in place.

    `source` is an iterable of BGR uint8 frames [H, W, 3], taken whole, and
    `sink` has `show(frame, results) -> bool` (False stops the loop); by
    default the FrameSource of args.source and args.frames and the Sink of
    args.out, released at the end. Prints the JAX loop's `N frames in Xs
    (Y FPS)` line to stderr and returns the frame count and the seconds of
    the loop, of the engine's calls and of per_frame's."""
    import cv2

    src = FrameSource(args.source, args.frames) if source is None else source
    out = Sink(args.out, title) if sink is None else sink
    n, engine_s, draw_s = 0, 0.0, 0.0
    t0 = time.perf_counter()
    try:
        for frame in src:
            t1 = time.perf_counter()
            results = engine.detect(
                frame, min_size=args.min_size, max_size=args.max_size,
                shift=args.shift, scale=args.scale, iou=args.iou)
            t2 = time.perf_counter()
            per_frame(cv2, frame, results)
            engine_s += t2 - t1
            draw_s += time.perf_counter() - t2
            n += 1
            if not out.show(frame, results):
                break
    finally:
        if source is None:
            src.release()
        if sink is None:
            out.release()
    dt = time.perf_counter() - t0
    if n:
        print(f"{n} frames in {dt:.2f}s ({n / dt:.1f} FPS)", file=sys.stderr)
    return {"frames": n, "seconds": dt, "engine_seconds": engine_s,
            "per_frame_seconds": draw_s}


def run_demo(description: str, argv, per_frame, title: str, *,
             with_pupils: bool, with_landmarks: bool, source=None, sink=None,
             device=None) -> dict:
    """A demo's main: parse argv (sys.argv[1:] when None), build the
    engine (`device`, when given, in place of --device), run fps_loop."""
    args = build_argparser(description).parse_args(argv)
    engine = engines.make_engine(
        args.engine, with_pupils=with_pupils, with_landmarks=with_landmarks,
        device=args.device if device is None else device)
    return fps_loop(args, engine, per_frame, title, source=source, sink=sink)
