"""Detection engines for the serving surface and the demos.

The counterpart of the JAX package's examples/common.py:137-358. Every
engine answers one call, `detect(frame_bgr, *, min_size, max_size, shift,
scale, iou) -> list[dict]`, on a BGR uint8 frame [H, W, 3], with one dict
per face: {"face": (row, col, scale, q), "eyes": [(row, col, scale)],
"landmarks": [(row, col, scale)]}. `make_engine` builds one by name:

  * "native"      — the port's host C++ engine (pigo_tpu_torch.native),
                    the counterpart of the reference's cgo bridges; every
                    call jitters from the same `seed`, as the JAX package's
                    NativeEngine does;
  * "cuda"        — FaceDetector.detect on one device, the counterpart of
                    TpuEngine; not re-entrant (a server serializes it);
  * "cuda-stream" — FaceDetector's device-resident stream behind a queue
                    (CudaStreamEngine), the counterpart of TpuStreamEngine:
                    concurrent callers' frames are in flight together.

The two card engines run on `device`: the card unless the caller passes
device="cpu", which runs the kernels' plain PyTorch versions; with no card
they raise. Their jitter: request i, in the order the engine takes
requests, equals `FaceDetector.detect(gray, ...,
generator=torch.Generator().manual_seed(seed + i))` bit for bit. (The JAX
engines split one PRNG key on the caller's thread and fold it on the
worker's, so there a request's jitter depends on thread timing.)
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import math
import os
import queue
import threading

import numpy as np
import torch

from pigo_tpu_torch.detector import (MIN_EYE_FACE_SCALE, PERTURBS, Q_THRESH,
                                     CascadeParams, DeviceStream,
                                     FaceDetector)
from pigo_tpu_torch.io.image import rgb_to_grayscale
from pigo_tpu_torch.utils.device import resolve_device

# Landmark roles of NativeEngine, in its points' order (reference
# cmd/pigo/main.go:68-71; 5 eye cascades x2 flips, 4 mouth cascades, lp84
# flipped as nose).
EYE_CASCADES = ["lp38", "lp312", "lp42", "lp44", "lp46"]
MOUTH_CASCADES = ["lp81", "lp82", "lp84", "lp93"]
NOSE_CASCADE = "lp84"

ENGINES = ("native", "cuda", "cuda-stream")

# How often a caller of CudaStreamEngine checks, while it waits, that the
# worker still runs (seconds)
WAIT_POLL_S = 1.0


def build_argparser(description: str) -> argparse.ArgumentParser:
    """The flags the demos and the web server share."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--source", default="0",
                   help="webcam index, video file, or image path")
    p.add_argument("--engine", default="cuda", choices=ENGINES,
                   help="detection engine (native C++ on the host; cuda or "
                        "cuda-stream on the card)")
    p.add_argument("--device", default=None,
                   help="device of the cuda engines: the card by default, "
                        "'cpu' for the kernels' plain PyTorch versions")
    p.add_argument("--min-size", type=int, default=100)
    p.add_argument("--max-size", type=int, default=600)
    p.add_argument("--shift", type=float, default=0.1)
    p.add_argument("--scale", type=float, default=1.1)
    p.add_argument("--iou", type=float, default=0.2)
    return p


def bgr_to_gray(frame_bgr: np.ndarray) -> np.ndarray:
    """The reference grayscale of a BGR frame, flat uint8 [H*W]."""
    return rgb_to_grayscale(np.ascontiguousarray(frame_bgr[:, :, ::-1]))


def on_device(device: torch.device):
    """Make `device` the calling thread's current CUDA device (the current
    device and stream are per thread); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def result_dicts(results) -> list[dict]:
    """FaceDetector results -> the engines' list of dicts."""
    return [
        {
            "face": (r.face.row, r.face.col, r.face.scale, r.face.q),
            "eyes": [(e.row, e.col, e.scale) for e in r.eyes],
            "landmarks": [(p.row, p.col, p.scale) for p in r.landmarks],
        }
        for r in results
    ]


class NativeEngine:
    """Full pipeline on the host C++ engine (faces -> pupils -> landmarks).

    The orchestration mirrors the reference bridge exports
    (examples/puploc/puploc.go, examples/facial_landmark/flploc.go).
    """

    def __init__(self, with_pupils=True, with_landmarks=False, seed=0):
        from pigo_tpu_torch.cascade.assets import asset_path
        from pigo_tpu_torch.native import (NativeFaceCascade,
                                           NativePupilLocalizer,
                                           native_cluster)

        self.face = NativeFaceCascade()
        self.cluster = native_cluster
        self.seed = seed
        self.pupil = None
        self.lps: dict[str, object] = {}
        if with_pupils or with_landmarks:
            self.pupil = NativePupilLocalizer()
        if with_landmarks:
            lps_dir = asset_path("cascade", "lps")
            for name in sorted(os.listdir(lps_dir)):
                with open(os.path.join(lps_dir, name), "rb") as fh:
                    self.lps[name] = NativePupilLocalizer(fh.read())

    def grayscale(self, frame_bgr: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(frame_bgr[:, :, ::-1])  # BGR -> RGB view

    def detect(self, frame_bgr: np.ndarray, *, min_size=100, max_size=600,
               shift=0.1, scale=1.1, iou=0.2) -> list[dict]:
        from pigo_tpu_torch.native import native_grayscale

        rows, cols = frame_bgr.shape[:2]
        gray = native_grayscale(self.grayscale(frame_bgr))
        dets = self.face.run_cascade(
            gray, rows, cols, min_size=min_size, max_size=max_size,
            shift_factor=shift, scale_factor=scale)
        faces = self.cluster(dets, iou)
        results = []
        for r, c, s, q in faces:
            if q <= Q_THRESH:
                continue
            res = {"face": (int(r), int(c), int(s), float(q)),
                   "eyes": [], "landmarks": []}
            if self.pupil is not None and s > MIN_EYE_FACE_SCALE:
                left = self._eye(gray, rows, cols, r - 0.075 * s,
                                 c - 0.175 * s, 0.25 * s)
                right = self._eye(gray, rows, cols, r - 0.075 * s,
                                  c + 0.185 * s, 0.25 * s)
                for e in (left, right):
                    if e[0] > 0 and e[1] > 0:
                        res["eyes"].append(e)
                if self.lps and left[0] > 0 and right[0] > 0:
                    res["landmarks"] = self._landmarks(gray, rows, cols,
                                                       left, right)
            results.append(res)
        return results

    def _eye(self, gray, rows, cols, row, col, scale):
        starts = self.pupil.jitter(row, col, scale, PERTURBS, self.seed)
        return self.pupil.run_detector(starts, gray, rows, cols)

    def _landmarks(self, gray, rows, cols, left, right):
        pts = []
        for name in EYE_CASCADES:
            for flip in (False, True):
                pts.append(self.lps[name].landmark(
                    left[:2], right[:2], gray, rows, cols,
                    perturbs=PERTURBS, seed=self.seed, flip_v=flip))
        for name in MOUTH_CASCADES:
            pts.append(self.lps[name].landmark(
                left[:2], right[:2], gray, rows, cols,
                perturbs=PERTURBS, seed=self.seed))
        pts.append(self.lps[NOSE_CASCADE].landmark(
            left[:2], right[:2], gray, rows, cols,
            perturbs=PERTURBS, seed=self.seed, flip_v=True))
        return [p for p in pts if p[0] > 0 and p[1] > 0]


class CudaEngine:
    """Full pipeline on FaceDetector.detect, one frame at a time, on
    `device` (the card unless device="cpu"). Not re-entrant: a server
    serializes its calls."""

    def __init__(self, with_pupils=True, with_landmarks=False, seed=0,
                 device=None):
        self.det = FaceDetector(with_pupils=with_pupils,
                                with_landmarks=with_landmarks,
                                device=device)
        self.seed = seed
        self.requests = 0  # request i draws from seed + i

    def detect(self, frame_bgr: np.ndarray, *, min_size=100, max_size=600,
               shift=0.1, scale=1.1, iou=0.2) -> list[dict]:
        rows, cols = frame_bgr.shape[:2]
        gray = bgr_to_gray(frame_bgr)
        seed = self.seed + self.requests
        self.requests += 1
        with on_device(self.det.device):
            results = self.det.detect(
                gray, rows, cols,
                CascadeParams(min_size, max_size, shift, scale),
                iou_threshold=iou, perturbs=PERTURBS,
                generator=torch.Generator().manual_seed(seed))
        return result_dicts(results)


class _Request:
    """One request to CudaStreamEngine's worker and its answer."""

    def __init__(self, gray: np.ndarray | None, cfg: dict | None):
        self.gray = gray
        self.cfg = cfg
        self.done = threading.Event()
        self.results: list[dict] | None = None
        self.error: BaseException | None = None


_STOP = object()  # close()'s request: drain, then end the worker


class CudaStreamEngine:
    """FaceDetector's device-resident stream behind a queue, the
    counterpart of the JAX package's TpuStreamEngine
    (examples/common.py:249-347).

    One worker thread owns every CUDA call the engine makes: it builds the
    FaceDetector on its device, then feeds the frames callers enqueue into
    a DeviceStream of `depth` frames (the one detect_stream_device runs,
    which owns the staging slots and collects the first frame before it
    takes a second). Its loop adapts to the load: it submits every waiting
    frame at once, and collects the oldest when the stream is full or no
    frame is waiting, so a lone caller waits for one frame while
    concurrent callers' frames overlap on the card.

    A frame of the stream's shape (the first streamed frame's) with the
    construction's parameters is on-stream; any other request runs
    `FaceDetector.detect` on the worker, in its turn. Request i, on-stream
    or not, equals `detect(frame, generator=manual_seed(seed + i))` bit for
    bit. An exception raised for a request is raised to its caller; the
    worker goes on with the next. `close()` answers every frame in flight
    and joins the worker."""

    def __init__(self, with_pupils=True, with_landmarks=True, seed=0,
                 depth=4, min_size=100, max_size=600, shift=0.1, scale=1.1,
                 iou=0.2, device=None):
        if not (with_pupils and with_landmarks):
            raise ValueError("CudaStreamEngine needs the full pipeline "
                             "(pupils + landmarks)")
        self.seed = seed
        self.depth = max(1, int(depth))
        self._cfg = dict(min_size=min_size, max_size=max_size, shift=shift,
                         scale=scale, iou=iou)
        self._inq: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self.det: FaceDetector | None = None
        started = _Request(None, None)
        self._worker = threading.Thread(
            target=self._run, args=(device, started),
            name="CudaStreamEngine", daemon=True)
        self._worker.start()
        self._wait(started)  # raises what building the detector raised

    def detect(self, frame_bgr: np.ndarray, *, min_size=100, max_size=600,
               shift=0.1, scale=1.1, iou=0.2) -> list[dict]:
        rows, cols = frame_bgr.shape[:2]
        req = _Request(bgr_to_gray(frame_bgr).reshape(rows, cols),
                       dict(min_size=min_size, max_size=max_size,
                            shift=shift, scale=scale, iou=iou))
        with self._lock:
            if self._closed:
                raise RuntimeError("CudaStreamEngine is closed")
            self._inq.put(req)
        return self._wait(req)

    def close(self) -> None:
        """Answer the requests already taken, then stop the worker."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._inq.put(_STOP)
        self._worker.join()

    def _wait(self, req: _Request):
        while not req.done.wait(WAIT_POLL_S):
            if not self._worker.is_alive() and not req.done.is_set():
                raise RuntimeError("CudaStreamEngine's worker stopped "
                                   "before answering")
        if req.error is not None:
            raise req.error
        return req.results

    # ------------------------------------------------- the worker thread

    def _run(self, device, started: _Request) -> None:
        with contextlib.ExitStack() as stack:
            try:
                dev = resolve_device(device)
                stack.enter_context(on_device(dev))
                self.det = FaceDetector(device=dev)
            except Exception as exc:
                started.error = exc
                return
            finally:
                started.done.set()
            self._serve(self.det)

    def _serve(self, det: FaceDetector) -> None:
        cfg = self._cfg
        stream = DeviceStream(det, (
            CascadeParams(cfg["min_size"], cfg["max_size"], cfg["shift"],
                          cfg["scale"]), 0.0, cfg["iou"], PERTURBS),
            self.depth)
        pending: collections.deque = collections.deque()  # stream's order
        shape = None  # the stream's frame shape
        taken = 0
        while True:
            try:
                req = self._inq.get(block=not pending)
            except queue.Empty:
                req = None  # nothing waiting: collect the oldest
            if req is _STOP:
                while pending:
                    self._collect(stream, pending.popleft())
                return
            if req is not None:
                seed = self.seed + taken
                taken += 1
                if req.cfg != cfg or shape not in (None, req.gray.shape):
                    self._off_stream(det, req, seed)
                    continue
                shape = req.gray.shape
                try:
                    stream.submit(req.gray, seed)
                except Exception as exc:
                    req.error = exc
                    req.done.set()
                    continue
                pending.append(req)
                if not stream.full:
                    continue  # dispatch what else is waiting first
            if pending:
                self._collect(stream, pending.popleft())

    @staticmethod
    def _collect(stream: DeviceStream, req: _Request) -> None:
        """Answer the oldest frame in flight, `req`."""
        try:
            req.results = result_dicts(stream.collect_oldest())
        except Exception as exc:
            req.error = exc
        finally:
            req.done.set()

    @staticmethod
    def _off_stream(det: FaceDetector, req: _Request, seed: int) -> None:
        cfg = req.cfg
        rows, cols = req.gray.shape
        try:
            req.results = result_dicts(det.detect(
                req.gray, rows, cols,
                CascadeParams(cfg["min_size"], cfg["max_size"], cfg["shift"],
                              cfg["scale"]),
                iou_threshold=cfg["iou"], perturbs=PERTURBS,
                generator=torch.Generator().manual_seed(seed)))
        except Exception as exc:
            req.error = exc
        finally:
            req.done.set()


def make_engine(name: str, **kw):
    """An engine by name (ENGINES); keyword arguments that the engine does
    not take (the stream's depth and parameters, the card's device for the
    native engine) are dropped."""
    if name == "cuda-stream":
        return CudaStreamEngine(**kw)
    for key in ("depth", "min_size", "max_size", "shift", "scale", "iou"):
        kw.pop(key, None)
    if name == "cuda":
        return CudaEngine(**kw)
    if name == "native":
        kw.pop("device", None)
        return NativeEngine(**kw)
    raise ValueError(f"unknown engine {name!r}; choose one of {ENGINES}")


def pupil_lean_angle(left, right) -> float:
    """Lean angle between the pupils in degrees
    (reference examples/masquerade/puploc.go:66-68)."""
    return math.atan2(right[1] - left[1], right[0] - left[0]) * 180.0 / math.pi
