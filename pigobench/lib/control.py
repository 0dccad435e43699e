"""The control of `correct`: the reference put in the program's place.

`python3 pigobench/run.py ... --control bfloat16` builds this detector in
place of the program's; the cell's own driver calls it as it calls
`FaceDetector`, and the harness judges its answers as it judges a run's
(lib/check.py). The configuration states float32, so its control is
bfloat16, the nearest precision below, and has to read `correct: false`.
`--control float32` puts the reference itself in the program's place and
has to read `correct: true`: what tells the two apart is the precision,
not the stand-in.

The reference's face stage costs about as much for one frame as for a
batch, some seconds on the card, so the control works out the faces of
the mix's frames in one batch at set-up and looks a request's frame up by
its bytes (a frame outside the pool is worked out when it comes): the
control then answers as many requests as a run, and every answer's faces
are compared. Eyes and points are worked out with the request's own
jitter (the seed its generator was made from) when they are first read:
the harness reads them for its sample once the window has closed.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pigobench.reference import pico

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Face = collections.namedtuple("Face", "row col scale q")
Point = collections.namedtuple("Point", "row col scale")


class Request:
    """One request's eyes and points, worked out on first use."""

    def __init__(self, ref, frame, seed, faces):
        self.ref, self.frame, self.seed, self.faces = ref, frame, seed, faces
        self._got = None

    def got(self) -> list:
        if self._got is None:
            self._got = self.ref.answers(
                self.frame[None], [pico.Request(0, self.seed)],
                faces={0: self.faces})[0]
        return self._got


class Answer:
    """One face of an answer, with the attributes check.py reads."""

    def __init__(self, face, request: Request, k: int):
        self.face, self._request, self._k = Face(*face[:4]), request, k

    @property
    def eyes(self) -> list:
        return [Point(*e) for e in self._request.got()[self._k][4]]

    @property
    def landmarks(self) -> list:
        return [Point(*q) for q in self._request.got()[self._k][5]]


class Detector:
    """`detect` and `detect_stream_device` as the drivers call them,
    answered by reference/pico.py in `acc`."""

    def __init__(self, ctx, acc: str):
        c, p = ctx.cascades, ctx.config["params"]
        names = sorted(c["landmarks"])
        self.ref = pico.Pipeline(
            pico.face_forest(c["face"]), pico.walk_forest([c["pupil"]]),
            pico.walk_forest([c["landmarks"][n] for n in names]), names,
            **p, acc=PRECISIONS[acc], device=ctx.device)
        faces, _ = self.ref.faces(ctx.pool)
        self._faces = {f.tobytes(): got for f, got in zip(ctx.pool, faces)}

    def _answer(self, frame: np.ndarray, seed: int) -> list:
        key = frame.tobytes()
        faces = self._faces.get(key)
        if faces is None:
            faces = self._faces[key] = self.ref.faces(frame[None])[0][0]
        request = Request(self.ref, frame, seed, faces)
        return [Answer(f, request, k) for k, f in enumerate(faces)]

    def detect(self, frame, rows, cols, params, *, iou_threshold,
               generator):
        return self._answer(np.asarray(frame).reshape(rows, cols),
                            generator.initial_seed())

    def detect_stream_device(self, frames, params, *, iou_threshold, seed,
                             depth):
        for k, frame in enumerate(frames):
            yield self._answer(np.asarray(frame), seed + k)
