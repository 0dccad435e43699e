"""Recorded video through `FaceDetector.detect_stream_device`: frames fed as
fast as the stream takes them, `depth` in flight, no host wait per frame
but the one for each frame's result. Frame i of the stream is pool frame
order[i] with the jitter of seed + i (the stream draws frame k of a call
started at index `first` from seed + first + k)."""

from __future__ import annotations

import time

from pigobench.lib import program


def build(ctx):
    det = program.detector(ctx)
    params, iou = program.params(ctx)
    return det, params, iou, int(ctx.traffic["depth"])


def serve(ctx, sut, first, feeding, on_answer, span):
    """Feed frames first, first + 1, ... while feeding(i, now), then drain;
    each answer goes to on_answer(i, results, None, t_answer). Returns the
    next frame index."""
    det, params, iou, depth = sut
    pool, order = ctx.pool, ctx.order
    clock = time.perf_counter
    fed = [first]

    def frames():
        i = first
        while feeding(i, clock()):
            yield pool[order[i]]
            i += 1
            fed[0] = i

    answers = det.detect_stream_device(frames(), params, iou_threshold=iou,
                                       seed=ctx.seed + first, depth=depth)
    k = first
    while True:
        with span("detector.detect_stream_device"):
            res = next(answers, None)
        if res is None:
            return fed[0]
        on_answer(k, res, None, clock())
        k += 1
