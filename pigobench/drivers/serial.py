"""One library caller in a closed loop: `FaceDetector.detect` on one gray
frame at a time, its results on the host before the next call, as the Go
library, the CLI and every demo's `cuda` engine call the detector.
Request i sends pool frame order[i] with the jitter of seed + i."""

from __future__ import annotations

import time

import torch

from pigobench.lib import program


def build(ctx):
    det = program.detector(ctx)
    params, iou = program.params(ctx)
    return det, params, iou


def serve(ctx, sut, first, feeding, on_answer, span):
    """Send requests first, first + 1, ... while feeding(i, now); each
    answer goes to on_answer(i, results, t_call, t_answer). Returns the
    next request index."""
    det, params, iou = sut
    pool, order, seed = ctx.pool, ctx.order, ctx.seed
    rows, cols = pool.shape[1:]
    clock = time.perf_counter
    i = first
    while feeding(i, clock()):
        frame = pool[order[i]]
        gen = torch.Generator().manual_seed(seed + i)
        with span("detector.detect"):
            t0 = clock()
            res = det.detect(frame, rows, cols, params, iou_threshold=iou,
                             generator=gen)
            t1 = clock()
        on_answer(i, res, t0, t1)
        i += 1
    return i
