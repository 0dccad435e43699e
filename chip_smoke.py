#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (pigo_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. It imports nothing of JAX or pigo_tpu.

Phases (one result line each, then the kernels line, the card line, and
the final status line):
  1. build  — compile every kernel of the port from csrc/, print the
     compiler's register and spill report;
  2. kernel — each kernel against its plain PyTorch version on the card,
     bit for bit, at the main path's shapes (the 400x320 headline pyramid
     and a 1080x1920 tiling of it), with the kernel's and the plain
     version's times, the kernel's time over the surviving windows alone
     (the dependent load chain that bounds it) and its bound;
  3. main path — FaceCascade on the card: detections and clusters against
     tests/golden/sample_dense.json, stream_hits and sparse_hits_batch
     parity, the 1080p stream, one kernel launch per frame, and the
     streamed ms/frame;
  4. kernels — one JSON line for every ported kernel.
Any failed check exits non-zero before the status line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)
HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
STREAM_FRAMES, STREAM_DEPTH = 64, 8
HD_FRAMES, HD_DEPTH = 24, 6
# H100 SXM published peaks (NVIDIA data sheet, at a 700 W power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, from CUDA
    events around the whole run, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    from pigo_tpu_torch.ops import face_cuda
    from pigo_tpu_torch.utils import build

    t0 = time.perf_counter()
    build.build("face_cascade")
    face_cuda.load_kernel()
    report = [ln.strip() for ln in build.ptxas_report("face_cascade")
              .splitlines() if "registers" in ln or "spill" in ln]
    emit("build", kernel="face_cascade", seconds=time.perf_counter() - t0,
         ptxas=report)


def phase_kernel(gray, hd, forest, card) -> dict:
    """Kernel vs plain version, bitwise, at both main-path shapes."""
    import torch

    from pigo_tpu_torch.ops import face_cuda, face_dense
    from pigo_tpu_torch.ops.windows import build_window_plan

    dev = forest.codes.device
    rng = np.random.default_rng(SEED)
    f = forest
    stats = {"max_abs_err": 0.0, "shapes": {}}
    for name, frame, cfg in (("headline", gray, HEADLINE), ("hd1080", hd, HD)):
        rows, cols = frame.shape
        plan = build_window_plan(rows, cols, **cfg)
        base, scale = face_cuda.device_plan(plan, dev)
        frames = np.stack([frame] + [
            rng.integers(0, 256, (rows, cols), dtype=np.uint8)
            for _ in range(4)])
        ft = torch.from_numpy(frames).to(dev)
        for t_limit in (f.num_trees, 32):
            before = face_cuda.face_cascade_launches
            qk = face_cuda.face_cascade(ft, base, scale, f.codes, f.preds,
                                        f.thresh, t_limit)
            launches = face_cuda.face_cascade_launches - before
            qp = face_dense.classify_windows(ft, base, scale, f.codes,
                                             f.preds, f.thresh, t_limit)
            torch.cuda.synchronize()
            err = float((qk.double() - qp.double()).abs().max())
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            emit("kernel", shape=name, t_limit=t_limit,
                 frames=int(frames.shape[0]), windows=plan.num_windows,
                 launches=launches, bitwise_equal=bool(torch.equal(qk, qp)),
                 max_abs_err=err)
            check(launches == 1, f"{launches} launches for one batch")
            check(torch.equal(qk, qp),
                  f"face_cascade != plain at {name}, t_limit {t_limit}")

        # Times on the first (real) frame alone, as the main path runs it.
        one = ft[:1].contiguous()
        args = (one, base, scale, f.codes, f.preds, f.thresh, f.num_trees)
        ms = cuda_ms(lambda: face_cuda.face_cascade(*args), 50)
        plain_ms = cuda_ms(lambda: face_dense.classify_windows(*args), 3)
        q, evals = face_dense.cascade_with_work(*args)
        alive = torch.nonzero(q[0] > 0).flatten()
        survivors = int(alive.numel())
        # The same launch over the survivors alone: each walks all T trees,
        # so this times the dependent load chain that bounds the kernel.
        sub = (one, base[alive].contiguous(), scale[alive].contiguous(),
               f.codes, f.preds, f.thresh, f.num_trees)
        survivors_ms = cuda_ms(lambda: face_cuda.face_cascade(*sub), 50)
        w = plan.num_windows
        # Bytes the function must move: the frame, the forest and the f32
        # scores. The plan's window tables (8 B a window) are not counted:
        # they follow from the geometry and could be derived in the kernel.
        n_bytes = (rows * cols + f.codes.numel() + 4 * f.preds.numel()
                   + 4 * f.thresh.numel() + 4 * w)
        # f32 work: one add and one compare per tree evaluation, one
        # subtract per survivor (integer address math is not counted).
        n_ops = 2 * evals + survivors
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
        shape = dict(
            rows=rows, cols=cols, windows=w, scales=len(plan.scales),
            tree_evaluations=evals, survivors=survivors, bytes=n_bytes,
            plan_table_bytes=8 * w, f32_ops=n_ops, ms=ms, plain_ms=plain_ms,
            survivors_only_ms=survivors_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            card=card)
        stats["shapes"][name] = shape
        emit("kernel_time", shape=name, **shape)
    return stats


def phase_main_path(gray, hd, golden, card) -> dict:
    """FaceCascade on the card through its user entry points."""
    from pigo_tpu_torch import FaceCascade, cluster_detections
    from pigo_tpu_torch.ops import face_cuda
    from pigo_tpu_torch.utils.profiling import PipelineStats

    fc = FaceCascade()
    rows, cols = gray.shape
    hrows, hcols = hd.shape
    frames = [np.roll(gray, i % 8, axis=1) for i in range(STREAM_FRAMES)]
    hdf = [np.roll(hd, i % 8, axis=1) for i in range(HD_FRAMES)]
    want = np.asarray(golden["detections"], np.float64).reshape(-1, 4)
    want_cl = np.asarray(golden["clusters"], np.float64).reshape(-1, 4)
    iou = golden["config"]["iou"]

    face_cuda.face_cascade_launches = 0
    dets = fc.run_cascade(gray, rows, cols, **HEADLINE)
    clusters = fc.detect(gray, rows, cols, iou_threshold=iou, **HEADLINE)
    wants = [fc.run_cascade(fr, rows, cols, **HEADLINE) for fr in frames[:8]]
    outs = list(fc.stream_hits(frames, depth=STREAM_DEPTH, **HEADLINE))
    batch = fc.sparse_hits_batch(np.stack(frames[:8]), **HEADLINE)
    hd_outs = list(fc.stream_hits(hdf, depth=HD_DEPTH, **HD))
    launches = face_cuda.face_cascade_launches
    # one launch per single-frame call and per streamed frame, one per batch
    expected = 2 + 8 + STREAM_FRAMES + 1 + HD_FRAMES

    check(dets.shape == want.shape and np.array_equal(dets, want),
          f"headline detections {dets.shape} != golden {want.shape}")
    check(clusters.shape == want_cl.shape
          and np.array_equal(clusters, want_cl), "clusters != golden")
    check(len(outs) == STREAM_FRAMES and all(
        np.array_equal(o, wants[i % 8]) for i, o in enumerate(outs)),
        "stream_hits != run_cascade")
    check(len(batch) == 8 and all(
        np.array_equal(b, w) for b, w in zip(batch, wants)),
        "sparse_hits_batch != run_cascade")
    check(len(hd_outs) == HD_FRAMES and all(o.shape[0] >= 1 for o in hd_outs),
          "1080p stream lost the faces")
    check(launches == expected,
          f"{launches} kernel launches, expected {expected}")
    emit("main_path", detections=int(dets.shape[0]),
         clusters=int(clusters.shape[0]), golden_detections_equal=True,
         golden_clusters_equal=True, stream_frames=len(outs),
         stream_equal=True, batch_frames=len(batch), batch_equal=True,
         hd_frames=len(hd_outs),
         hd_min_hits=int(min(o.shape[0] for o in hd_outs)),
         face_cascade_launches=launches, expected_launches=expected)

    # Streamed ms/frame, as bench.py times the TPU package: drain the
    # stream, then cluster every frame, inside one timed rep.
    timing = {}
    for name, fr, cfg, depth, reps in (
            ("headline", frames, HEADLINE, STREAM_DEPTH, 5),
            ("hd1080", hdf, HD, HD_DEPTH, 3)):
        stats = PipelineStats()
        per_frame = []
        face_cuda.face_cascade_launches = 0
        for _ in range(reps):
            t0 = time.perf_counter()
            with stats.stage("stream_hits", items=len(fr)):
                hits = list(fc.stream_hits(fr, depth=depth, **cfg))
            with stats.stage("cluster", items=len(fr)):
                n_cl = sum(cluster_detections(h, 0.2).shape[0] for h in hits)
            per_frame.append((time.perf_counter() - t0) / len(fr) * 1e3)
            check(n_cl >= len(fr), f"{name}: faces lost in the timed stream")
        per_frame.sort()
        launches_per_frame = face_cuda.face_cascade_launches / (reps * len(fr))
        check(launches_per_frame == 1.0,
              f"{name}: {launches_per_frame} launches per frame")
        timing[name] = dict(
            ms_per_frame_best=per_frame[0],
            ms_per_frame_median=per_frame[len(per_frame) // 2],
            reps=reps, frames=len(fr), depth=depth,
            launches_per_frame=launches_per_frame,
            stages={k: v["seconds"] / v["items"] * 1e3
                    for k, v in stats.as_dict()["stages"].items()},
            card=card)
        emit("main_path_time", shape=name, **timing[name])
    return {"launches": launches, "timing": timing}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pigo_tpu_torch
    from pigo_tpu_torch import FaceCascade
    from pigo_tpu_torch.utils.device import card_description

    pkg_root = os.path.dirname(os.path.dirname(pigo_tpu_torch.__file__))
    check(os.path.samefile(pkg_root, ROOT),
          f"pigo_tpu_torch imported from {pkg_root}, not this checkout")
    check("jax" not in sys.modules and "pigo_tpu" not in sys.modules,
          "the port pulled in jax or pigo_tpu")

    card = card_description()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), card=card)
    gray = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                "sample_gray.npy"))
    check(gray.shape == (400, 320) and gray.dtype == np.uint8,
          "sample_gray.npy is not the 400x320 uint8 sample frame")
    hd = np.tile(gray, (1080 // 400 + 1, 1920 // 320 + 1))[:1080, :1920]
    with open(os.path.join(ROOT, "tests", "golden", "sample_dense.json")) as fh:
        golden = json.load(fh)

    phase_build()
    forest = FaceCascade().tensors
    kstats = phase_kernel(gray, hd, forest, card)
    main = phase_main_path(gray, hd, golden, card)
    check("jax" not in sys.modules and "pigo_tpu" not in sys.modules,
          "the port pulled in jax or pigo_tpu")

    head = kstats["shapes"]["headline"]
    kernels = [{
        "name": "face_cascade",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/face_cascade.cu",
        "replaces": "pigo_tpu/ops/face_pallas.py:635",
        "launches": main["launches"],
        "max_abs_err": kstats["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "check": "bitwise equal to ops/face_dense.classify_windows",
        "survivors_only_ms": head["survivors_only_ms"],
        "hd1080": {k: kstats["shapes"]["hd1080"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "survivors_only_ms")},
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
