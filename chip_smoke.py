#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (pigo_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. It imports nothing of JAX or pigo_tpu.

Phases (one result line each, then the kernels line, the card line, and
the final status line):
  1. build  — compile every kernel of the port from csrc/, one nvcc per
     source, all started together; print the compiler's register and
     spill report;
  2. kernel — each kernel against its plain PyTorch version on the card,
     bit for bit, at the main paths' shapes, with the kernel's and the
     plain version's times and its bound: the face cascade over the
     400x320 headline pyramid and a 1080x1920 tiling of it (plus its time
     over the surviving windows alone, the dependent load chain that
     bounds it); the pupil/landmark walk for the eyes, the 15 landmark
     points and rotated eyes of the faces found in the sample frame and
     in the 1080p tiling, plus seeded random starts;
  3. main path — FaceCascade on the card: detections and clusters against
     tests/golden/sample_dense.json, stream_hits and sparse_hits_batch
     parity, the 1080p stream, one kernel launch per frame, and the
     streamed ms/frame;
  4. detector — FaceDetector on the card: faces, eyes and landmark points
     against tests/golden/sample.json at its frozen uniforms, detect equal
     to the CPU run, detect_stream equal to per-frame detect over the
     sample and 1080p streams, one face_cascade and two pupil_walk
     launches per frame with a qualifying face, the streamed ms/frame, a
     serial face / cluster / post breakdown, and a torch.profiler pass
     for the device's busy time and idle share;
  5. kernels — one JSON line for every ported kernel.
Any failed check exits non-zero before the status line.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)
HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
STREAM_FRAMES, STREAM_DEPTH = 64, 8
HD_FRAMES, HD_DEPTH = 24, 6
KERNELS = ("face_cascade", "pupil_walk")
# FaceDetector: the golden sample's configuration (tests/golden/sample.json
# holds its frozen faces, eyes and points) and the 1080p tiling's.
GOLDEN_TAG = "sample"
DET_HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
DET_IOU = 0.1
DET_DEPTH = 4
RANDOM_GROUPS = 8  # seeded random walk groups beside the real anchors
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


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, from CUDA
    events around the whole run, after two warm-up calls (the second
    timed on the host).

    queue_ahead: first occupy the stream with a sleep kernel long enough
    for the host to enqueue every call, so that the events time the
    kernels back to back on the device and not the host's launch rate (a
    walk launch runs for tens of microseconds, about what the host takes
    to issue one)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        # 2e9 cycles a second bounds the SM clock from above, so the sleep
        # lasts at least twice the host's enqueue time (capped near 1 s)
        torch.cuda._sleep(int(min(2e9 * 2 * reps * host_s, 2e9)) + 1)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def golden_uniforms(tag: str, n: int, perturbs: int = 63) -> np.ndarray:
    """The golden corpus's jitter uniforms [n, perturbs, 3] f32 for a tag
    (a copy of pigo_tpu/tools/make_golden.py:111-114)."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return rng.random((n, perturbs, 3), dtype=np.float32)


def phase_build() -> None:
    from pigo_tpu_torch.ops import face_cuda, pupil_cuda
    from pigo_tpu_torch.utils import build

    def timed(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(timed, KERNELS)))
    face_cuda.load_kernel()
    pupil_cuda.load_kernel()
    for name in KERNELS:
        report = [ln.strip() for ln in build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        emit("build", kernel=name, seconds=seconds[name], ptxas=report)
    emit("build", all_seconds=time.perf_counter() - t0)


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
        ms = cuda_ms(lambda: face_cuda.face_cascade(*args), 50, True)
        plain_ms = cuda_ms(lambda: face_dense.classify_windows(*args), 3)
        q, evals = face_dense.cascade_with_work(*args)
        alive = torch.nonzero(q[0] > 0).flatten()
        survivors = int(alive.numel())
        # The same launch over the survivors alone: each walks all T trees,
        # so this times the dependent load chain that bounds the kernel.
        sub = (one, base[alive].contiguous(), scale[alive].contiguous(),
               f.codes, f.preds, f.thresh, f.num_trees)
        survivors_ms = cuda_ms(lambda: face_cuda.face_cascade(*sub), 50,
                               True)
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


def _walk_inputs(anchors, casc_id, flips, u, dev):
    """Walker inputs (casc_id, r0, c0, s0, col_sign) [G*P] on dev for G
    groups of P perturbations, as the main path makes them: anchors
    [G, 3] (row, col, scale), casc_id [G], flips [G], u [G, P, 3]."""
    import torch

    from pigo_tpu_torch.ops import pupil_dense

    a = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    return pupil_dense.walker_starts(
        torch.as_tensor(casc_id, device=dev), a[:, 0], a[:, 1], a[:, 2],
        torch.as_tensor(flips, device=dev),
        torch.as_tensor(u, dtype=torch.float32, device=dev))


def phase_pupil_kernel(frames, det, card) -> dict:
    """pupil_walk against the plain walk, bitwise on (r, c, s), for the
    walks the main path makes on each frame (eyes, then the 15 landmark
    points anchored on the eyes' medians) and for rotated eyes, each with
    RANDOM_GROUPS seeded random groups besides; then the kernel's and the
    plain version's times on the main path's walks alone, and the bound."""
    import torch

    from pigo_tpu_torch.detector import (MIN_EYE_FACE_SCALE, Q_THRESH,
                                         CascadeParams, eye_anchors,
                                         landmark_anchors)
    from pigo_tpu_torch.ops import pupil_cuda, pupil_dense

    dev = det.device
    rng = np.random.default_rng(SEED)
    stats = {"max_abs_err": 0.0, "shapes": {}}
    pt, lt = det.pupil.tensors, det.landmarks.tensors
    for name, frame, params in frames:
        rows, cols = frame.shape
        pix = torch.from_numpy(np.ascontiguousarray(frame).reshape(-1)).to(dev)
        faces = [d for d in det.detect_faces(
            frame, rows, cols, CascadeParams(**params), iou_threshold=DET_IOU)
            if d.q > Q_THRESH and d.scale > MIN_EYE_FACE_SCALE]
        f = len(faces)
        check(f >= 1, f"{name}: no qualifying face")
        u_eyes = rng.random((2 * f, 63, 3), dtype=np.float32)
        real_eyes = _walk_inputs(eye_anchors(faces),
                                 np.zeros(2 * f, np.int32),
                                 np.zeros(2 * f, bool), u_eyes, dev)
        kw = dict(nrows=rows, ncols=cols, dim=cols)
        er, ec, es = pupil_cuda.pupil_walk(pt.codes, pt.preds, *real_eyes,
                                           pix, **kw,
                                           scale_mult=pt.scale_mult)
        eyes = torch.stack(pupil_dense.median_vote(
            er.reshape(2 * f, 63), ec.reshape(2 * f, 63),
            es.reshape(2 * f, 63), 63))
        arow, acol, ascale = landmark_anchors(eyes)
        cids, flips = det.landmarks.schedule_arrays(f)
        npts = len(det.landmarks.point_schedule)
        lmk_anchors = torch.stack([arow, acol, ascale], 1).repeat_interleave(
            npts, 0).cpu().numpy()
        real_lmk = _walk_inputs(lmk_anchors, cids, flips,
                                rng.random((f * npts, 63, 3),
                                           dtype=np.float32), dev)

        def random_groups(smin, smax, n_casc, flip):
            g = RANDOM_GROUPS
            anchors = np.stack([rng.uniform(0, rows, g),
                                rng.uniform(0, cols, g),
                                rng.uniform(smin, smax, g)], 1)
            return _walk_inputs(
                anchors.astype(np.float32), rng.integers(0, n_casc, g),
                (rng.random(g) < 0.5) & flip,
                rng.random((g, 63, 3), dtype=np.float32), dev)

        walks = (
            ("eyes", pt, real_eyes, random_groups(8, 80, 1, False), False),
            ("landmarks", lt, real_lmk,
             random_groups(30, 300, lt.codes.shape[0], True), False),
            ("eyes_rotated", pt, real_eyes, random_groups(8, 80, 1, True),
             True),
        )
        shape = {"faces": f}
        for kind, t, real, extra, rotated in walks:
            wkw = dict(kw, scale_mult=t.scale_mult, rotated=rotated,
                       angle_idx=pupil_dense.angle_index(0.25)
                       if rotated else 0)
            both = [torch.cat([a, b]).contiguous()
                    for a, b in zip(real, extra)]
            before = pupil_cuda.pupil_walk_launches
            got = pupil_cuda.pupil_walk(t.codes, t.preds, *both, pix, **wkw)
            launches = pupil_cuda.pupil_walk_launches - before
            want = pupil_dense.walk(t.codes, t.preds, *both, pix, **wkw)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(got, want))
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            check(launches == 1, f"{launches} pupil_walk launches for one walk")
            check(equal, f"pupil_walk != plain walk: {name} {kind}")

            # times and bound on the main path's walkers alone
            args = (t.codes, t.preds, *real, pix)
            ms = cuda_ms(lambda: pupil_cuda.pupil_walk(*args, **wkw), 50,
                         True)
            plain_ms = cuda_ms(lambda: pupil_dense.walk(*args, **wkw), 2)
            work = pupil_dense.walk_with_work(*args, **wkw)[3]
            n = int(real[1].numel())
            stages, trees = t.codes.shape[1], t.codes.shape[2]
            # bytes: the pixels the probes hit (1 B), the code words (4 B)
            # and leaves (8 B) the walkers visit, and each walker's state
            # (20 B in, 12 B out)
            n_bytes = (work["pixels"] + 4 * work["code_words"]
                       + 8 * work["leaves"] + 32 * n)
            # f32 work per walker and stage: T sign products, 2(T-1) tree
            # adds, 5 for the state update (integer address math not
            # counted)
            n_ops = n * stages * (3 * trees + 3)
            bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
            shape[kind] = dict(
                walkers=n, walkers_checked=int(both[1].numel()),
                launches=launches,
                bitwise_equal=equal, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes=n_bytes, pixels=work["pixels"],
                code_words=work["code_words"], leaves=work["leaves"],
                f32_ops=n_ops)
            emit("pupil_kernel", frame=name, rows=rows, cols=cols, faces=f,
                 walk=kind, card=card, **shape[kind])
        stats["shapes"][name] = shape
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


def _same_results(a, b) -> bool:
    """Two list[FaceResult] agree: the JSON payload and every f32 scale."""
    def floats(results):
        return [[p.scale for p in r.eyes + r.landmarks] + [r.face.q]
                for r in results]

    return ([r.to_json_dict() for r in a] == [r.to_json_dict() for r in b]
            and floats(a) == floats(b))


def _profile_stream(det, frames, prm, iou, ms_per_frame) -> dict:
    """One more pass of detect_stream under torch.profiler: the device's
    busy time per frame (kernels and copies, summed from the device-side
    events alone, one stream so none overlap), its idle share against the
    unprofiled median ms/frame, the host's kernel-launch calls per frame
    and the device time per frame of the largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = list(det.detect_stream(frames, prm, iou_threshold=iou,
                                     seed=SEED, depth=DET_DEPTH))
    check(len(out) == len(frames), "profiled stream lost frames")
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    n = len(frames)
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    check(busy > 0, "the profiler saw no device time")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        device_busy_ms_per_frame=busy,
        device_idle_share=1.0 - busy / ms_per_frame,
        kernel_launch_calls_per_frame=sum(
            e.count for e in events if e.key == "cudaLaunchKernel") / n,
        top_device_ms_per_frame={
            e.key[:60]: e.self_device_time_total / 1e3 / n for e in top})


def phase_detector(gray, hd, golden, det, card) -> dict:
    """FaceDetector on the card through its entry points (see the module
    docstring, phase 4)."""
    import torch

    from pigo_tpu_torch import FaceDetector
    from pigo_tpu_torch.detector import (MIN_EYE_FACE_SCALE, PERTURBS,
                                         Q_THRESH, CascadeParams, Detection,
                                         FaceResult)
    from pigo_tpu_torch.ops import face_cuda, pupil_cuda
    from pigo_tpu_torch.ops.cluster import cluster_detections
    from pigo_tpu_torch.utils.profiling import PipelineStats

    c = golden["config"]
    params = CascadeParams(c["min_size"], c["max_size"], c["shift_factor"],
                           c["scale_factor"])
    iou = c["iou"]
    hd_params = CascadeParams(**DET_HD)
    det_cpu = FaceDetector(device="cpu")
    rows, cols = gray.shape
    # the golden uniforms of the qualifying faces, in cluster order
    quals = [i for i, (_, _, sc, q) in enumerate(golden["clusters"])
             if q > Q_THRESH and sc > MIN_EYE_FACE_SCALE]
    u_eyes = np.concatenate([golden_uniforms(f"{GOLDEN_TAG}:face{i}:eyes", 2)
                             for i in quals])
    u_lmk = np.concatenate([golden_uniforms(f"{GOLDEN_TAG}:face{i}:lmk", 15)
                            for i in quals])
    streams = (
        ("sample", [np.roll(gray, i % 8, axis=1)
                    for i in range(STREAM_FRAMES)], params, 5),
        ("hd1080", [np.roll(hd, i % 8, axis=1) for i in range(HD_FRAMES)],
         hd_params, 3),
    )

    def frame_generator(i):
        return torch.Generator().manual_seed(SEED + i)

    # ---- the main path, counted: detect, then both streams
    face_cuda.face_cascade_launches = 0
    pupil_cuda.pupil_walk_launches = 0
    res = det.detect(gray, rows, cols, params, iou_threshold=iou,
                     uniforms=(u_eyes, u_lmk))
    single = (face_cuda.face_cascade_launches, pupil_cuda.pupil_walk_launches)
    streamed = {}
    stream_launches = {}
    for name, frames, prm, _ in streams:
        before = (face_cuda.face_cascade_launches,
                  pupil_cuda.pupil_walk_launches)
        streamed[name] = list(det.detect_stream(
            frames, prm, iou_threshold=iou, seed=SEED, depth=DET_DEPTH))
        stream_launches[name] = (
            face_cuda.face_cascade_launches - before[0],
            pupil_cuda.pupil_walk_launches - before[1])
    launches = {"face_cascade": face_cuda.face_cascade_launches,
                "pupil_walk": pupil_cuda.pupil_walk_launches}

    # ---- checks: golden, CPU parity, stream parity, launch counts
    check(single == (1, 2), f"detect made {single} (face_cascade, "
          "pupil_walk) launches, expected (1, 2)")
    want = golden["faces"]
    check(len(res) == len(want), f"{len(res)} faces, golden {len(want)}")
    lm = det.landmarks
    detector_points_golden = True
    for k, (r, w) in enumerate(zip(res, want)):
        check([r.face.row, r.face.col, r.face.scale] == w["face"][:3]
              and np.float32(r.face.q) == np.float32(w["face"][3]),
              f"face {r.face} != golden {w['face']}")
        check(len(r.eyes) == 2 and all(
            [e.row, e.col] == we[:2] and abs(e.scale - we[2]) <= 1e-5 * e.scale
            for e, we in zip(r.eyes, w["eyes"])),
            f"eyes {r.eyes} != golden {w['eyes']}")
        check([(n, fl) for n, fl, *_ in w["landmarks"]] == lm.point_schedule,
              "golden landmark schedule differs from the port's")
        points = [lm.get_landmark_point(
            n, r.eyes[0], r.eyes[1], gray, rows, cols, flip_v=fl,
            uniforms=u_lmk[15 * k + j])
            for j, (n, fl) in enumerate(lm.point_schedule)]
        check([[p.row, p.col] for p in points]
              == [pl[2:4] for pl in w["landmarks"]],
              "get_landmark_point != golden landmark points")
        detector_points_golden &= ([[p.row, p.col] for p in r.landmarks]
                                   == [pl[2:4] for pl in w["landmarks"]])
    res_cpu = det_cpu.detect(gray, rows, cols, params, iou_threshold=iou,
                             uniforms=(u_eyes, u_lmk))
    check(_same_results(res, res_cpu), "detect on the card != on the CPU")
    summary = {}
    for name, frames, prm, _ in streams:
        got = streamed[name]
        per = [det.detect(fr, fr.shape[0], fr.shape[1], prm,
                          iou_threshold=iou, generator=frame_generator(i))
               for i, fr in enumerate(frames)]
        check(len(got) == len(frames)
              and all(_same_results(a, b) for a, b in zip(got, per)),
              f"{name}: detect_stream != per-frame detect")
        eyed = sum(any(r.face.scale > MIN_EYE_FACE_SCALE for r in frame)
                   for frame in got)
        check(stream_launches[name] == (len(frames), 2 * eyed),
              f"{name}: {stream_launches[name]} launches for {len(frames)} "
              f"frames, {eyed} with a qualifying face")
        summary[name] = dict(
            frames=len(frames), frames_with_eyes=eyed,
            faces_in_first_frame=len(got[0]),
            points_per_face=sorted({len(r.landmarks) for r in got[0]}),
            launches=stream_launches[name])
    emit("detector", golden_faces_equal=True, golden_eyes_equal=True,
         golden_points_equal=True,
         detector_points_equal_golden=detector_points_golden,
         cpu_equal=True, stream_equal=True, detect_launches=single,
         streams=summary, launches=launches)

    # ---- streamed ms/frame, then a serial face / cluster / post breakdown
    timing = {}
    for name, frames, prm, reps in streams:
        per_frame = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = list(det.detect_stream(frames, prm, iou_threshold=iou,
                                         seed=SEED, depth=DET_DEPTH))
            per_frame.append((time.perf_counter() - t0) / len(frames) * 1e3)
            check(len(out) == len(frames), f"{name}: frames lost")
        per_frame.sort()
        stats = PipelineStats()
        for i, fr in enumerate(frames):
            with stats.stage("face", items=1):
                ticket = det._dispatch_faces(
                    det._frames(fr, fr.shape[0], fr.shape[1]),
                    det.face._single, prm, 0.0)
                hits = det.face._collect(ticket)[0]
            with stats.stage("cluster", items=1):
                results = [
                    FaceResult(face=Detection(int(r), int(c_), int(s), float(q)))
                    for r, c_, s, q in cluster_detections(hits, iou)
                    if q > Q_THRESH]
            with stats.stage("post", items=1):
                det._collect_post(det._dispatch_post(
                    results, ticket, PERTURBS, frame_generator(i), None))
        stages = {k: v["seconds"] / v["items"] * 1e3
                  for k, v in stats.as_dict()["stages"].items()}
        serial = sum(stages.values())
        median = per_frame[len(per_frame) // 2]
        timing[name] = dict(
            ms_per_frame_best=per_frame[0], ms_per_frame_median=median,
            reps=reps, frames=len(frames), depth=DET_DEPTH,
            serial_stage_ms=stages, serial_ms_per_frame=serial,
            post_share_of_serial=stages["post"] / serial,
            profile=_profile_stream(det, frames, prm, iou, median),
            card=card)
        emit("detector_time", stream=name, **timing[name])
    return {"launches": launches, "timing": timing, "summary": summary}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pigo_tpu_torch
    from pigo_tpu_torch import FaceCascade, FaceDetector
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
    with open(os.path.join(ROOT, "tests", "golden",
                           GOLDEN_TAG + ".json")) as fh:
        det_golden = json.load(fh)

    phase_build()
    forest = FaceCascade().tensors
    kstats = phase_kernel(gray, hd, forest, card)
    det = FaceDetector()
    c = det_golden["config"]
    pstats = phase_pupil_kernel(
        (("sample", gray, dict(min_size=c["min_size"],
                               max_size=c["max_size"],
                               shift_factor=c["shift_factor"],
                               scale_factor=c["scale_factor"])),
         ("hd1080", hd, DET_HD)), det, card)
    main = phase_main_path(gray, hd, golden, card)
    dmain = phase_detector(gray, hd, det_golden, det, card)
    check("jax" not in sys.modules and "pigo_tpu" not in sys.modules,
          "the port pulled in jax or pigo_tpu")

    head = kstats["shapes"]["headline"]
    post = [pstats["shapes"]["sample"][k] for k in ("eyes", "landmarks")]
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
    }, {
        "name": "pupil_walk",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/pupil_walk.cu",
        "replaces": "pigo_tpu/ops/pupil_pallas.py:48",
        "launches": dmain["launches"]["pupil_walk"],
        "max_abs_err": pstats["max_abs_err"],
        "ms": sum(w["ms"] for w in post),
        "plain_ms": sum(w["plain_ms"] for w in post),
        "bound_ms": sum(w["bound_ms"] for w in post),
        "bound_by": ("bytes" if all(w["bound_by"] == "bytes" for w in post)
                     else "operations"),
        "library_ms": None,
        "check": "bitwise equal to ops/pupil_dense.walk on (r, c, s)",
        "ms_is": "the two launches of the sample frame's post stage "
                 "(eyes, then landmarks)",
        "per_walk": {
            frame: {kind: {k: v[k] for k in ("walkers", "ms", "plain_ms",
                                              "bound_ms", "bound_by")}
                    for kind, v in shape.items() if kind != "faces"}
            for frame, shape in pstats["shapes"].items()},
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
