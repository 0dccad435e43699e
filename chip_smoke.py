#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (pigo_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. It imports nothing of JAX or pigo_tpu.

Phases (one result line each, then the kernels line, the card line, and
the final status line):
  1. build  — compile every kernel of the port from csrc/, one nvcc per
     library, all started together; print the compiler's register and
     spill report;
  2. kernel — each kernel against its plain PyTorch version on the card,
     bit for bit, at the main paths' shapes, with the kernel's and the
     plain version's times and its bound (from the pixels, code words and
     leaves this run's windows read): the face cascade over the
     400x320 headline pyramid and a 1080x1920 tiling of it, upright and
     rotated (plus its time over the surviving windows alone, the
     dependent load chain that bounds it, its time when every window
     walks every tree, and phase 2's longest worklist per block); the
     edges of its two-phase schedule (a never-failing forest, tree limits
     36 and 100, a random 80-tree forest, each with the finish of its
     marks); the tree-prefix kernel over the tail scales of both
     pyramids, upright and rotated, at the edges of its own schedule
     (tree limits 1, 32, 33 and 64 on a never-failing forest and a random
     one, and a random depth-8 forest), with its time when every tail
     window survives and its longest worklist per block; the exact finish
     of the marked windows against the full-forest cascade; the
     pupil/landmark walk for the eyes, the 15 landmark points and rotated
     eyes of the faces found in the sample frame and in the 1080p tiling,
     plus seeded random starts, and seeded random forests at the walk's
     edges (1, 20 and 32 trees, depth 1 and 10, flips, a walker count
     that is no multiple of a block's walkers), upright and rotated; the
     post stage of both frames' faces, the walk's two ensemble launches
     (detector.fused_post) against the composition around pupil_walk
     (detector.composed_post), with the device and enqueue times of each;
  3. main path — FaceCascade on the card in each mode (default,
     prefix=True, tree_cap=32, both): detections and clusters against
     tests/golden/sample_dense.json and tests/golden/sample.json, upright
     and at both frozen angles; stream_hits and sparse_hits_batch parity;
     each mode's streams equal the default mode's; the launches per frame
     of each mode; detect_sweep against per-angle run_cascade; the
     streamed ms/frame of each mode and at angle 0.07;
  4. detector — FaceDetector on the card: faces, eyes and landmark points
     against tests/golden/sample.json at its frozen uniforms, detect equal
     to the CPU run (upright and at angle 0.07), detect_stream equal to
     per-frame detect over the sample and 1080p streams, one face_cascade
     and two pupil_walk launches per frame with a qualifying face, the
     streamed ms/frame, a serial face / cluster / post breakdown, and a
     torch.profiler pass for the device's busy time and idle share;
  5. cluster kernel and device detector — the cluster kernel against its
     plain version and the host clustering, bit for bit, one launch a
     call, on the real hit lists of both frames, seeded random sets up to
     the capacity with equal-q ties (and one at the largest capacity), and
     the edge sets of tools/cluster_sets.py (thresholds -0.1 to 1.0,
     scale-0 entries, fractional coordinates, holes, the bit-word edges,
     identical entries, equal q, pairs at the threshold), each with its
     entries, seeds, time, bound and plain time; then FaceDetector.detect_stream_device, every dispatch under
     torch.cuda.set_sync_debug_mode("error"): both streams and the sample
     at angle 0.07 equal to per-frame detect, one frame through each rung
     of the ladder, the launches and host waits per frame, and its
     ms/frame and profile beside detect_stream's;
  6. host tail — FaceCascade(host_tail=True), alone and with tree_cap=32,
     on the headline and 1080p streams against host_tail=False on every
     frame, bit for bit, and on the golden corpus upright and at both
     frozen angles; the launches of its counted run; both routings'
     streamed ms/frame in turns, the host scales, their share of the
     windows, the tail hits and the host scan's ms per frame, and the
     engine's build (flags, SIMD, threads, the host's CPU);
  7. native_cluster — the host engine's clustering against
     ops/cluster.py on the sample's and the 1080p hit lists, bit for bit,
     with both times, and the face streams clustered through each;
  8. device stream with the host tail — detect_stream_device of a
     FaceDetector(host_tail=True) on both streams equal to per-frame
     detect, every dispatch under set_sync_debug_mode("error"), one host
     wait a dispatch, its escalations and tail hits per frame, and its
     ms/frame beside the all-card device stream;
  9. CLI — pigo_tpu_torch.cli.detect_payload (the CLI's detection between
     decode and draw) on the committed frame as RGB, equal to
     FaceDetector.detect's payload on the card with the same seed;
  10. sharded — multi-GPU detection (pigo_tpu_torch.parallel) on the one
     card: (a) every band of 2- and 4-rank meshes run in this process and
     merged, against single-card sparse_hits bit for bit, at the headline
     and the 1080p tiling, upright and at 0.07, default and prefix, and
     at hit capacity 1 (the exact re-read), with each run's launches
     against its bands'; (b) two gloo ranks on the card (this script
     started twice with --sharded-worker; NCCL refuses two ranks on one
     card): window_sharded_hits of 1080p frames and batch_hits of a
     headline batch against sparse_hits on both ranks, one face_cascade
     launch a frame (and a batch) each; (c) a one-rank NCCL group, the
     phase's counted run, the same checks in both modes, then both
     methods' ms a call beside sparse_hits and sparse_hits_batch, in
     turns (one card shows no multi-card gain);
  11. serve — the serving surface (pigo_tpu_torch.web) at the web server's
     defaults on 480x640 frames: the card's detect(frame, seed + i) for
     every request index, its first indices of both frames equal to the
     CPU's (the plain versions) bit for bit; (a) CudaStreamEngine at 1
     and 4 caller threads, three timed windows of 200 requests each and
     a mixed run with the 1080p frame off-stream, every answer equal to
     detect(frame, seed + i) for its own request index i, every dispatch
     under set_sync_debug_mode("error"); (b) web.main's server in this
     process, PNG frames POSTed at concurrency 1 and 3 through
     bench_client.run by a client process of its own (three windows of
     200), every body equal to results_to_json(detect(frame, seed + i))
     for its own i, and GET /stats, / and /cascade/facefinder
     (byte-exact); the counted run (`serve_launches`), the ladder's
     counters, launches per request, requests/s (median and spread over
     the windows) and latency beside detect_stream_device's ms/frame;
  12. demos — the seven demos (pigo_tpu_torch.demos: facedet, faceblur,
     puploc, facial_landmark, blinkdet, masquerade, talk_detector), each
     through its main with --engine cuda at the demos' defaults and seed
     0, on 8 BGR frames (the serve phase's 480x640 frame rolled by 0-7
     columns) from an in-memory source into a sink that keeps them, three
     passes each: frame i's results equal to the card's detect(frame_i,
     seed i) for the demo's pipeline, the full pipeline's first two
     frames equal to the CPU's; per pass 8 face_cascade launches and
     pupil_walk launches of 0 (facedet, faceblur), 1 (puploc, blinkdet,
     masquerade) or 2 (facial_landmark, talk_detector) a frame with an
     eyed face, no other kernel; every frame with a face drawn on; frames
     a second and the engine's and the drawing's ms a frame;
  13. kernels — one JSON line for every ported kernel, after the seconds
     each phase took.
The build also compiles the host C++ engine (g++, beside the nvcc builds).
Any failed check exits non-zero before the status line.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import time
import urllib.request
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)
HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
STREAM_FRAMES, STREAM_DEPTH = 64, 8
HD_FRAMES, HD_DEPTH = 24, 6
# kernel libraries: face_cascade holds face_cascade, face_finish and
# face_prefix (csrc/face_cascade.cu with csrc/face_prefix.cu)
LIBRARIES = ("face_cascade", "pupil_walk", "cluster_device")
ROT_ANGLE = 0.07  # the golden corpus's first frozen rotation
# FaceCascade modes of the main path: name -> constructor arguments, and
# the (face_cascade, face_prefix, face_finish) launches each makes per
# frame (or batch) on a pyramid with dense and tail scales
MODES = {
    "default": ({}, (1, 0, 0)),
    "prefix": ({"prefix": True}, (1, 1, 1)),
    "tree_cap": ({"tree_cap": 32}, (1, 0, 1)),
    "prefix_tree_cap": ({"prefix": True, "tree_cap": 32}, (1, 1, 1)),
}
# FaceDetector: the golden sample's configuration (tests/golden/sample.json
# holds its frozen faces, eyes and points) and the 1080p tiling's.
GOLDEN_TAG = "sample"
DET_HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
DET_DEPTH = 4
RANDOM_GROUPS = 8  # seeded random walk groups beside the real anchors
# H100 SXM published peaks (NVIDIA data sheet, at a 700 W power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F64_OPS_PER_S = 34e12  # f64 outside the tensor cores
# f64 operations of one IoU test of the cluster kernel (two halvings, eight
# bound sums, two min, two max, two differences, two clamps, three
# products, a sum, a difference, a quotient, a compare)
IOU_OPS = 25
# The frames of the rotated device stream
ROT_FRAMES = 8
# The sharded phase: mesh sizes whose bands run in one process, the 1080p
# frames each window-sharded run takes, the headline batch of batch_hits,
# and the timed calls of each method
SHARDED_NS = (2, 4)
SHARDED_HD_FRAMES = 4
SHARDED_BATCH = 8
SHARDED_REPS = 10
SHARDED_DEVICE = "cuda:0"  # the card of every rank in the sharded phase
# The serve phase: the web server's defaults (examples/common.py:49-53) on
# the 480x640 top-left of the 1080p tiling (the browser page's canvas and
# bench_client's frame), the stream engine's depth, the requests of each
# timed window (bench_client's default) and the windows at each caller
# count and concurrency, the engine's caller threads and the HTTP
# concurrencies, the mixed run's requests (half of them the 1080p frame,
# off-stream), and how many of each frame's first request indices have
# their card reference held against the CPU's
SERVE_CFG = dict(min_size=100, max_size=600, shift=0.1, scale=1.1, iou=0.2)
SERVE_SHAPE = (480, 640)
SERVE_DEPTH = 4
SERVE_REQUESTS = 200
SERVE_WINDOWS = 3
SERVE_THREADS = (1, 4)
SERVE_HTTP = (1, 3)
SERVE_MIXED = 8
SERVE_CPU_SEEDS = 3
# the demos (pigo_tpu_torch.demos): each one's pipeline (with_pupils,
# with_landmarks), as its main builds its engine
DEMOS = {"facedet": (False, False), "faceblur": (False, False),
         "puploc": (True, False), "facial_landmark": (True, True),
         "blinkdet": (True, False), "masquerade": (True, False),
         "talk_detector": (True, True)}
DEMO_FRAMES = 8
DEMO_PASSES = 3
DEMO_CPU_FRAMES = 2


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def plain_run(fn):
    """One call of a plain version, timed with CUDA events (a plain
    version is no yardstick of speed, and the comparisons before have
    warmed it up): (ms, result)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def golden_uniforms(tag: str, n: int, perturbs: int = 63) -> np.ndarray:
    """The golden corpus's jitter uniforms [n, perturbs, 3] f32 for a tag
    (a copy of pigo_tpu/tools/make_golden.py:111-114)."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return rng.random((n, perturbs, 3), dtype=np.float32)


FACE_KERNELS = ("face_cascade", "face_prefix", "face_finish")
LADDER = ("face_slot_escalations", "hit_cap_escalations",
          "tail_cap_escalations", "detect_fallbacks", "device_frame_waits")


def tally():
    """The launch counts of every kernel (pigo_tpu_torch.utils.build)."""
    from pigo_tpu_torch.utils.build import LAUNCHES

    return LAUNCHES


def face_counts():
    """The three face kernels' launch counts."""
    return tuple(tally()[k] for k in FACE_KERNELS)


def kernel_counts() -> dict:
    """Every kernel's launch count, by name."""
    return {k: tally()[k]
            for k in (*FACE_KERNELS, "pupil_walk", "cluster_device")}


def reset_kernel_counts() -> None:
    tally().clear()


def phase_build() -> None:
    from pigo_tpu_torch.ops import cluster_device, face_cuda, pupil_cuda
    from pigo_tpu_torch.utils import build

    def timed(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    def timed_native():
        t0 = time.perf_counter()
        build.build_native()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES) + 1) as pool:
        native = pool.submit(timed_native)
        seconds = dict(zip(LIBRARIES, pool.map(timed, LIBRARIES)))
        seconds["native"] = native.result()
    face_cuda.load_kernel()
    pupil_cuda.load_kernel()
    cluster_device.load_kernel()
    for name in LIBRARIES:
        report = [ln.strip() for ln in build.ptxas_report(name).splitlines()
                  if "registers" in ln or "spill" in ln]
        emit("build", library=name, seconds=seconds[name], ptxas=report)
    emit("build", library="native", seconds=seconds["native"],
         compiler=build.GXX, flags=build.NATIVE_FLAGS,
         path=os.path.relpath(build.native_library_path(), ROOT))
    emit("build", all_seconds=time.perf_counter() - t0)


def phase_kernel(gray, hd, forest, card) -> dict:
    """The three face kernels against their plain versions, bitwise, at
    both main-path shapes, over 5 frames (the real one and 4 seeded random
    ones): the cascade upright at the full forest and at 32 trees and
    rotated at the full forest; the prefix kernel over the tail scales,
    upright and rotated; the finish of the prefix marks against its plain
    version and against the full-forest cascade (on every mark, nothing
    else touched), and of the 32-tree marks against the cascade. Then
    times and bounds on the real frame alone, as the main path runs it."""
    import torch

    from pigo_tpu_torch.models.face import angle_index
    from pigo_tpu_torch.ops import face_cuda, face_dense
    from pigo_tpu_torch.ops.windows import build_window_plan
    from pigo_tpu_torch.tools.face_sweep import NEVER_FAIL, worklist_max
    from pigo_tpu_torch.utils.device import cuda_ms

    dev = forest.codes.device
    rng = np.random.default_rng(SEED)
    f = forest
    tables = (f.codes, f.preds, f.thresh)
    t_num = f.preds.shape[0]
    mark = face_dense.PREFIX_MARK
    rot = angle_index(ROT_ANGLE)
    stats = {"max_abs_err": dict.fromkeys(
        ("face_cascade", "face_prefix", "face_finish"), 0.0), "shapes": {}}
    # the facefinder's codes and leaves with thresholds that never fail
    # (its sums stay within a few units of 0), and a seeded random forest
    never = (f.codes, f.preds, torch.full_like(f.thresh, NEVER_FAIL))

    def random_forest(depth, trees):
        leaves = 1 << depth
        codes = rng.integers(-128, 128, (trees, leaves, 4)).astype(np.int8)
        codes[:, 0] = 0
        return tuple(torch.from_numpy(x).to(dev) for x in (
            codes, rng.uniform(-1.0, 1.0, (trees, leaves)).astype(np.float32),
            np.full(trees, -1.5, np.float32)))

    rand = random_forest(6, 80)
    rand8 = random_forest(8, 40)
    sched = face_cuda.schedule()
    phase1_trees, block_windows = sched["face_cascade"][:2]
    b_trees, b_windows = sched["face_prefix"][:2]
    stats["schedule"] = {k: v._asdict() for k, v in sched.items()}

    def compare(kernel, name, got, want, what):
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        stats["max_abs_err"][kernel] = max(stats["max_abs_err"][kernel], err)
        equal = bool(torch.equal(got, want))
        emit("kernel", kernel=kernel, shape=name, against=what,
             frames=int(got.shape[0]), windows=int(got.shape[1]),
             bitwise_equal=equal, max_abs_err=err)
        check(equal, f"{kernel} != {what} at {name}")

    def launched(kernel, fn):
        before = tally()[kernel]
        out = fn()
        n = tally()[kernel] - before
        check(n == 1, f"{n} {kernel} launches for one call")
        return out

    def plain_with_work(fn):
        """A plain version's time (one untracked call), its result, and the
        work its data took, counted in a second, tracked call."""
        ms, (out, _) = plain_run(lambda: fn(False))
        return ms, out, fn(True)[1]

    def bound(work, out_bytes, n_ops):
        """The bound from the bytes this run's data needs (the distinct
        pixels, 1 B, code words, 4 B, and leaves, 4 B, its windows read, the
        thresholds, 4 B, of the trees evaluated, and `out_bytes` of scores
        moved) and its f32 operations."""
        n_bytes = (work["pixels"] + 4 * work["code_words"]
                   + 4 * work["leaves"] + 4 * work["trees"] + out_bytes)
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
        return dict(bytes=n_bytes, f32_ops=n_ops, pixels=work["pixels"],
                    code_words=work["code_words"], leaves=work["leaves"],
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    for name, frame, cfg in (("headline", gray, HEADLINE), ("hd1080", hd, HD)):
        rows, cols = frame.shape
        plan = build_window_plan(rows, cols, **cfg)
        base, scale = face_cuda.device_plan(plan, dev)
        frames = np.stack([frame] + [
            rng.integers(0, 256, (rows, cols), dtype=np.uint8)
            for _ in range(4)])
        ft = torch.from_numpy(frames).to(dev)
        full = {}
        for a, t_limit in ((0, t_num), (0, 32), (rot, t_num)):
            qk = launched("face_cascade",
                          lambda: face_cuda.face_cascade(
                              ft, base, scale, *tables, t_limit, angle_idx=a))
            compare("face_cascade", name, qk, face_dense.classify_windows(
                ft, base, scale, *tables, t_limit, angle_idx=a),
                f"classify_windows, t_limit {t_limit}, angle_idx {a}")
            if t_limit == t_num:
                full[a] = qk
            else:
                capped = qk
        fin = launched("face_finish",
                       lambda: face_cuda.face_finish(
                           ft, base, scale, *tables, capped.clone()))
        compare("face_finish", name, fin, full[0],
                "face_cascade at the full forest (32-tree marks)")
        routed = face_cuda.route_plan(plan, t_num, prefix=True)
        [seg] = [sg for sg in routed.segments if sg.prefix]
        pb, ps = base[seg.lo:seg.hi], scale[seg.lo:seg.hi]
        for a in (0, rot):
            qb = launched("face_prefix",
                          lambda: face_cuda.face_prefix(
                              ft, pb, ps, *tables, seg.t_limit, angle_idx=a))
            compare("face_prefix", name, qb, face_dense.classify_windows(
                ft, pb, ps, *tables, seg.t_limit, angle_idx=a),
                f"classify_windows, t_limit {seg.t_limit}, angle_idx {a}")
            fin = launched("face_finish",
                           lambda: face_cuda.face_finish(
                               ft, pb, ps, *tables, qb.clone(), angle_idx=a))
            compare("face_finish", name, fin, face_dense.finish_marked(
                ft, pb, ps, *tables, qb.clone(), angle_idx=a),
                f"finish_marked of the prefix marks, angle_idx {a}")
            compare("face_finish", name, fin, torch.where(
                qb == mark, full[a][:, seg.lo:seg.hi], qb),
                "face_cascade at the full forest on the prefix marks, "
                f"untouched elsewhere, angle_idx {a}")

        # Kernel B's schedule edges (csrc/face_prefix.cu) over the tail
        # windows: tree limits 1 (phase 1 only), 32 (one round), 33 and 64
        # (a second round) on a never-failing forest (every window of every
        # block on the worklist) and a random depth-6 one, and a random
        # depth-8 forest (256 leaves a tree) at the limits its tables fit.
        for label, tabs, limits in (("never_fail", never, (1, 32, 33, 64)),
                                    ("random_d6_t80", rand, (1, 32, 33, 64)),
                                    ("random_d8_t40", rand8, (1, 23))):
            for a in (0, rot):
                for t_limit in limits:
                    qb = launched("face_prefix",
                                  lambda: face_cuda.face_prefix(
                                      ft, pb, ps, *tabs, t_limit,
                                      angle_idx=a))
                    compare("face_prefix", name, qb,
                            face_dense.classify_windows(
                                ft, pb, ps, *tabs, t_limit, angle_idx=a),
                            f"classify_windows, {label}, t_limit {t_limit}, "
                            f"angle_idx {a}")

        # The two-phase schedule's edges (csrc/face_cascade.cu): a forest
        # whose thresholds never fail (every window of every block goes to
        # the worklist), tree limits that are not multiples of 32, and a
        # random depth-6, 80-tree forest (phase 2 ends in a partial chunk),
        # upright and rotated; the marks of each capped cascade finished
        # against finish_marked.
        for label, tabs, limits in (("never_fail", never, (t_num, 36, 100)),
                                    ("facefinder", tables, (36, 100)),
                                    ("random_d6_t80", rand, (80, 36))):
            for a in (0, rot):
                for t_limit in limits:
                    what = f"{label}, t_limit {t_limit}, angle_idx {a}"
                    qk = launched("face_cascade",
                                  lambda: face_cuda.face_cascade(
                                      ft, base, scale, *tabs, t_limit,
                                      angle_idx=a))
                    compare("face_cascade", name, qk,
                            face_dense.classify_windows(
                                ft, base, scale, *tabs, t_limit,
                                angle_idx=a), f"classify_windows, {what}")
                    if t_limit == tabs[2].shape[0]:
                        continue
                    fin = launched("face_finish",
                                   lambda: face_cuda.face_finish(
                                       ft, base, scale, *tabs, qk.clone(),
                                       angle_idx=a))
                    compare("face_finish", name, fin,
                            face_dense.finish_marked(
                                ft, base, scale, *tabs, qk.clone(),
                                angle_idx=a), f"finish_marked of the {what} "
                            "marks")

        # Times on the first (real) frame alone, as the main path runs it.
        # Each plain version runs once, timed, then once more to count its
        # work.
        one = ft[:1].contiguous()
        args = (one, base, scale, *tables, t_num)
        ms = cuda_ms(lambda: face_cuda.face_cascade(*args), 50, True)
        plain_ms, q, work = plain_with_work(
            lambda track: face_dense.cascade_with_work(*args, track=track))
        evals = work["evaluations"]
        alive = torch.nonzero(q[0] > 0).flatten()
        survivors = int(alive.numel())
        # The same launch over the survivors alone: each walks all T trees,
        # so this times the dependent load chain that bounds the kernel.
        sub = (one, base[alive].contiguous(), scale[alive].contiguous(),
               *tables, t_num)
        survivors_ms = cuda_ms(lambda: face_cuda.face_cascade(*sub), 50,
                               True)
        # The worst case of the two-phase schedule: every window walks every
        # tree, each block's whole worklist in phase 2.
        all_survive_ms = cuda_ms(lambda: face_cuda.face_cascade(
            one, base, scale, *never, t_num), 5, True)
        # Phase 2's worklists: per block of block_windows windows, those
        # alive after phase1_trees trees (the cascade) or marked (the
        # finish of the prefix marks, upright).
        alive_k = face_dense.classify_windows(one, base, scale, *tables,
                                              phase1_trees) != -1.0
        marks_b = face_dense.classify_windows(one, pb, ps, *tables,
                                              seg.t_limit) == mark
        alive_b = face_dense.classify_windows(one, pb, ps, *tables,
                                              b_trees) != -1.0
        worklist = dict(phase1_trees=phase1_trees,
                        block_windows=block_windows,
                        cascade_max=worklist_max(alive_k, block_windows),
                        cascade_windows=int(alive_k.sum()),
                        finish_max=worklist_max(marks_b, block_windows),
                        finish_windows=int(marks_b.sum()),
                        prefix_phase1_trees=b_trees,
                        prefix_block_windows=b_windows,
                        prefix_max=worklist_max(alive_b, b_windows),
                        prefix_windows=int(alive_b.sum()))
        emit("kernel_worklist", shape=name, **worklist)
        w = plan.num_windows
        # Bytes the function must move (`bound`) with the f32 scores
        # written. The plan's window tables (8 B a window) are not counted:
        # they follow from the geometry and could be derived in the kernel.
        # f32 work: one add and one compare per tree evaluation, one
        # subtract per survivor (integer address math is not counted).
        shape = dict(
            rows=rows, cols=cols, windows=w, scales=len(plan.scales),
            tree_evaluations=evals, survivors=survivors,
            plan_table_bytes=8 * w, ms=ms, plain_ms=plain_ms,
            survivors_only_ms=survivors_ms, all_survive_ms=all_survive_ms,
            worklist=worklist,
            **bound(work, 4 * w, 2 * evals + survivors), card=card)
        rot_plain_ms, q, work = plain_with_work(
            lambda track: face_dense.cascade_with_work(
                *args, angle_idx=rot, track=track))
        rot_evals = work["evaluations"]
        shape["rotated"] = dict(
            angle=ROT_ANGLE,
            ms=cuda_ms(lambda: face_cuda.face_cascade(*args, angle_idx=rot),
                       50, True),
            plain_ms=rot_plain_ms, tree_evaluations=rot_evals,
            survivors=int((q > 0).sum()),
            **bound(work, 4 * w, 2 * rot_evals + int((q > 0).sum())))

        # The prefix kernel over the tail scales, and the finish of its
        # marks (timed as copy + finish less the copy alone: the finish
        # overwrites the marks it is given).
        wb = seg.hi - seg.lo
        bargs = (one, pb, ps, *tables, seg.t_limit)
        shape["prefix"] = {
            "scales": int(routed.prefix.sum()), "windows": wb,
            "t_limit": seg.t_limit,
            # every tail window walks all t_limit trees (worst case)
            "all_survive_ms": cuda_ms(lambda: face_cuda.face_prefix(
                one, pb, ps, *never, seg.t_limit), 50, True)}
        shape["finish"] = {}
        for label, a in (("upright", 0), ("rotated", rot)):
            b_plain_ms, qm, work = plain_with_work(
                lambda track: face_dense.cascade_with_work(
                    *bargs, angle_idx=a, track=track))
            b_evals = work["evaluations"]
            marks = int((qm == mark).sum())
            shape["prefix"][label] = dict(
                angle_idx=a,
                ms=cuda_ms(lambda: face_cuda.face_prefix(
                    *bargs, angle_idx=a), 50, True),
                plain_ms=b_plain_ms, tree_evaluations=b_evals,
                survivors=marks,
                # what the windows read, and 4 B of score a window
                **bound(work, 4 * wb, 2 * b_evals))
            work = qm.clone()
            copy_ms = cuda_ms(lambda: work.copy_(qm), 50, True)
            fin_ms = cuda_ms(lambda: face_cuda.face_finish(
                one, pb, ps, *tables, work.copy_(qm), angle_idx=a), 50,
                True) - copy_ms
            f_plain_ms, _, work = plain_with_work(
                lambda track: face_dense.finish_with_work(
                    one, pb, ps, *tables, qm.clone(), angle_idx=a,
                    track=track))
            f_evals = work["evaluations"]
            shape["finish"][label] = dict(
                angle_idx=a, windows=wb, marks=marks, ms=fin_ms,
                copy_ms=copy_ms, plain_ms=f_plain_ms,
                tree_evaluations=f_evals,
                # what the marks read, the range's scores read and the
                # marks' scores written
                **bound(work, 4 * wb + 4 * marks, 2 * f_evals + marks))
        stats["shapes"][name] = shape
        emit("kernel_time", shape=name, **shape)
    return stats


def phase_pupil_kernel(frames, det, card) -> dict:
    """pupil_walk against the plain walk, bitwise on (r, c, s), for the
    walks the main path makes on each frame (eyes, then the 15 landmark
    points anchored on the eyes' medians) and for rotated eyes, each with
    RANDOM_GROUPS seeded random groups besides; then the kernel's and the
    plain version's times on the main path's walks alone, and the bound;
    the post stage's ensemble launches against the composition around
    pupil_walk, bitwise, and the times of both; then seeded random forests
    at the walk's edges."""
    import torch

    from pigo_tpu_torch.ops import pupil_cuda, pupil_dense
    from pigo_tpu_torch.tools.face_sweep import post_walks, walker_inputs
    from pigo_tpu_torch.utils.device import cuda_ms

    dev = det.device
    rng = np.random.default_rng(SEED)
    stats = {"max_abs_err": 0.0, "shapes": {}}

    def compare(t, walkers, pix, kw, what):
        before = tally()["pupil_walk"]
        got = pupil_cuda.pupil_walk(t.codes, t.preds, *walkers, pix, **kw)
        launches = tally()["pupil_walk"] - before
        want = pupil_dense.walk(t.codes, t.preds, *walkers, pix, **kw)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        check(launches == 1, f"{launches} pupil_walk launches for one walk")
        check(equal, f"pupil_walk != plain walk: {what}")
        return launches, equal, err

    def post_stage(faces, pix, rows, cols):
        """The post stage of `faces` from seeded uniforms: fused_post's
        two ensemble launches against composed_post (the tensor ops
        around two pupil_walk calls) bit for bit, then the device time of
        each, every launch included, and the host's time to enqueue it."""
        from pigo_tpu_torch.detector import (composed_post, eye_anchors,
                                             fused_post)

        f = len(faces)
        cids, flips = det.landmarks.schedule_arrays(f)
        args = (*(torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for v in eye_anchors(faces).T), pix, det.pupil.tensors,
                det.landmarks.tensors,
                *(torch.from_numpy(rng.random((k, 63, 3), dtype=np.float32)
                                   ).to(dev) for k in (2 * f, 15 * f)),
                torch.from_numpy(cids).to(dev),
                torch.from_numpy(flips).to(dev))
        kw = dict(rows=rows, cols=cols, dim=cols)
        before = tally()["pupil_walk"]
        got = fused_post(*args, **kw)
        launches = tally()["pupil_walk"] - before
        want = composed_post(*args, **kw)
        torch.cuda.synchronize()
        equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
        check(launches == 2, f"{launches} launches for one post stage")
        check(equal, f"ensemble launches != composition at {f} faces")
        out = dict(faces=f, launches=launches, bitwise_equal=equal)
        for key, fn in (("ensemble", fused_post), ("composed", composed_post)):
            out[f"{key}_ms"] = cuda_ms(lambda fn=fn: fn(*args, **kw), 50,
                                       True)
            t0 = time.perf_counter()
            for _ in range(50):
                fn(*args, **kw)
            out[f"{key}_host_ms"] = (time.perf_counter() - t0) * 1e3 / 50
            torch.cuda.synchronize()
        return out

    for name, frame, params in frames:
        rows, cols = frame.shape
        faces, pix, walks = post_walks(det, frame, params, rng)
        f = len(faces)
        check(f >= 1, f"{name}: no qualifying face")
        pt, real_eyes = walks["eyes"]
        lt, real_lmk = walks["landmarks"]
        kw = dict(nrows=rows, ncols=cols, dim=cols)

        def random_groups(smin, smax, n_casc, flip):
            g = RANDOM_GROUPS
            anchors = np.stack([rng.uniform(0, rows, g),
                                rng.uniform(0, cols, g),
                                rng.uniform(smin, smax, g)], 1)
            return walker_inputs(
                anchors.astype(np.float32), rng.integers(0, n_casc, g),
                (rng.random(g) < 0.5) & flip,
                rng.random((g, 63, 3), dtype=np.float32), dev)

        checks = (
            ("eyes", pt, real_eyes, random_groups(8, 80, 1, False), False),
            ("landmarks", lt, real_lmk,
             random_groups(30, 300, lt.codes.shape[0], True), False),
            ("eyes_rotated", pt, real_eyes, random_groups(8, 80, 1, True),
             True),
        )
        shape = {"faces": f}
        for kind, t, real, extra, rotated in checks:
            wkw = dict(kw, scale_mult=t.scale_mult, rotated=rotated,
                       angle_idx=pupil_dense.angle_index(0.25)
                       if rotated else 0)
            both = [torch.cat([a, b]).contiguous()
                    for a, b in zip(real, extra)]
            launches, equal, err = compare(t, both, pix, wkw,
                                           f"{name} {kind}")

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
        shape["post"] = post_stage(faces, pix, rows, cols)
        emit("pupil_ensemble", frame=name, card=card, **shape["post"])
        stats["shapes"][name] = shape

    # The walk's edges on seeded random forests over the first frame: one
    # lane's tree, 20 and a full warp's 32 trees a stage; depth 1 (the root
    # is the last level) and 10; flipped walkers; a walker count that is no
    # multiple of a block's walkers; upright and rotated.
    from pigo_tpu_torch.convert import pupil_forest_from_numpy

    name, frame, _ = frames[0]
    rows, cols = frame.shape
    pix = torch.from_numpy(np.ascontiguousarray(frame).reshape(-1)).to(dev)
    warps = pupil_cuda.schedule()
    n = 7 * warps * 4 + 3
    edges = []
    for trees in (1, 20, 32):
        for depth in (1, 10):
            nc, stages, leaves = 3, 4, 1 << depth
            codes = rng.integers(-128, 128, (nc, stages, trees, leaves, 4),
                                 dtype=np.int8)
            preds = rng.uniform(-0.3, 0.3, (nc, stages, trees, leaves, 2)
                                ).astype(np.float32)
            t = pupil_forest_from_numpy(codes, preds, stages=stages,
                                        trees=trees, depth=depth,
                                        scale_mult=0.9, device=dev)
            walkers = [torch.from_numpy(a).to(dev) for a in (
                rng.integers(0, nc, n).astype(np.int32),
                rng.uniform(0, rows, n).astype(np.float32),
                rng.uniform(0, cols, n).astype(np.float32),
                rng.uniform(8, 200, n).astype(np.float32),
                np.where(rng.random(n) < 0.5, -1, 1).astype(np.int32))]
            for a in (0, 8):
                wkw = dict(nrows=rows, ncols=cols, dim=cols, scale_mult=0.9,
                           rotated=a > 0, angle_idx=a)
                compare(t, walkers, pix, wkw,
                        f"random forest, {trees} trees, depth {depth}, "
                        f"angle_idx {a}")
                edges.append([trees, depth, a])
    emit("pupil_kernel_edges", frame=name, walkers=n,
         warps_per_block=warps, cases=edges, bitwise_equal=True)
    stats["warps_per_block"] = warps
    return stats


def _cfg(golden) -> dict:
    c = golden["config"]
    return dict(min_size=c["min_size"], max_size=c["max_size"],
                shift_factor=c["shift_factor"], scale_factor=c["scale_factor"])


def phase_main_path(gray, hd, goldens, card) -> dict:
    """FaceCascade on the card through its user entry points, in each mode
    of MODES. Each mode's counted run: the golden detections (upright and
    at both frozen angles) and clusters of every tag in `goldens`, 8
    single frames, the headline stream, a batch, the 1080p stream, a
    rotated headline stream and a 3-angle detect_sweep; every call has
    dense and tail scales, so the launches are the mode's per-frame counts
    times the calls. Then the streamed ms/frame of each mode, and at angle
    0.07."""
    from pigo_tpu_torch import FaceCascade, cluster_detections
    from pigo_tpu_torch.utils.profiling import PipelineStats

    rows, cols = gray.shape
    frames = [np.roll(gray, i % 8, axis=1) for i in range(STREAM_FRAMES)]
    hdf = [np.roll(hd, i % 8, axis=1) for i in range(HD_FRAMES)]
    sweep_angles = (0.0, ROT_ANGLE, 0.125)
    sweep_cfg = _cfg(goldens["sample"])
    cascades = {mode: FaceCascade(**kw) for mode, (kw, _) in MODES.items()}
    ref = {}
    launches = [0, 0, 0]
    summary = {}
    for mode, fc in cascades.items():
        reset_kernel_counts()
        calls = 0
        for tag, golden in goldens.items():
            cfg = _cfg(golden)
            for angle, want in [(0.0, golden["detections"])] + [
                    (r["angle"], r["detections"])
                    for r in golden["rotations"]]:
                dets = fc.run_cascade(gray, rows, cols, angle=angle, **cfg)
                want = np.asarray(want, np.float64).reshape(-1, 4)
                check(dets.shape == want.shape and np.array_equal(dets, want),
                      f"{mode}: {tag} detections at angle {angle} "
                      f"{dets.shape} != golden {want.shape}")
            clusters = fc.detect(gray, rows, cols,
                                 iou_threshold=golden["config"]["iou"], **cfg)
            check(np.array_equal(clusters, np.asarray(
                golden["clusters"], np.float64).reshape(-1, 4)),
                f"{mode}: {tag} clusters != golden")
            calls += len(golden["rotations"]) + 2
        wants = [fc.run_cascade(fr, rows, cols, **HEADLINE)
                 for fr in frames[:8]]
        outs = list(fc.stream_hits(frames, depth=STREAM_DEPTH, **HEADLINE))
        batch = fc.sparse_hits_batch(np.stack(frames[:8]), **HEADLINE)
        hd_outs = list(fc.stream_hits(hdf, depth=HD_DEPTH, **HD))
        rot_outs = list(fc.stream_hits(frames[:8], depth=STREAM_DEPTH,
                                       angle=ROT_ANGLE, **HEADLINE))
        swept = fc.detect_sweep(gray, rows, cols, sweep_angles, **sweep_cfg)
        counts = face_counts()
        calls += 8 + STREAM_FRAMES + 1 + HD_FRAMES + 8 + len(sweep_angles)
        expected = tuple(calls * k for k in MODES[mode][1])

        check(len(outs) == STREAM_FRAMES and all(
            np.array_equal(o, wants[i % 8]) for i, o in enumerate(outs)),
            f"{mode}: stream_hits != run_cascade")
        check(len(batch) == 8 and all(
            np.array_equal(b, w) for b, w in zip(batch, wants)),
            f"{mode}: sparse_hits_batch != run_cascade")
        check(len(hd_outs) == HD_FRAMES
              and all(o.shape[0] >= 1 for o in hd_outs),
              f"{mode}: the 1080p stream lost the faces")
        per_angle = np.concatenate([
            fc.run_cascade(gray, rows, cols, angle=a, **sweep_cfg)
            for a in sweep_angles])
        check(np.array_equal(swept, cluster_detections(per_angle, 0.01)),
              f"{mode}: detect_sweep != per-angle run_cascade + clustering")
        streams = {"headline": outs, "hd1080": hd_outs, "rotated": rot_outs}
        if mode == "default":
            ref = streams
        for k, got in streams.items():
            check(all(np.array_equal(a, b) for a, b in zip(got, ref[k])),
                  f"{mode}: {k} stream != the default mode's")
        check(counts == expected,
              f"{mode}: (face_cascade, face_prefix, face_finish) launches "
              f"{counts}, expected {expected}")
        launches = [x + y for x, y in zip(launches, counts)]
        summary[mode] = dict(
            golden_equal=True, stream_equal_default=True,
            detect_sweep_equal=True, calls=calls, launches=counts,
            expected_launches=expected,
            headline_detections=int(wants[0].shape[0]),
            rotated_detections=int(rot_outs[0].shape[0]),
            hd_min_hits=int(min(o.shape[0] for o in hd_outs)))
        emit("main_path", mode=mode, **summary[mode])

    # Streamed ms/frame, as bench.py times the TPU package: drain the
    # stream, then cluster every frame, inside one timed rep.
    timing = {}
    runs = [(mode, 0.0) for mode in MODES] + [("default", ROT_ANGLE),
                                             ("prefix", ROT_ANGLE)]
    for mode, angle in runs:
        fc = cascades[mode]
        key = mode if angle == 0.0 else f"{mode}_angle_{angle}"
        timing[key] = {}
        for name, fr, cfg, depth, reps in (
                ("headline", frames, HEADLINE, STREAM_DEPTH,
                 5 if key == "default" else 2),
                ("hd1080", hdf, HD, HD_DEPTH, 3 if key == "default" else 2)):
            stats = PipelineStats()
            per_frame = []
            reset_kernel_counts()
            for _ in range(reps):
                t0 = time.perf_counter()
                with stats.stage("stream_hits", items=len(fr)):
                    hits = list(fc.stream_hits(fr, depth=depth, angle=angle,
                                               **cfg))
                with stats.stage("cluster", items=len(fr)):
                    n_cl = sum(cluster_detections(h, 0.2).shape[0]
                               for h in hits)
                per_frame.append((time.perf_counter() - t0) / len(fr) * 1e3)
                check(angle > 0.0 or n_cl >= len(fr),
                      f"{key} {name}: faces lost in the timed stream")
            per_frame.sort()
            per = tuple(n / (reps * len(fr)) for n in face_counts())
            check(per == MODES[mode][1],
                  f"{key} {name}: {per} launches per frame")
            timing[key][name] = dict(
                ms_per_frame_best=per_frame[0],
                ms_per_frame_median=per_frame[len(per_frame) // 2],
                reps=reps, frames=len(fr), depth=depth,
                launches_per_frame=per,
                stages={k: v["seconds"] / v["items"] * 1e3
                        for k, v in stats.as_dict()["stages"].items()},
                card=card)
            emit("main_path_time", mode=mode, angle=angle, shape=name,
                 **timing[key][name])
    return {"launches": dict(zip(
        ("face_cascade", "face_prefix", "face_finish"), launches)),
        "timing": timing, "modes": summary}


def _same_results(a, b) -> bool:
    """Two list[FaceResult] agree: the JSON payload and every f32 scale."""
    def floats(results):
        return [[p.scale for p in r.eyes + r.landmarks] + [r.face.q]
                for r in results]

    return ([r.to_json_dict() for r in a] == [r.to_json_dict() for r in b]
            and floats(a) == floats(b))


def _profile_stream(det, frames, prm, iou, ms_per_frame,
                    method: str = "detect_stream") -> dict:
    """One more pass of the detector's stream `method` under
    torch.profiler: the device's busy time per frame (kernels and copies,
    summed from the device-side events alone, one stream so none overlap),
    its idle share against the unprofiled median ms/frame, the host's
    kernel-launch calls per frame and the device time per frame of the
    largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = list(getattr(det, method)(frames, prm, iou_threshold=iou,
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


def detector_streams(gray, hd, golden):
    """The golden sample's (params, IoU) and the detector's streams:
    (name, frames, params, timing reps) for the sample (rolled 0-7
    columns) and the 1080p tiling."""
    from pigo_tpu_torch.detector import CascadeParams

    c = golden["config"]
    params = CascadeParams(c["min_size"], c["max_size"], c["shift_factor"],
                           c["scale_factor"])
    streams = (
        ("sample", [np.roll(gray, i % 8, axis=1)
                    for i in range(STREAM_FRAMES)], params, 5),
        ("hd1080", [np.roll(hd, i % 8, axis=1) for i in range(HD_FRAMES)],
         CascadeParams(**DET_HD), 3),
    )
    return params, c["iou"], streams


def frame_generator(i):
    import torch

    return torch.Generator().manual_seed(SEED + i)


def phase_detector(gray, hd, golden, det, card) -> dict:
    """FaceDetector on the card through its entry points (see the module
    docstring, phase 4)."""
    from pigo_tpu_torch import FaceDetector
    from pigo_tpu_torch.detector import (MIN_EYE_FACE_SCALE, PERTURBS,
                                         Q_THRESH, Detection, FaceResult)
    from pigo_tpu_torch.ops.cluster import cluster_detections
    from pigo_tpu_torch.utils.profiling import PipelineStats

    params, iou, streams = detector_streams(gray, hd, golden)
    det_cpu = FaceDetector(device="cpu")
    rows, cols = gray.shape
    # the golden uniforms of the qualifying faces, in cluster order
    quals = [i for i, (_, _, sc, q) in enumerate(golden["clusters"])
             if q > Q_THRESH and sc > MIN_EYE_FACE_SCALE]
    u_eyes = np.concatenate([golden_uniforms(f"{GOLDEN_TAG}:face{i}:eyes", 2)
                             for i in quals])
    u_lmk = np.concatenate([golden_uniforms(f"{GOLDEN_TAG}:face{i}:lmk", 15)
                            for i in quals])

    # ---- the main path, counted: detect, then both streams
    count = tally()
    count.clear()
    res = det.detect(gray, rows, cols, params, iou_threshold=iou,
                     uniforms=(u_eyes, u_lmk))
    single = (count["face_cascade"], count["pupil_walk"])
    streamed = {}
    stream_launches = {}
    for name, frames, prm, _ in streams:
        before = (count["face_cascade"], count["pupil_walk"])
        streamed[name] = list(det.detect_stream(
            frames, prm, iou_threshold=iou, seed=SEED, depth=DET_DEPTH))
        stream_launches[name] = (count["face_cascade"] - before[0],
                                 count["pupil_walk"] - before[1])
    launches = {"face_cascade": count["face_cascade"],
                "pupil_walk": count["pupil_walk"]}

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
    # rotated: the faces of the golden rotation, and the card equal to the
    # CPU with the same uniforms
    rot = det.detect(gray, rows, cols, params, angle=ROT_ANGLE,
                     iou_threshold=iou, generator=frame_generator(0))
    rot_cpu = det_cpu.detect(gray, rows, cols, params, angle=ROT_ANGLE,
                             iou_threshold=iou, generator=frame_generator(0))
    check(_same_results(rot, rot_cpu),
          f"detect at angle {ROT_ANGLE} on the card != on the CPU")
    rot_want = cluster_detections(np.asarray(
        golden["rotations"][0]["detections"], np.float64), iou)
    check(golden["rotations"][0]["angle"] == ROT_ANGLE and
          [[r.face.row, r.face.col, r.face.scale] for r in rot]
          == [list(map(int, d[:3])) for d in rot_want if d[3] > Q_THRESH],
          f"faces at angle {ROT_ANGLE} != the golden rotation's clusters")
    summary = {}
    per_frame_detect = {}
    for name, frames, prm, _ in streams:
        got = streamed[name]
        per = [det.detect(fr, fr.shape[0], fr.shape[1], prm,
                          iou_threshold=iou, generator=frame_generator(i))
               for i, fr in enumerate(frames)]
        per_frame_detect[name] = per
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
         cpu_equal=True, rotated_cpu_equal=True,
         rotated_faces=[[r.face.row, r.face.col, r.face.scale, len(r.eyes),
                         len(r.landmarks)] for r in rot],
         stream_equal=True, detect_launches=single,
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
    return {"launches": launches, "timing": timing, "summary": summary,
            "per_frame_detect": per_frame_detect}


@contextlib.contextmanager
def sync_free_dispatch(det):
    """Every device-stream dispatch of `det` (re-dispatches of the ladder
    too) runs under torch.cuda.set_sync_debug_mode("error"): a host
    synchronisation there raises."""
    import torch

    dispatch = det._dispatch_frame_device

    def guarded(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    det._dispatch_frame_device = guarded
    try:
        yield
    finally:
        del det._dispatch_frame_device


def ladder_counts(det) -> dict:
    """det's ladder (FaceDetector.ladder), every rung by name."""
    return {k: det.ladder[k] for k in LADDER}


def phase_cluster_kernel(gray, hd, golden, det, card) -> dict:
    """The cluster kernel against its plain version on the card, bit for
    bit, at the device detector's capacity (FaceCascade.HIT_CAPACITY): the
    real hit lists of the sample frame (golden configuration) and the
    1080p tiling, the seeded random sets of tools/cluster_sets.py (0, 1,
    60, 312 and 4096 entries, equal-q ties), and its edge sets of tools/cluster_sets.py (thresholds
    -0.1 to 1.0, scale-0 entries, fractional coordinates, holes in the
    valid mask and a count below the rows, the bit-word edges, identical
    entries, equal q, the pairs at the threshold); each also equal to the
    host clustering, one launch a call. Then the random set at
    MAX_CAPACITY slots. Every set is timed, with its bound and the plain
    version's time."""
    import torch

    from pigo_tpu_torch.ops import cluster_device as cd
    from pigo_tpu_torch.ops.cluster import cluster_detections
    from pigo_tpu_torch.tools import cluster_sets
    from pigo_tpu_torch.utils.device import cuda_ms

    cap = det.face.HIT_CAPACITY
    dev = det.device
    _, iou, streams = detector_streams(gray, hd, golden)
    cases = []
    for name, frames, prm, _ in streams:
        hits = det.face.run_cascade(
            frames[0], *frames[0].shape, min_size=prm.min_size,
            max_size=prm.max_size, shift_factor=prm.shift_factor,
            scale_factor=prm.scale_factor)
        cases.append((cluster_sets.full(name, hits, iou), cap))
    cases += [(cs, cap) for cs in cluster_sets.random_sets(cap)
              + cluster_sets.edge_sets(cap)]
    cases.append((cluster_sets.random_sets(cd.MAX_CAPACITY)[-1],
                  cd.MAX_CAPACITY))
    stats = {"max_abs_err": 0.0, "cases": {}}
    for cs, slots in cases:
        args = (*cluster_sets.buffers(cs, slots, dev), cs.iou)
        before = tally()["cluster_device"]
        got, gvalid = cd.cluster_device(*args, capacity=slots)
        torch.cuda.synchronize()
        check(tally()["cluster_device"] == before + 1,
              f"cluster_device {cs.name}: not one launch counted")
        plain_ms, (want, wvalid) = plain_run(
            lambda: cd.cluster_plain(*args))
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   float((got - want).abs().max()))
        check(torch.equal(gvalid, wvalid) and torch.equal(
            got.view(torch.int32), want.view(torch.int32)),
            f"cluster_device {cs.name}: kernel != plain version")
        entries = cs.entries()
        with np.errstate(invalid="ignore"):  # 0 / 0 of two scale-0 boxes
            host = cluster_detections(entries, cs.iou).astype(np.float32)
        check(np.array_equal(got[gvalid].cpu().numpy().view(np.int32),
                             host.view(np.int32)),
              f"cluster_device {cs.name}: != the host clustering")
        check(not cs.name.startswith("at_threshold")
              or int(gvalid.sum()) == 2,
              "a pair at the IoU threshold was joined")
        n = entries.shape[0]
        seeds = cluster_sets.seed_count(entries, cs.iou)
        ms = cuda_ms(lambda: cd.cluster_device(*args, capacity=slots), 100,
                     queue_ahead=True)
        # bytes: the count, `count` rows of dets and valid read, every
        # slot of both outputs written; operations: every seed's IoU test
        # against every entry, in f64
        b_s = (4 + 17 * cs.count + 17 * slots) / PEAK_BYTES_PER_S
        o_s = seeds * n * IOU_OPS / PEAK_F64_OPS_PER_S
        case = dict(entries=n, seeds=seeds, clusters=int(gvalid.sum()),
                    iou=cs.iou, capacity=slots, ms=ms, plain_ms=plain_ms,
                    bound_ms=max(b_s, o_s) * 1e3,
                    bound_by="bytes" if b_s >= o_s else "operations")
        stats["cases"][cs.name] = case
        emit("cluster_kernel", case=cs.name, card=card, **case)
    return stats


def phase_device_detector(gray, hd, golden, det, per_frame_detect,
                          card) -> dict:
    """FaceDetector.detect_stream_device on the card (see the module
    docstring, phase 5)."""
    from pigo_tpu_torch import FaceDetector
    from pigo_tpu_torch import detector as port_det

    params, iou, streams = detector_streams(gray, hd, golden)

    # ---- the main path, counted: both streams, every dispatch sync-free
    reset_kernel_counts()
    streamed, per_stream = {}, {}
    with sync_free_dispatch(det):
        for name, frames, prm, _ in streams:
            before = kernel_counts()
            det.ladder.clear()
            streamed[name] = list(det.detect_stream_device(
                frames, prm, iou_threshold=iou, seed=SEED, depth=DET_DEPTH))
            after = kernel_counts()
            per_stream[name] = dict(
                ladder=ladder_counts(det),
                launches={n: after[n] - before[n] for n in after})
    launches = kernel_counts()

    summary = {}
    for name, frames, prm, _ in streams:
        got, ladder = streamed[name], per_stream[name]["ladder"]
        check(len(got) == len(frames) and all(
            _same_results(a, b)
            for a, b in zip(got, per_frame_detect[name])),
            f"{name}: detect_stream_device != per-frame detect")
        up = ladder["face_slot_escalations"] + ladder["hit_cap_escalations"]
        check(ladder["detect_fallbacks"] == 0,
              f"{name}: {ladder['detect_fallbacks']} host fallbacks")
        check(up <= 1, f"{name}: {up} escalations")
        dispatches = len(frames) + up
        check(ladder["device_frame_waits"] == dispatches,
              f"{name}: {ladder['device_frame_waits']} host waits for "
              f"{len(frames)} frames and {up} escalations")
        eyed = sum(any(r.face.scale > port_det.MIN_EYE_FACE_SCALE
                       for r in frame) for frame in got)
        want = {"face_cascade": dispatches, "face_prefix": 0,
                "face_finish": 0, "pupil_walk": 2 * dispatches,
                "cluster_device": dispatches}
        check(per_stream[name]["launches"] == want,
              f"{name}: launches {per_stream[name]['launches']}, expected "
              f"{want}")
        summary[name] = dict(frames=len(frames), frames_with_eyes=eyed,
                             faces_per_frame=[len(r) for r in got[:8]],
                             **ladder,
                             launches=per_stream[name]["launches"])

    # ---- rotated: the sample at ROT_ANGLE against per-frame detect
    sample = streams[0][1][:ROT_FRAMES]
    with sync_free_dispatch(det):
        rot = list(det.detect_stream_device(
            sample, params, angle=ROT_ANGLE, iou_threshold=iou, seed=SEED,
            depth=DET_DEPTH))
    rot_want = [det.detect(fr, fr.shape[0], fr.shape[1], params,
                           angle=ROT_ANGLE, iou_threshold=iou,
                           generator=frame_generator(i))
                for i, fr in enumerate(sample)]
    check(all(_same_results(a, b) for a, b in zip(rot, rot_want))
          and len(rot) == ROT_FRAMES and len(rot[0]) >= 1,
          f"detect_stream_device at angle {ROT_ANGLE} != per-frame detect")

    # ---- one frame through each rung of the ladder (the 1080p frame:
    # 15 faces, 312 hits), forced with small caps: one face slot, then 64
    # hits, then one face slot with no rung above it
    frame, hd_params = streams[1][1][0], streams[1][2]
    cap = det.face.HIT_CAPACITY
    rungs = {
        "face_slots": ((cap, 0, 1), None, "face_slot_escalations"),
        "hit_caps": ((64, 0, 16), None, "hit_cap_escalations"),
        "detect": ((cap, 0, 1), (cap, 0, 1), "detect_fallbacks"),
    }
    ladder = {}
    for rung, (caps, escalated, counter) in rungs.items():
        rdet = FaceDetector(det.face, det.pupil, det.landmarks,
                            device_caps=caps, device=det.device)
        saved = port_det.DEV_CAPS_ESCALATED
        if escalated is not None:
            port_det.DEV_CAPS_ESCALATED = escalated
        try:
            with sync_free_dispatch(rdet):
                [got] = rdet.detect_stream_device(
                    [frame], hd_params, iou_threshold=iou, seed=SEED + 3,
                    depth=1)
        finally:
            port_det.DEV_CAPS_ESCALATED = saved
        want = det.detect(frame, frame.shape[0], frame.shape[1], hd_params,
                          iou_threshold=iou, generator=frame_generator(3))
        counts = ladder_counts(rdet)
        check(_same_results(got, want) and len(got) >= 2,
              f"ladder rung {rung}: != detect")
        check(counts[counter] == 1 and sum(counts.values())
              - counts["device_frame_waits"] == 1,
              f"ladder rung {rung}: counts {counts}")
        ladder[rung] = counts
    emit("device_detector", stream_equal=True, rotated_equal=True,
         rotated_faces=[[r.face.row, r.face.col, r.face.scale, len(r.eyes),
                         len(r.landmarks)] for r in rot[0]],
         streams=summary, ladder=ladder, launches=launches)

    # ---- ms/frame: the device stream beside detect_stream, in turns
    timing = {}
    for name, frames, prm, reps in streams:
        per = {"detect_stream_device": [], "detect_stream": []}
        for _ in range(reps):
            for method in per:
                t0 = time.perf_counter()
                out = list(getattr(det, method)(
                    frames, prm, iou_threshold=iou, seed=SEED,
                    depth=DET_DEPTH))
                per[method].append(
                    (time.perf_counter() - t0) / len(frames) * 1e3)
                check(len(out) == len(frames), f"{name}: frames lost")
        timing[name] = {}
        for method, ms in per.items():
            ms.sort()
            median = ms[len(ms) // 2]
            timing[name][method] = dict(
                ms_per_frame_best=ms[0], ms_per_frame_median=median,
                reps=reps, frames=len(frames), depth=DET_DEPTH,
                profile=_profile_stream(det, frames, prm, iou, median,
                                        method),
                card=card)
        emit("device_detector_time", stream=name, **timing[name])
    return {"launches": launches, "timing": timing, "summary": summary}


def host_cpu() -> dict:
    """The host's CPU (model name, or vendor, family and model where the
    system hides the name) and core count, beside host-side times."""
    import platform

    info = {}
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    model = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model")
        if k in info) or platform.processor() or platform.machine()
    return {"cpu": model, "cpu_count": os.cpu_count()}


def _stream_ms(run, frames, reps) -> list:
    """ms per frame of `reps` passes of run(frames), sorted."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = run(frames)
        out.append((time.perf_counter() - t0) / len(frames) * 1e3)
        check(len(got) == len(frames), "a timed stream lost frames")
    return sorted(out)


def _best_median(ms) -> dict:
    return {"ms_per_frame_best": ms[0],
            "ms_per_frame_median": ms[len(ms) // 2], "reps": len(ms)}


def phase_host_tail(gray, hd, goldens, card) -> dict:
    """FaceCascade(host_tail=True) on the card (see the module docstring,
    phase 6): the counted run, checked bit for bit against host_tail=False
    on every frame and against the goldens, then the timings in turns."""
    from pigo_tpu_torch import FaceCascade
    from pigo_tpu_torch.native import simd_available
    from pigo_tpu_torch.utils import build

    rows, cols = gray.shape
    frames = [np.roll(gray, i % 8, axis=1) for i in range(STREAM_FRAMES)]
    hdf = [np.roll(hd, i % 8, axis=1) for i in range(HD_FRAMES)]
    shapes = (("headline", frames, HEADLINE, STREAM_DEPTH),
              ("hd1080", hdf, HD, HD_DEPTH))
    modes = {"default": ({}, (1, 0, 0)), "tree_cap": ({"tree_cap": 32},
                                                      (1, 0, 1))}
    cascades = {m: (FaceCascade(host_tail=True, **kw), FaceCascade(**kw))
                for m, (kw, _) in modes.items()}
    out = {"modes": {}, "timing": {}, "shapes": {}}
    for mode, (ht, ref) in cascades.items():
        # ---- counted: both streams, then the golden corpus
        reset_kernel_counts()
        got = {name: list(ht.stream_hits(fr, depth=depth, **cfg))
               for name, fr, cfg, depth in shapes}
        calls = STREAM_FRAMES + HD_FRAMES
        for tag, golden in goldens.items():
            cfg = _cfg(golden)
            for angle, want in [(0.0, golden["detections"])] + [
                    (r["angle"], r["detections"])
                    for r in golden["rotations"]]:
                dets = ht.run_cascade(gray, rows, cols, angle=angle, **cfg)
                check(np.array_equal(dets, np.asarray(
                    want, np.float64).reshape(-1, 4)),
                    f"host tail {mode}: {tag} at angle {angle} != golden")
                calls += 1
        counts = face_counts()
        expected = tuple(calls * k for k in modes[mode][1])
        check(counts == expected, f"host tail {mode}: launches {counts}, "
              f"expected {expected}")
        for name, fr, cfg, depth in shapes:
            want = list(ref.stream_hits(fr, depth=depth, **cfg))
            check(all(np.array_equal(a, b) for a, b in zip(got[name], want))
                  and len(got[name]) == len(fr),
                  f"host tail {mode}: {name} stream != host_tail=False")
        out["modes"][mode] = dict(calls=calls, launches=counts,
                                  stream_equal_all_card=True,
                                  golden_equal=True)
        emit("host_tail", mode=mode, **out["modes"][mode])

    # ---- the routing and the host scan alone, per shape
    ht = cascades["default"][0]
    for name, fr, cfg, _ in shapes:
        routed = ht._plan(*fr[0].shape, *cfg.values())[0]
        counts = np.bincount(routed.windows.scale_idx,
                             minlength=routed.windows.scales.size)
        scales = routed.host_scales
        tails, scan_ms = [], []
        for f in fr[:8]:
            t0 = time.perf_counter()
            tail = ht.native.run_scales(f, *f.shape, scales,
                                        shift_factor=cfg["shift_factor"])
            scan_ms.append((time.perf_counter() - t0) * 1e3)
            tails.append(int(tail.shape[0]))
        scan_ms.sort()
        out["shapes"][name] = dict(
            scales=int(routed.windows.scales.size),
            host_scales=scales.tolist(),
            host_windows=int(counts[routed.host].sum()),
            windows=int(counts.sum()),
            host_share=float(counts[routed.host].sum() / counts.sum()),
            card_segments=len(routed.segments),
            tail_hits_per_frame=tails,
            raw_hits_per_frame=[int(h.shape[0]) for h in
                                ht.stream_hits(fr[:8], depth=8, **cfg)],
            host_scan_ms_best=scan_ms[0],
            host_scan_ms_median=scan_ms[len(scan_ms) // 2])
        emit("host_tail_routing", shape=name, **out["shapes"][name])

    # ---- the host scan alone by thread count (the engine starts a pool
    # of that many threads for every scale it scans)
    from pigo_tpu_torch.cascade.assets import asset_path
    from pigo_tpu_torch.native import NativeFaceCascade

    with open(asset_path("cascade", "facefinder"), "rb") as fh:
        raw = fh.read()
    out["threads"] = {}
    for name, fr, cfg, _ in shapes:
        scales = ht._plan(*fr[0].shape, *cfg.values())[0].host_scales
        row = {}
        for n in (1, 2, 4, 8):
            eng = NativeFaceCascade(raw, threads=n)
            ms = []
            for f in fr[:8]:
                t0 = time.perf_counter()
                eng.run_scales(f, *f.shape, scales,
                               shift_factor=cfg["shift_factor"])
                ms.append((time.perf_counter() - t0) * 1e3)
            ms.sort()
            row[n] = {"best": ms[0], "median": ms[len(ms) // 2]}
        out["threads"][name] = row
        emit("host_scan_threads", shape=name, card=card, host=host_cpu(),
             scan_ms=row)

    # ---- ms/frame, both routings in turns, each frame clustered
    from pigo_tpu_torch.ops.cluster import cluster_detections

    for mode, (ht, ref) in cascades.items():
        for name, fr, cfg, depth in shapes:
            per = {"host_tail": [], "all_card": []}
            for _ in range(3 if mode == "default" else 2):
                for routing, fc in (("host_tail", ht), ("all_card", ref)):
                    per[routing] += _stream_ms(
                        lambda f, fc=fc: [cluster_detections(h, 0.2) for h in
                                          fc.stream_hits(f, depth=depth,
                                                         **cfg)], fr, 1)
            row = {k: _best_median(sorted(v)) for k, v in per.items()}
            out["timing"][f"{mode}/{name}"] = row
            emit("host_tail_time", mode=mode, shape=name, depth=depth,
                 frames=len(fr), card=card, host=host_cpu(), **row)
    engine = ht.native
    out["engine"] = dict(
        compiler=build.GXX, flags=build.NATIVE_FLAGS,
        simd_active=engine.simd_active, simd_available=simd_available(),
        threads=engine.threads or min(os.cpu_count() or 1, 16),
        **host_cpu())
    emit("host_tail_engine", **out["engine"])
    return out


def phase_native_cluster(gray, hd, golden, det, card) -> dict:
    """native_cluster against ops/cluster.py (see the module docstring,
    phase 7)."""
    from pigo_tpu_torch import FaceCascade
    from pigo_tpu_torch.native import native_cluster
    from pigo_tpu_torch.ops.cluster import cluster_detections

    _, iou, streams = detector_streams(gray, hd, golden)
    out = {"lists": {}, "streams": {}}
    for name, frames, prm, _ in streams:
        hits = det.face.run_cascade(
            frames[0], *frames[0].shape, min_size=prm.min_size,
            max_size=prm.max_size, shift_factor=prm.shift_factor,
            scale_factor=prm.scale_factor)
        times = {"native_ms": [], "host_ms": []}
        for _ in range(20):
            t0 = time.perf_counter()
            a = native_cluster(hits, iou)
            times["native_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            b = cluster_detections(hits, iou)
            times["host_ms"].append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(a, b), f"native_cluster {name} != "
                  "ops/cluster.py")
        row = dict(hits=int(hits.shape[0]), clusters=int(a.shape[0]),
                   **{k + "_best": min(v) for k, v in times.items()},
                   **{k + "_median": sorted(v)[len(v) // 2]
                      for k, v in times.items()})
        out["lists"][name] = row
        emit("native_cluster", list=name, card=card, host=host_cpu(), **row)
    check(out["lists"]["hd1080"]["hits"] >= 300,
          "the 1080p list lost its hits")
    # the face streams clustered through each, in turns (bench.py:95-97)
    fc = FaceCascade()
    frames = [np.roll(gray, i % 8, axis=1) for i in range(STREAM_FRAMES)]
    hdf = [np.roll(hd, i % 8, axis=1) for i in range(HD_FRAMES)]
    for name, fr, cfg, depth in (("headline", frames, HEADLINE, STREAM_DEPTH),
                                 ("hd1080", hdf, HD, HD_DEPTH)):
        per = {"native_cluster": [], "cluster_detections": []}
        for _ in range(3):
            for method, fn in (("native_cluster", native_cluster),
                               ("cluster_detections", cluster_detections)):
                per[method] += _stream_ms(
                    lambda f, fn=fn: [fn(h, 0.2) for h in fc.stream_hits(
                        f, depth=depth, **cfg)], fr, 1)
        out["streams"][name] = {k: _best_median(sorted(v))
                                for k, v in per.items()}
        emit("native_cluster_stream", shape=name, card=card,
             host=host_cpu(), **out["streams"][name])
    return out


def phase_device_host_tail(gray, hd, golden, det, per_frame_detect,
                           card) -> dict:
    """detect_stream_device with the host tail (see the module docstring,
    phase 8)."""
    from pigo_tpu_torch import FaceCascade, FaceDetector
    from pigo_tpu_torch import detector as port_det

    _, iou, streams = detector_streams(gray, hd, golden)
    hdet = FaceDetector(FaceCascade(host_tail=True), det.pupil, det.landmarks,
                        host_tail=True)

    summary, timing = {}, {}
    for name, frames, prm, _ in streams:
        reset_kernel_counts()
        hdet.ladder.clear()
        with sync_free_dispatch(hdet):
            got = list(hdet.detect_stream_device(
                frames, prm, iou_threshold=iou, seed=SEED, depth=DET_DEPTH))
        launches, ladder = kernel_counts(), ladder_counts(hdet)
        check(len(got) == len(frames) and all(
            _same_results(a, b) for a, b in zip(got, per_frame_detect[name])),
            f"{name}: host-tail detect_stream_device != per-frame detect")
        own = [hdet.detect(fr, *fr.shape, prm, iou_threshold=iou,
                           generator=frame_generator(i))
               for i, fr in enumerate(frames[:8])]
        check(all(_same_results(a, b) for a, b in zip(got, own)),
              f"{name}: host-tail detect_stream_device != its own detect")
        up = ladder["face_slot_escalations"] + ladder["hit_cap_escalations"]
        dispatches = len(frames) + up
        check(ladder["detect_fallbacks"] == 0 and up <= 1,
              f"{name}: ladder {ladder}")
        check(ladder["tail_cap_escalations"] == 0,
              f"{name}: the host tail overflowed its cap")
        check(ladder["device_frame_waits"] == dispatches,
              f"{name}: {ladder['device_frame_waits']} host waits for "
              f"{dispatches} dispatches")
        want = {"face_cascade": dispatches, "face_prefix": 0,
                "face_finish": 0, "pupil_walk": 2 * dispatches,
                "cluster_device": dispatches}
        check(launches == want, f"{name}: launches {launches}, expected "
              f"{want}")
        routed = hdet.face._plan(*frames[0].shape, prm.min_size,
                                 prm.max_size, prm.shift_factor,
                                 prm.scale_factor)[0]
        tails = [int(hdet.face.native.run_scales(
            f, *f.shape, routed.host_scales,
            shift_factor=prm.shift_factor).shape[0]) for f in frames[:8]]
        summary[name] = dict(frames=len(frames), **ladder,
                             launches=launches, tail_hits_per_frame=tails,
                             tail_cap=port_det.DEV_TAIL_CAP,
                             faces_per_frame=[len(r) for r in got[:8]])
        emit("device_host_tail", stream=name, equal_detect=True,
             **summary[name])
        per = {"host_tail": [], "all_card": []}
        for _ in range(2):
            for routing, d in (("host_tail", hdet), ("all_card", det)):
                per[routing] += _stream_ms(
                    lambda f, d=d: list(d.detect_stream_device(
                        f, prm, iou_threshold=iou, seed=SEED,
                        depth=DET_DEPTH)), frames, 1)
        timing[name] = {k: _best_median(sorted(v)) for k, v in per.items()}
        emit("device_host_tail_time", stream=name, card=card,
             host=host_cpu(), **timing[name])
    return {"summary": summary, "timing": timing}


def phase_cli(gray, det, card) -> dict:
    """The CLI's detection core on the card (see the module docstring,
    phase 9): its payload for the committed frame as RGB with the
    shipped cascades equals FaceDetector.detect's with the same seed."""
    import torch

    from pigo_tpu_torch.cascade.assets import asset_path
    from pigo_tpu_torch.cli import build_parser, detect_payload
    from pigo_tpu_torch.detector import CascadeParams
    from pigo_tpu_torch.io.image import rgb_to_grayscale

    rgb = np.repeat(gray[..., None], 3, axis=2)
    argv = ["-in", "-", "-out", "empty",
            "-cf", asset_path("cascade", "facefinder"),
            "-plc", asset_path("cascade", "puploc"),
            "-flpc", asset_path("cascade", "lps"), "-json", "-",
            "-seed", "7"]
    args = build_parser().parse_args(argv)
    reset_kernel_counts()
    t0 = time.perf_counter()
    results, payload = detect_payload(rgb, args)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = (tally()["face_cascade"], tally()["pupil_walk"])
    check(launches == (1, 2), f"the CLI made {launches} (face_cascade, "
          "pupil_walk) launches, expected (1, 2)")
    want = det.detect(rgb_to_grayscale(rgb), *gray.shape,
                      CascadeParams(args.min_size, args.max_size,
                                    args.shift_factor, args.scale_factor),
                      iou_threshold=args.iou_threshold,
                      generator=torch.Generator().manual_seed(7))
    check(payload == [r.to_json_dict() for r in want] and len(payload) >= 1
          and len(payload[0].get("landmark_points", [])) == 15,
          "the CLI's payload != FaceDetector.detect's")
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        detect_payload(rgb, args, detector=det)
        ms.append((time.perf_counter() - t0) * 1e3)
    ms.sort()
    out = dict(equal_detect=True, faces=len(payload), launches=launches,
               payload=payload, first_call_ms=first_ms,
               detect_ms_best=ms[0], detect_ms_median=ms[2], card=card)
    emit("cli", **out)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call_ms(fn) -> float:
    """Host ms of one call that ends in a host copy (so it waits for the
    card)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _ms_stats(ms) -> dict:
    """Best and median of a list of host ms a call."""
    ms = sorted(ms)
    return {"ms_best": ms[0], "ms_median": ms[len(ms) // 2], "reps": len(ms)}


def _sharded_frames(gray, hd):
    """The sharded phase's inputs: SHARDED_HD_FRAMES rolled 1080p frames
    and a batch of SHARDED_BATCH rolled headline frames."""
    return ([np.roll(hd, i, axis=1) for i in range(SHARDED_HD_FRAMES)],
            np.stack([np.roll(gray, i, axis=1)
                      for i in range(SHARDED_BATCH)]))


def _load_frames():
    """The committed sample frame and its 1080x1920 tiling."""
    gray = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                "sample_gray.npy"))
    hd = np.tile(gray, (1080 // 400 + 1, 1920 // 320 + 1))[:1080, :1920]
    return gray, hd


def sharded_worker(rank: int, port: int, device: str) -> int:
    """One rank of the sharded phase's (b): `chip_smoke.py --sharded-worker
    RANK PORT DEVICE`. It loads the kernels, joins a two-rank gloo group
    on DEVICE, runs window_sharded_hits over the 1080p frames and
    batch_hits of the headline batch (their launches counted), times both,
    and prints one `RESULT` JSON line."""
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from pigo_tpu_torch import FaceCascade
    from pigo_tpu_torch.ops import face_cuda
    from pigo_tpu_torch.parallel import (ShardedFaceCascade,
                                         init_distributed, make_mesh)

    gray, hd = _load_frames()
    hdf, batch = _sharded_frames(gray, hd)
    fc = FaceCascade(device=device)
    if fc.device.type == "cuda":
        face_cuda.load_kernel()  # built by the parent: load before joining
    check(init_distributed(f"127.0.0.1:{port}", 2, rank, device=device,
                           backend="gloo") == 2,
          "the gloo group is not two ranks")
    try:
        mesh = make_mesh(2)
        sh = ShardedFaceCascade(mesh, fc)
        sh.window_sharded_hits(hdf[0], *hd.shape, **HD)  # plans, uploads
        sh.batch_hits(batch, *gray.shape, **HEADLINE)
        dist.barrier()
        reset_kernel_counts()
        window = [sh.window_sharded_hits(f, *hd.shape, **HD) for f in hdf]
        window_launches = face_counts()
        reset_kernel_counts()
        dets, total = sh.batch_hits(batch, *gray.shape, **HEADLINE)
        batch_launches = face_counts()
        win_ms = [_call_ms(lambda: sh.window_sharded_hits(
            hdf[0], *hd.shape, **HD)) for _ in range(SHARDED_REPS)]
        batch_ms = [_call_ms(lambda: sh.batch_hits(
            batch, *gray.shape, **HEADLINE)) for _ in range(SHARDED_REPS)]
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("RESULT " + json.dumps({
        "rank": mesh.rank, "backend": mesh.backend, "device": str(fc.device),
        "window": [w.tolist() for w in window],
        "batch": [d.tolist() for d in dets], "total": total,
        "window_launches": window_launches, "batch_launches": batch_launches,
        "window_ms": win_ms, "batch_ms": batch_ms}), flush=True)
    return 0


def _run_gloo_ranks(device: str) -> list:
    """Start the two gloo ranks of (b) and return their RESULT dicts.
    Retries with a fresh port when a rank could not bind it (the probe
    socket closes before the ranks bind); kills both ranks on any exit."""
    for attempt in range(3):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-worker",
             str(rank), str(port), device], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in range(2)]
        try:
            results = [p.communicate(timeout=600) + (p.returncode,)
                       for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if all(rc == 0 for _, _, rc in results):
            break
        bind_race = any("address" in err.lower() for _, err, rc in results
                        if rc != 0)
        if not bind_race or attempt == 2:
            out, err, rc = next(r for r in results if r[2] != 0)
            raise SmokeFailure(f"a gloo rank exited {rc}:\n{out[-2000:]}\n"
                               f"{err[-4000:]}")
    outs = []
    for out, _, _ in results:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(len(lines) == 1, f"a gloo rank printed no result:\n{out}")
        outs.append(json.loads(lines[0][len("RESULT "):]))
    return outs


def _band_launches(sh, frame, cfg, n) -> tuple:
    """The (face_cascade, face_prefix, face_finish) launches of every band
    of an n-rank mesh over one frame, from band_cut (n = 1: the routing's
    own launches)."""
    from pigo_tpu_torch.parallel.sharded import band_cut

    routed = sh._window_plan(*frame.shape, cfg)[0]
    bands = [band_cut(routed, r, n) for r in range(n)]
    return (sum(not s.prefix for b in bands for s in b.segments),
            sum(s.prefix for b in bands for s in b.segments),
            sum(b.finish is not None for b in bands))


def phase_sharded(gray, hd, card) -> dict:
    """Multi-GPU detection (pigo_tpu_torch.parallel) on the one card (see
    the module docstring, phase 10): (a) every band of 2- and 4-rank
    meshes in this process, (b) two gloo ranks on the card, (c) a one-rank
    NCCL group, which is the phase's counted run, and the timings."""
    import torch.distributed as dist

    from pigo_tpu_torch import FaceCascade
    from pigo_tpu_torch.parallel import (ShardedFaceCascade,
                                         init_distributed, make_mesh)

    hdf, batch = _sharded_frames(gray, hd)
    out = {"card": card}

    # (a) every band in this process, against single-card sparse_hits
    bands = []
    for shape, frame, cfg in (("headline", gray, HEADLINE),
                              ("hd1080", hd, HD)):
        for mode, kw in (("default", {}), ("prefix", {"prefix": True})):
            fc = FaceCascade(**kw)
            sh = ShardedFaceCascade(make_mesh(1), fc)
            tiny = ShardedFaceCascade(make_mesh(1), fc, hit_capacity=1)
            for angle in (0.0, ROT_ANGLE):
                want = fc.sparse_hits(frame, *frame.shape, angle=angle, **cfg)
                for n in SHARDED_NS:
                    expected = _band_launches(sh, frame, cfg, n)
                    reset_kernel_counts()
                    got = sh.window_bands_hits(frame, *frame.shape, n,
                                               angle=angle, **cfg)
                    counts = face_counts()
                    check(np.array_equal(got, want),
                          f"{shape} {mode} {angle}: {n} bands != sparse_hits")
                    check(counts == expected, f"{shape} {mode} {angle}: {n} "
                          f"bands launched {counts}, expected {expected}")
                    check(np.array_equal(tiny.window_bands_hits(
                        frame, *frame.shape, n, angle=angle, **cfg), want),
                        f"{shape} {mode} {angle}: {n} bands at capacity 1 "
                        "!= sparse_hits")
                    case = dict(shape=shape, mode=mode, angle=angle, n=n,
                                hits=int(want.shape[0]), launches=counts,
                                equal_single_card=True,
                                equal_at_capacity_1=True)
                    bands.append(case)
                    emit("sharded_bands", **case)
    out["bands"] = bands

    # (b) two gloo ranks on the card, each its own process
    single = FaceCascade()
    want_hd = [single.sparse_hits(f, *hd.shape, **HD) for f in hdf]
    want_batch = [single.sparse_hits(f, *gray.shape, **HEADLINE)
                  for f in batch]
    want_total = sum(w.shape[0] for w in want_batch)
    t0 = time.perf_counter()
    ranks = _run_gloo_ranks(SHARDED_DEVICE)
    gloo_s = time.perf_counter() - t0
    for r in ranks:
        check(r["backend"] == "gloo" and r["device"] == SHARDED_DEVICE,
              f"rank {r['rank']} ran {r['backend']} on {r['device']}")
        check(all(np.array_equal(np.asarray(g, np.float64).reshape(-1, 4), w)
                  for g, w in zip(r["window"], want_hd))
              and len(r["window"]) == len(hdf),
              f"gloo rank {r['rank']}: window_sharded_hits != sparse_hits")
        check(all(np.array_equal(np.asarray(g, np.float64).reshape(-1, 4), w)
                  for g, w in zip(r["batch"], want_batch))
              and len(r["batch"]) == len(batch),
              f"gloo rank {r['rank']}: batch_hits != sparse_hits")
        check(r["total"] == want_total,
              f"gloo rank {r['rank']}: total {r['total']} != {want_total}")
        check(tuple(r["window_launches"]) == (len(hdf), 0, 0)
              and tuple(r["batch_launches"]) == (1, 0, 0),
              f"gloo rank {r['rank']}: launches {r['window_launches']} "
              f"{r['batch_launches']}, expected one face_cascade a frame "
              "and one a batch")
    out["gloo"] = {f"rank{r['rank']}": dict(
        window_hd1080=_ms_stats(r["window_ms"]),
        batch_headline=_ms_stats(r["batch_ms"]),
        window_launches=r["window_launches"],
        batch_launches=r["batch_launches"]) for r in ranks}
    out["gloo"]["seconds"] = gloo_s
    emit("sharded_gloo", equal_single_card=True, hd_frames=len(hdf),
         batch=len(batch), total=want_total, **out["gloo"], card=card)

    # (c) a one-rank NCCL group: the counted run and the timings
    check(init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                           device=SHARDED_DEVICE) == 1,
          "the NCCL group is not one rank")
    try:
        mesh = make_mesh(1)
        check(mesh.backend == "nccl" and mesh.group is not None,
              f"the mesh runs {mesh.backend}, not NCCL")
        shs = {mode: ShardedFaceCascade(mesh, FaceCascade(**kw))
               for mode, kw in (("default", {}), ("prefix",
                                                  {"prefix": True}))}
        launches, expected = {}, {}
        for mode, sh in shs.items():
            # one launch set a window-sharded frame and one a batch (the
            # batch routes as the face does: at tree cap 0, like the bands)
            per_frame = _band_launches(sh, hd, HD, 1)
            per_batch = _band_launches(sh, gray, HEADLINE, 1)
            expected[mode] = tuple(len(hdf) * f + b
                                   for f, b in zip(per_frame, per_batch))
            sh.window_sharded_hits(hdf[0], *hd.shape, **HD)  # plans
            sh.batch_hits(batch, *gray.shape, **HEADLINE)
            reset_kernel_counts()
            window = [sh.window_sharded_hits(f, *hd.shape, **HD)
                      for f in hdf]
            dets, total = sh.batch_hits(batch, *gray.shape, **HEADLINE)
            launches[mode] = face_counts()
            check(all(np.array_equal(g, w) for g, w in zip(window, want_hd)),
                  f"NCCL {mode}: window_sharded_hits != sparse_hits")
            check(all(np.array_equal(g, w) for g, w in zip(dets, want_batch))
                  and total == want_total,
                  f"NCCL {mode}: batch_hits != sparse_hits")
        check(launches == expected,
              f"NCCL launches {launches}, expected {expected}")
        sh = shs["default"]
        pairs = {"window_hd1080": (
            lambda: sh.window_sharded_hits(hdf[0], *hd.shape, **HD),
            lambda: single.sparse_hits(hdf[0], *hd.shape, **HD)),
            "batch_headline": (
            lambda: sh.batch_hits(batch, *gray.shape, **HEADLINE),
            lambda: single.sparse_hits_batch(batch, **HEADLINE))}
        timing = {}
        for name, (sharded, plain) in pairs.items():
            ms = {"sharded": [], "single_card": []}
            for _ in range(SHARDED_REPS):  # in turns
                ms["sharded"].append(_call_ms(sharded))
                ms["single_card"].append(_call_ms(plain))
            timing[name] = {k: _ms_stats(v) for k, v in ms.items()}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    out.update(nccl_launches=launches, timing=timing)
    emit("sharded_nccl", equal_single_card=True, launches=launches,
         hd_frames=len(hdf), batch=len(batch), card=card)
    emit("sharded_time", **timing, what="host ms a call: window_sharded_hits"
         " of one 1080p frame against sparse_hits, batch_hits of "
         f"{len(batch)} headline frames against sparse_hits_batch, one-rank "
         "NCCL group, in turns", card=card)
    return out


def _spread(n: int, parts: int) -> list:
    """n requests over `parts` callers, as even as they go."""
    return [n // parts + (t < n % parts) for t in range(parts)]


def _window_stats(windows) -> dict:
    """Requests/s of each timed window (a list of request seconds and the
    window's seconds) in run order, their median and spread, and the
    latency of every request of every window."""
    from pigo_tpu_torch.web.bench_client import latency_ms

    rates = [len(s) / total for s, total in windows]
    ranked = sorted(rates)
    return dict(requests_per_s=ranked[len(ranked) // 2],
                requests_per_s_min=ranked[0], requests_per_s_max=ranked[-1],
                requests_per_s_windows=rates,
                **latency_ms([x for s, _ in windows for x in s]),
                median_ms_windows=[latency_ms(s)["median_ms"]
                                   for s, _ in windows],
                requests_per_window=len(windows[0][0]), windows=len(windows),
                seconds=[total for _, total in windows])


def serve_client(url: str, frames: int, concurrency: int, windows: int) -> int:
    """The HTTP load of the serve phase, in a process of its own so that
    it shares no interpreter lock with the server: `chip_smoke.py
    --serve-client URL FRAMES CONCURRENCY WINDOWS`, the payload on
    standard input. Runs bench_client.run `windows` times and prints one
    `RESULT` JSON line: each window's bodies, request seconds and
    seconds. Loads bench_client by path (the standard library only)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_client", os.path.join(
        ROOT, "pigo_tpu_torch", "web", "bench_client.py"))
    bench_client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_client)
    payload = sys.stdin.buffer.read()
    out = []
    for _ in range(windows):
        bodies, seconds, total = bench_client.run(url, payload, frames,
                                                  concurrency)
        out.append({"bodies": [b.decode() for b in bodies],
                    "seconds": seconds, "total": total})
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def phase_serve(hd, card) -> dict:
    """The serving surface (pigo_tpu_torch.web) on the card (see the module
    docstring, phase 11): the stream engine, then the HTTP server."""
    import threading

    from pigo_tpu_torch import FaceDetector
    from pigo_tpu_torch.detector import CascadeParams
    from pigo_tpu_torch.web import bench_client, engines
    from pigo_tpu_torch.web import main as web_main

    try:
        import PIL.Image
    except ImportError as exc:
        raise SmokeFailure("phase serve needs Pillow (the server decodes "
                           "with it)") from exc

    rows, cols = SERVE_SHAPE
    gray = np.ascontiguousarray(hd[:rows, :cols])
    frames = {"on": np.repeat(gray[:, :, None], 3, axis=2),
              "off": np.repeat(hd[:, :, None], 3, axis=2)}
    check(np.array_equal(engines.bgr_to_gray(frames["on"]), gray.ravel()),
          "the BGR frame's gray is not the frame")
    params = CascadeParams(SERVE_CFG["min_size"], SERVE_CFG["max_size"],
                           SERVE_CFG["shift"], SERVE_CFG["scale"])
    iou = SERVE_CFG["iou"]
    timed_n = SERVE_WINDOWS * SERVE_REQUESTS

    # ---- the references: detect(frame, seed + i) on the card for every
    # index a run can give the frame. The engine's indices: 0 on, 1 off,
    # the timed windows (on), then the mixed run (either frame); the
    # server's: one warm-up, then the timed windows (on)
    engine_n = 2 + timed_n + SERVE_MIXED
    http_n = 1 + timed_n * len(SERVE_HTTP)
    mixed = range(engine_n - SERVE_MIXED, engine_n)
    need = {"on": range(max(engine_n, http_n)), "off": [1, *mixed]}
    det = FaceDetector()

    def reference(d, kind, i):
        h, w = frames[kind].shape[:2]
        return engines.result_dicts(d.detect(
            engines.bgr_to_gray(frames[kind]), h, w, params,
            iou_threshold=iou, generator=frame_generator(i)))

    refs = {kind: [None] * (max(idx) + 1) for kind, idx in need.items()}
    for kind, idx in need.items():
        for i in idx:
            refs[kind][i] = reference(det, kind, i)
    faces = {k: (len(refs[k][idx[0]]),
                 sum(bool(r["eyes"]) for r in refs[k][idx[0]]))
             for k, idx in need.items()}
    check(faces["on"][1] >= 1 and faces["off"][1] >= 1,
          f"the serving frames hold no eyed face: {faces}")
    # the card's references against the plain versions on the CPU, bit for
    # bit: kernel A on this pyramid and the walks at these frames' faces
    # (and so, through the engine's answers, the cluster kernel on these
    # frames' hit lists)
    det_cpu = FaceDetector(device="cpu")
    cpu_checked = {kind: list(idx)[:SERVE_CPU_SEEDS]
                   for kind, idx in need.items()}
    for kind, idx in cpu_checked.items():
        for i in idx:
            check(reference(det_cpu, kind, i) == refs[kind][i],
                  f"serve: detect of the {kind} frame with seed {i} on the "
                  "card != on the CPU")

    def answers_ok(answers, lo, hi) -> bool:
        """(kind, results, ...) answers against refs[kind][lo:hi], each
        index once."""
        return len(answers) == hi - lo and bench_client.match_once(
            answers, {k: v[lo:hi] for k, v in refs.items()})

    # ---- the counted run: (a) the engine, then (b) the server
    reset_kernel_counts()
    ladder = collections.Counter()  # the engines' detectors' ladders
    out = {"card": card, "frames": {k: list(f.shape[:2])
                                    for k, f in frames.items()},
           "faces_eyed": faces, "cpu_checked_seeds": cpu_checked,
           "engine": {}, "http": {}}
    requests = stream_requests = 0
    for threads in SERVE_THREADS:
        engine = engines.CudaStreamEngine(seed=SEED, depth=SERVE_DEPTH,
                                          **SERVE_CFG)
        try:
            # indices 0, 1: the first plans and uploads, on- and off-stream
            warm, _ = bench_client.run_engine(
                engine, [[("on", frames["on"]), ("off", frames["off"])]],
                **SERVE_CFG)
            check(answers_ok(warm, 0, 2)
                  and [a[0] for a in warm] == ["on", "off"],
                  f"{threads} callers: the first requests != detect")
            windows = []
            with sync_free_dispatch(engine.det):
                for w in range(SERVE_WINDOWS):
                    timed, total = bench_client.run_engine(engine, [
                        [("on", frames["on"])] * n
                        for n in _spread(SERVE_REQUESTS, threads)],
                        **SERVE_CFG)
                    lo = 2 + w * SERVE_REQUESTS
                    check(answers_ok(timed, lo, lo + SERVE_REQUESTS),
                          f"{threads} callers, window {w}: the answers != "
                          "detect(frame, seed + i)")
                    windows.append(([a[2] for a in timed], total))
                mixed_plans = [[] for _ in range(threads)]
                for k in range(SERVE_MIXED):
                    kind = "off" if k % 2 else "on"
                    mixed_plans[k % threads].append((kind, frames[kind]))
                got, _ = bench_client.run_engine(engine, mixed_plans,
                                                 **SERVE_CFG)
                check(answers_ok(got, mixed.start, engine_n),
                      f"{threads} callers: the mixed run != detect(frame, "
                      "seed + i)")
        finally:
            engine.close()
        ladder.update(engine.det.ladder)
        requests += engine_n
        stream_requests += engine_n - 1 - SERVE_MIXED // 2
        out["engine"][f"callers_{threads}"] = dict(
            **_window_stats(windows), depth=SERVE_DEPTH,
            mixed_requests=SERVE_MIXED, equal_detect=True)

    # (b) the server in this process; the PNG frames POSTed through
    # bench_client.run by a process of its own (serve_client)
    buf = io.BytesIO()
    PIL.Image.fromarray(frames["on"][:, :, ::-1]).save(buf, format="PNG")
    payload = buf.getvalue()
    args = web_main.build_parser().parse_args(["--depth", str(SERVE_DEPTH)])
    check(args.engine == "cuda-stream" and args.device is None,
          f"the server's defaults are {args.engine} on {args.device}")
    srv, engine = web_main.make_server(args, ("127.0.0.1", 0))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    want_json = [json.dumps(web_main.results_to_json(r), sort_keys=True)
                 for r in refs["on"]]

    def bodies_ok(bodies, lo) -> bool:
        got = sorted(json.dumps(json.loads(b), sort_keys=True)
                     for b in bodies)
        return got == sorted(want_json[lo:lo + len(bodies)])

    try:
        check(engine.seed == SEED, f"the server's engine seed {engine.seed}")
        first = bench_client.post(base + "/detect", payload)
        check(bodies_ok([first], 0), "HTTP: the first body != detect")
        lo = 1
        with sync_free_dispatch(engine.det):
            for conc in SERVE_HTTP:
                client = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--serve-client", base + "/detect",
                     str(SERVE_REQUESTS), str(conc), str(SERVE_WINDOWS)],
                    input=payload, capture_output=True, timeout=600,
                    cwd=ROOT)
                lines = [ln for ln in client.stdout.decode().splitlines()
                         if ln.startswith("RESULT ")]
                check(client.returncode == 0 and len(lines) == 1,
                      f"HTTP client at concurrency {conc} failed: "
                      f"{client.stderr.decode()[-2000:]}")
                windows = []
                for w in json.loads(lines[0][len("RESULT "):]):
                    check(len(w["bodies"]) == SERVE_REQUESTS
                          and bodies_ok(w["bodies"], lo),
                          f"HTTP at concurrency {conc}: the bodies != "
                          "results_to_json(detect(frame, seed + i))")
                    lo += SERVE_REQUESTS
                    windows.append((w["seconds"], w["total"]))
                out["http"][f"concurrency_{conc}"] = dict(
                    **_window_stats(windows), client="its own process",
                    equal_detect=True)
        with urllib.request.urlopen(base + "/stats", timeout=60) as resp:
            stats = json.load(resp)
        check(stats["stages"]["detect"]["calls"] == http_n
              and "fps" in stats, f"HTTP: /stats reads {stats}")
        with urllib.request.urlopen(base + "/", timeout=60) as resp:
            check(resp.read().decode() == web_main.PAGE, "HTTP: / != PAGE")
        with urllib.request.urlopen(base + "/cascade/facefinder",
                                    timeout=60) as resp:
            body = resp.read()
        with open(os.path.join(ROOT, "assets", "cascade", "facefinder"),
                  "rb") as fh:
            check(body == fh.read(), "HTTP: /cascade/facefinder differs")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        thread.join(60)
    ladder.update(engine.det.ladder)
    requests += http_n
    stream_requests += http_n
    launches = kernel_counts()
    ladder = {k: ladder[k] for k in LADDER}

    up = ladder["face_slot_escalations"] + ladder["hit_cap_escalations"]
    check(ladder["detect_fallbacks"] == 0,
          f"serve: {ladder['detect_fallbacks']} frames handed to detect")
    check(ladder["device_frame_waits"] == stream_requests + up,
          f"serve: {ladder['device_frame_waits']} host waits for "
          f"{stream_requests} streamed requests and {up} escalations")
    want = {"face_cascade": requests + up, "face_prefix": 0,
            "face_finish": 0, "pupil_walk": 2 * (requests + up),
            "cluster_device": stream_requests + up}
    check(launches == want, f"serve: launches {launches}, expected {want}")
    out.update(launches=launches, ladder=ladder, requests=requests,
               stream_requests=stream_requests,
               launches_per_request={
                   **{k: launches[k] / requests for k in (
                       "face_cascade", "pupil_walk", "cluster_device")},
                   "all_kernels": sum(launches.values()) / requests})
    emit("serve", **{k: v for k, v in out.items()
                     if k not in ("engine", "http")})

    # ---- detect_stream_device on the same frames, the reference point
    # (at the engine's depth, and at depth 1: each frame collected before
    # the next is dispatched, a lone caller's case), and the host steps a
    # request adds before the worker takes it
    sdet = FaceDetector()
    out["detect_stream_device"] = {}
    for depth in (SERVE_DEPTH, 1):
        ms = []
        for _ in range(SERVE_WINDOWS):
            t0 = time.perf_counter()
            got = list(sdet.detect_stream_device(
                [gray] * SERVE_REQUESTS, params, iou_threshold=iou,
                seed=SEED, depth=depth))
            ms.append((time.perf_counter() - t0) / SERVE_REQUESTS * 1e3)
            check(len(got) == SERVE_REQUESTS,
                  "detect_stream_device lost frames")
        out["detect_stream_device"][f"depth_{depth}"] = dict(
            ms_per_frame_windows=ms, ms_per_frame_best=min(ms),
            ms_per_frame_median=sorted(ms)[len(ms) // 2],
            frames=SERVE_REQUESTS)
    from pigo_tpu_torch.io.image import decode_image

    steps = {"bgr_to_gray": lambda: engines.bgr_to_gray(frames["on"]),
             "png_decode": lambda: decode_image(payload)[:, :, 2::-1]}
    out["host_steps"] = {name: _ms_stats([_call_ms(fn) for _ in range(20)])
                         for name, fn in steps.items()}
    emit("serve_time", engine=out["engine"], http=out["http"],
         detect_stream_device=out["detect_stream_device"],
         host_steps=out["host_steps"],
         what="requests/s over each timed window's wall time (median, "
              "min, max and each window in run order); latency of each "
              "request on its caller's clock over all windows; engine "
              "callers are threads of this process, the HTTP client a "
              "process of its own; detect_stream_device ms a frame over "
              "the same frame, one caller, at the engine's depth and at "
              "1; host ms of a caller's gray conversion and of the "
              "server's PNG decode", card=card)
    return out


def phase_demos(hd, card) -> dict:
    """The seven demos (pigo_tpu_torch.demos) through their main on the
    card (see the module docstring, phase 12)."""
    import importlib

    try:
        import cv2
    except ImportError as exc:
        raise SmokeFailure("phase demos needs OpenCV (the demos draw with "
                           "it)") from exc
    from pigo_tpu_torch import FaceDetector
    from pigo_tpu_torch.demos.common import KeepSink
    from pigo_tpu_torch.detector import MIN_EYE_FACE_SCALE, CascadeParams
    from pigo_tpu_torch.web import engines

    rows, cols = SERVE_SHAPE
    top = np.ascontiguousarray(hd[:rows, :cols])
    grays = [np.ascontiguousarray(np.roll(top, k, axis=1))
             for k in range(DEMO_FRAMES)]
    frames = [np.repeat(g[:, :, None], 3, axis=2) for g in grays]
    check(all(np.array_equal(engines.bgr_to_gray(f), g.ravel())
              for f, g in zip(frames, grays)),
          "demos: a BGR frame's gray is not the frame")
    params = CascadeParams(SERVE_CFG["min_size"], SERVE_CFG["max_size"],
                           SERVE_CFG["shift"], SERVE_CFG["scale"])

    def detect(det, i):
        return engines.result_dicts(det.detect(
            grays[i], rows, cols, params, iou_threshold=SERVE_CFG["iou"],
            generator=frame_generator(i)))

    # ---- the references: detect(frame_i, seed i) on the card for each
    # pipeline; the full pipeline's first frames against the CPU's
    refs = {}
    for pipe in sorted(set(DEMOS.values())):
        det = FaceDetector(with_pupils=pipe[0], with_landmarks=pipe[1])
        refs[pipe] = [detect(det, i) for i in range(DEMO_FRAMES)]
    full = refs[True, True]
    eyed = sum(any(r["face"][2] > MIN_EYE_FACE_SCALE for r in res)
               for res in full)
    check(eyed == DEMO_FRAMES and all(
        any(len(r["landmarks"]) == 15 for r in res) for res in full),
        "demos: a frame with no face with eyes and 15 points")
    det_cpu = FaceDetector(device="cpu")
    for i in range(DEMO_CPU_FRAMES):
        check(detect(det_cpu, i) == full[i],
              f"demos: detect of frame {i} on the card != on the CPU")

    def drawn_on(name, res) -> bool:
        """Whether the demo draws on a frame with these results."""
        if name == "masquerade":
            return any(len(r["eyes"]) >= 2 for r in res)
        return bool(res)

    out = {"card": card, "shape": [rows, cols], "frames": DEMO_FRAMES,
           "passes": DEMO_PASSES, "opencv": cv2.__version__,
           "faces": [len(res) for res in full], "eyed_frames": eyed,
           "cpu_checked_frames": DEMO_CPU_FRAMES, "demos": {}}
    totals = {"face_cascade": 0, "pupil_walk": 0}
    for name, pipe in DEMOS.items():
        demo = importlib.import_module(f"pigo_tpu_torch.demos.{name}")
        want = {"face_cascade": DEMO_FRAMES, "face_prefix": 0,
                "face_finish": 0, "pupil_walk": eyed * sum(pipe),
                "cluster_device": 0}
        passes = []
        for p in range(DEMO_PASSES):
            sink = KeepSink()
            reset_kernel_counts()
            stats = demo.main(["--engine", "cuda"],
                              source=[f.copy() for f in frames], sink=sink)
            launches = kernel_counts()
            check(stats["frames"] == DEMO_FRAMES
                  and sink.results == refs[pipe],
                  f"demos: {name}, pass {p}: the results != "
                  "detect(frame_i, seed i)")
            check(launches == want, f"demos: {name}, pass {p}: launches "
                                    f"{launches}, expected {want}")
            drawn = [not np.array_equal(a, b)
                     for a, b in zip(sink.frames, frames)]
            check(all(d for d, res in zip(drawn, sink.results)
                      if drawn_on(name, res)),
                  f"demos: {name}, pass {p}: a frame with a face was not "
                  "drawn on")
            totals["face_cascade"] += launches["face_cascade"]
            totals["pupil_walk"] += launches["pupil_walk"]
            passes.append(dict(
                fps=stats["frames"] / stats["seconds"],
                engine_ms=stats["engine_seconds"] / stats["frames"] * 1e3,
                per_frame_ms=stats["per_frame_seconds"] / stats["frames"]
                * 1e3, drawn=sum(drawn)))
        med = {k: sorted(ps[k] for ps in passes)[len(passes) // 2]
               for k in ("fps", "engine_ms", "per_frame_ms")}
        out["demos"][name] = dict(
            launches_per_pass={k: v for k, v in want.items() if v},
            fps_median=med["fps"], engine_ms_per_frame_median=med["engine_ms"],
            per_frame_ms_per_frame_median=med["per_frame_ms"],
            drawn=passes[0]["drawn"], passes=passes, equal_detect=True)
    out["launches"] = totals

    # ---- where an engine's frame goes: a new cuda engine (the full
    # pipeline) over the frames, its first call apart, then its two steps
    # over the same frames: the gray conversion and the warm detector's
    # detect
    engine = engines.make_engine("cuda", with_pupils=True,
                                 with_landmarks=True)
    calls = [_call_ms(lambda: engine.detect(f, **SERVE_CFG))
             for f in frames]
    steps = {"bgr_to_gray": [_call_ms(lambda: engines.bgr_to_gray(f))
                             for f in frames],
             "detect": [_call_ms(lambda: detect(engine.det, i))
                        for i in range(DEMO_FRAMES)]}
    out["engine_steps"] = {"first_call_ms": calls[0],
                           "later_calls": _ms_stats(calls[1:]),
                           **{k: _ms_stats(v) for k, v in steps.items()}}
    emit("demos", **out, what="each demo's main over the frames, "
         "--engine cuda at the demos' defaults, seed 0; frames a second "
         "over fps_loop's wall time, and ms a frame of the engine's calls "
         "and of per_frame's drawing, medians of the passes; every pass's "
         "results equal to detect(frame_i, seed i) and its launches "
         "checked; engine_steps: host ms of a new full-pipeline cuda "
         "engine's calls (the first apart) and of its gray conversion and "
         "its warm detector's detect over the same frames")
    return out


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
    gray, hd = _load_frames()
    check(gray.shape == (400, 320) and gray.dtype == np.uint8,
          "sample_gray.npy is not the 400x320 uint8 sample frame")
    with open(os.path.join(ROOT, "tests", "golden", "sample_dense.json")) as fh:
        golden = json.load(fh)
    with open(os.path.join(ROOT, "tests", "golden",
                           GOLDEN_TAG + ".json")) as fh:
        det_golden = json.load(fh)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    forest = FaceCascade().tensors
    kstats = timed("kernel", phase_kernel, gray, hd, forest, card)
    det = FaceDetector()
    pstats = timed("pupil_kernel", phase_pupil_kernel, (
        ("sample", gray, _cfg(det_golden)), ("hd1080", hd, DET_HD)), det,
        card)
    main = timed("main_path", phase_main_path, gray, hd, {
        "sample_dense": golden, GOLDEN_TAG: det_golden}, card)
    dmain = timed("detector", phase_detector, gray, hd, det_golden, det,
                  card)
    cstats = timed("cluster_kernel", phase_cluster_kernel, gray, hd,
                   det_golden, det, card)
    ddev = timed("device_detector", phase_device_detector, gray, hd,
                 det_golden, det, dmain["per_frame_detect"], card)
    timed("host_tail", phase_host_tail, gray, hd, {
        "sample_dense": golden, GOLDEN_TAG: det_golden}, card)
    timed("native_cluster", phase_native_cluster, gray, hd, det_golden, det,
          card)
    timed("device_host_tail", phase_device_host_tail, gray, hd, det_golden,
          det, dmain["per_frame_detect"], card)
    timed("cli", phase_cli, gray, det, card)
    shard = timed("sharded", phase_sharded, gray, hd, card)
    serve = timed("serve", phase_serve, hd, card)
    demos = timed("demos", phase_demos, hd, card)
    emit("phase_seconds", **seconds)
    check("jax" not in sys.modules and "pigo_tpu" not in sys.modules,
          "the port pulled in jax or pigo_tpu")

    shapes = kstats["shapes"]
    # the sharded phase's counted run (one-rank NCCL group, both modes)
    sharded_launches = [sum(c[i] for c in shard["nccl_launches"].values())
                        for i in range(3)]
    head = shapes["headline"]
    post = [pstats["shapes"]["sample"][k] for k in ("eyes", "landmarks")]
    TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by")

    def pick(d, keys=TIME_KEYS):
        return {k: d[k] for k in keys}

    kernels = [{
        "name": "face_cascade",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/face_cascade.cu",
        "replaces": "pigo_tpu/ops/face_pallas.py:635",
        "launches": main["launches"]["face_cascade"],
        "sharded_launches": sharded_launches[0],
        "serve_launches": serve["launches"]["face_cascade"],
        "demos_launches": demos["launches"]["face_cascade"],
        "max_abs_err": kstats["max_abs_err"]["face_cascade"],
        **pick(head),
        "library_ms": None,
        "check": "bitwise equal to ops/face_dense.classify_windows "
                 "(upright at T and 32 trees, rotated at T; the facefinder "
                 "at 36 and 100 trees, a never-failing forest and a random "
                 "80-tree forest, upright and rotated)",
        "schedule": kstats["schedule"]["face_cascade"],
        "survivors_only_ms": head["survivors_only_ms"],
        "all_survive_ms": head["all_survive_ms"],
        "worklist": head["worklist"],
        "hd1080": pick(shapes["hd1080"],
                       TIME_KEYS + ("survivors_only_ms", "all_survive_ms")),
        "rotated": {k: pick(v["rotated"]) for k, v in shapes.items()},
    }, {
        "name": "face_prefix",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/face_prefix.cu",
        "replaces": "pigo_tpu/ops/face_pallas.py:863",
        "launches": main["launches"]["face_prefix"],
        "sharded_launches": sharded_launches[1],
        "max_abs_err": kstats["max_abs_err"]["face_prefix"],
        **pick(head["prefix"]["upright"]),
        "library_ms": None,
        "check": "bitwise equal to ops/face_dense.classify_windows at "
                 "t_limit 32 over the tail scales (upright and rotated), "
                 "and at 1, 32, 33 and 64 trees on a never-failing and a "
                 "random forest and at 1 and 23 on a random depth-8 one",
        "ms_is": "the headline's 22 tail scales, upright",
        "schedule": kstats["schedule"]["face_prefix"],
        "survivors": head["prefix"]["upright"]["survivors"],
        "all_survive_ms": head["prefix"]["all_survive_ms"],
        "worklist_max": {k: v["worklist"]["prefix_max"]
                         for k, v in shapes.items()},
        "per_shape": {k: {a: pick(v["prefix"][a], TIME_KEYS + ("survivors",))
                          for a in ("upright", "rotated")}
                      for k, v in shapes.items()},
    }, {
        "name": "face_finish",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/face_cascade.cu",
        "replaces": "pigo_tpu/models/face.py:313",
        "replaces_is": "_resolve_consts, the JAX package's exact finish of "
                       "marked windows (a jnp gather classifier; it has no "
                       "Pallas kernel)",
        "launches": main["launches"]["face_finish"],
        "sharded_launches": sharded_launches[2],
        "max_abs_err": kstats["max_abs_err"]["face_finish"],
        **pick(head["finish"]["upright"]),
        "library_ms": None,
        "check": "bitwise equal to ops/face_dense.finish_marked, and to "
                 "face_cascade at the full forest on every mark",
        "ms_is": "the marks of the headline's prefix pass, upright",
        "schedule": kstats["schedule"]["face_cascade"],
        "per_shape": {k: {a: pick(v["finish"][a], TIME_KEYS + ("marks",))
                          for a in ("upright", "rotated")}
                      for k, v in shapes.items()},
    }, {
        "name": "pupil_walk",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/pupil_walk.cu",
        "replaces": "pigo_tpu/ops/pupil_pallas.py:48",
        "launches": dmain["launches"]["pupil_walk"],
        "serve_launches": serve["launches"]["pupil_walk"],
        "demos_launches": demos["launches"]["pupil_walk"],
        "max_abs_err": pstats["max_abs_err"],
        "ms": sum(w["ms"] for w in post),
        "plain_ms": sum(w["plain_ms"] for w in post),
        "bound_ms": sum(w["bound_ms"] for w in post),
        "bound_by": ("bytes" if all(w["bound_by"] == "bytes" for w in post)
                     else "operations"),
        "library_ms": None,
        "check": "bitwise equal to ops/pupil_dense.walk on (r, c, s), and "
                 "on random forests of 1, 20 and 32 trees at depth 1 and "
                 "10, upright and rotated",
        "schedule": {"warps_per_block": pstats["warps_per_block"]},
        "ms_is": "the two launches of the sample frame's post stage "
                 "(eyes, then landmarks)",
        "per_walk": {
            frame: {kind: {k: v[k] for k in ("walkers", "ms", "plain_ms",
                                              "bound_ms", "bound_by")}
                    for kind, v in shape.items()
                    if kind not in ("faces", "post")}
            for frame, shape in pstats["shapes"].items()},
        "post_stage": {frame: shape["post"]
                       for frame, shape in pstats["shapes"].items()},
    }, {
        "name": "cluster_device",
        "route": "cuda",
        "source": "pigo_tpu_torch/csrc/cluster_device.cu",
        "replaces": "pigo_tpu/ops/cluster_device.py:30",
        "replaces_is": "cluster_device, the JAX package's on-device IoU "
                       "clustering (a jnp fori_loop; it has no Pallas "
                       "kernel)",
        "launches": ddev["launches"]["cluster_device"],
        "serve_launches": serve["launches"]["cluster_device"],
        "max_abs_err": cstats["max_abs_err"],
        **pick(cstats["cases"]["sample"]),
        "library_ms": None,
        "check": "bitwise equal to ops/cluster_device.cluster_plain and "
                 "to the host ops/cluster.cluster_detections, one launch a "
                 "call, on the real hit lists and the seeded sets of "
                 "tools/cluster_sets.py (random_sets at capacity 4096, and "
                 "8192 entries at 8192; edge_sets)",
        "ms_is": "the sample frame's hit list at capacity 4096",
        "per_shape": {k: pick(v, TIME_KEYS + ("entries", "seeds",
                                              "clusters"))
                      for k, v in cstats["cases"].items()},
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sys.exit(sharded_worker(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4]))
    if sys.argv[1:2] == ["--serve-client"]:
        sys.exit(serve_client(sys.argv[2], *map(int, sys.argv[3:6])))
    sys.exit(main())
