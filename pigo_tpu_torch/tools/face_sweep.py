"""Times builds of the port's kernel libraries against each other on one card.

    python -m pigo_tpu_torch.tools.face_sweep
        [--const kPhase1Trees=1,2,4,8 --const kWarpsPerBlock=4,8 ...]
        [--tree NAME=CSRC_DIR ...] [--out FILE]

Each variant is both kernel libraries, `face_cascade` (csrc/face_cascade.cu
with csrc/face_prefix.cu: kernels A and B and the finish) and `pupil_walk`
(csrc/pupil_walk.cu: kernel C), built from a csrc/ directory: this
checkout's with its `constexpr int` constants set to each combination of
the --const values, and each --tree directory as it is (for example the
csrc/ of a `git archive` of another commit). A --const names one constant
of any source or shared header (csrc/*.cu, csrc/*.cuh), which must define
it once: kernel A's `kPhase1Trees`, `kThreads` and `kDenseEighths`
(face_cascade.cu), kernel B's `kPrefixPhase1Trees`, `kPrefixWindows`,
`kPrefixThreads` and `kPrefixDenseEighths` (face_prefix.cu), the walk's
`kWarpsPerBlock` and `kEnsembleBlocks` (pupil_walk.cu). The variants are
built in parallel, then timed in turns on the same inputs (in variant
order, then in reverse order), each call first held bit for bit against
the plain version: a case that differs is reported and not timed, and the
run exits 1. The
inputs are the main path's: the facefinder forest over the sample frame's
400x320 headline pyramid and its 1080x1920 tiling (the pyramids of
chip_smoke.py), upright and at angle 0.07, and the detector's walks on
both. Cases:
  - cascade, cascade_rotated: face_cascade over every window, all trees;
  - survivors_only: face_cascade over the windows that survive all trees;
  - all_survive: face_cascade with thresholds that never fail (every
    window walks every tree; headline only);
  - finish, finish_rotated: face_finish of the tail scales' 32-tree marks
    (timed as copy + finish less the copy);
  - prefix, prefix_rotated: face_prefix over the tail scales (kernel B);
  - prefix_all_survive: face_prefix with thresholds that never fail;
  - eyes, landmarks: pupil_walk over the walkers FaceDetector makes for
    the faces of the sample frame (one face, at the golden sample's
    configuration) and of the 1080p tiling (15 faces);
  - post: the post stage of those faces, detector.fused_post's two
    launches of the walk's ensemble mode (jitter, walk, median vote and
    landmark anchors), against its plain route on the CPU; not timed for
    a library without that entry point.
Each variant also gives its schedules and the largest per-block worklist:
for the cascade, the windows of one block still alive after kPhase1Trees
trees; for the finish, the marks of one block; for the prefix kernel, the
tail windows of one block alive after kPrefixPhase1Trees trees. Prints one
JSON line per variant and a summary line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import glob
import itertools
import json
import os
import re
import shutil
import sys
import unittest.mock

import numpy as np
import torch

from pigo_tpu_torch.detector import (MIN_EYE_FACE_SCALE, Q_THRESH,
                                     CascadeParams, FaceDetector,
                                     eye_anchors, fused_post,
                                     landmark_anchors)
from pigo_tpu_torch.models.face import FaceCascade, angle_index
from pigo_tpu_torch.ops import face_cuda, face_dense, pupil_cuda, pupil_dense
from pigo_tpu_torch.ops.windows import build_window_plan
from pigo_tpu_torch.utils import build
from pigo_tpu_torch.utils.device import card_description, cuda_ms

HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)
HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
# FaceDetector's configurations: the golden sample's (tests/golden/
# sample.json) and the 1080p tiling's, both at IoU 0.1
DET_SAMPLE = dict(min_size=20, max_size=1000, shift_factor=0.2,
                  scale_factor=1.1)
DET_IOU = 0.1
ROT_ANGLE = 0.07
NEVER_FAIL = -1e4  # a threshold no facefinder running sum reaches
LIBRARIES = ("face_cascade", "pupil_walk")
SWEEP_DIR = os.path.join(build.BUILD_DIR, "sweep")


def variant_sources(name: str, consts: dict[str, int] | None, csrc: str,
                    libraries=LIBRARIES) -> dict[str, list[str]]:
    """Each of `libraries`' sources for one variant: csrc's own, or a copy
    under SWEEP_DIR with each `constexpr int NAME = ...;` in `consts` set to
    its value in the one source or header of the copy that defines it."""
    if consts is not None:
        out = os.path.join(SWEEP_DIR, name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        texts = {}
        for path in sorted(glob.glob(os.path.join(out, "*.cu*"))):
            with open(path) as fh:
                texts[path] = fh.read()
        for const, value in consts.items():
            pattern = rf"constexpr int {const} = \d+;"
            hits = [p for p, t in texts.items()
                    for _ in re.findall(pattern, t)]
            if len(hits) != 1:
                raise RuntimeError(f"{csrc}: expected one constant {const}, "
                                   f"found {len(hits)}")
            texts[hits[0]] = re.sub(pattern,
                                    f"constexpr int {const} = {value};",
                                    texts[hits[0]])
        for path, text in texts.items():
            with open(path, "w") as fh:
                fh.write(text)
        csrc = out
    return {lib: [os.path.join(csrc, f) for f in build.sources(lib)]
            for lib in libraries}


def build_variants(variants: dict[str, tuple[dict | None, str]]):
    """Compile every variant's libraries in parallel; -> {name: {"face":
    (CDLL, schedules), "walk": (CDLL, warps a block or None), "ptxas":
    {library: the compiler's register and spill lines}}}."""
    os.makedirs(SWEEP_DIR, exist_ok=True)
    sources = {name: variant_sources(name, consts, csrc)
               for name, (consts, csrc) in variants.items()}

    def one(job):
        name, lib = job
        so = os.path.join(SWEEP_DIR, f"lib{lib}-{name}.so")
        report = build.compile_library(sources[name][lib], so)
        return job, (so, [ln.strip() for ln in report.splitlines()
                          if "registers" in ln or "spill" in ln])

    jobs = [(name, lib) for name in variants for lib in LIBRARIES]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(one, jobs))
    libs = {}
    for name in variants:
        face = ctypes.CDLL(built[name, "face_cascade"][0])
        build.bind_library(face, face_cuda._bind)
        walk = ctypes.CDLL(built[name, "pupil_walk"][0])
        try:
            # binds the walk before the schedule
            build.bind_library(walk, pupil_cuda._bind)
            warps = pupil_cuda.schedule(walk)
        except AttributeError:  # a library from before pigo_pupil_schedule
            warps = None
        libs[name] = {"face": (face, face_cuda.schedule(face)),
                      "walk": (walk, warps),
                      "ptxas": {lib: built[name, lib][1]
                                for lib in LIBRARIES}}
    return libs


def worklist_max(alive: torch.Tensor, threads: int) -> int:
    """The largest count of True in a block of `threads` consecutive
    (frame, window) entries of alive bool [B, W] (frame-major): the
    longest phase-2 worklist of a face kernel's block, given the windows
    it queues."""
    flat = alive.reshape(-1).to(torch.int32)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % threads))
    return int(flat.reshape(-1, threads).sum(1).max())


def post_walks(det: FaceDetector, frame: np.ndarray, params: dict,
               rng: np.random.Generator, walk=None):
    """The two walks FaceDetector makes on a frame, from seeded uniforms:
    the eyes of every qualifying face, then the 15 landmark points anchored
    on the eyes' medians (which `walk`, the kernel wrapper by default,
    computes). -> (faces, pixels, {"eyes": (tensors, walker inputs),
    "landmarks": (tensors, walker inputs)}), each walker input the tuple
    (casc_id, r0, c0, s0, col_sign) of pupil_dense.walker_starts."""
    walk = walk or pupil_cuda.pupil_walk
    dev = det.device
    rows, cols = frame.shape
    pix = torch.from_numpy(np.ascontiguousarray(frame).reshape(-1)).to(dev)
    faces = [d for d in det.detect_faces(frame, rows, cols,
                                         CascadeParams(**params),
                                         iou_threshold=DET_IOU)
             if d.q > Q_THRESH and d.scale > MIN_EYE_FACE_SCALE]
    f = len(faces)
    pt, lt = det.pupil.tensors, det.landmarks.tensors
    eyes_in = walker_inputs(eye_anchors(faces), np.zeros(2 * f, np.int32),
                            np.zeros(2 * f, bool),
                            rng.random((2 * f, 63, 3), dtype=np.float32), dev)
    er, ec, es = walk(pt.codes, pt.preds, *eyes_in, pix, nrows=rows,
                      ncols=cols, dim=cols, scale_mult=pt.scale_mult)
    eyes = torch.stack(pupil_dense.median_vote(
        er.reshape(2 * f, 63), ec.reshape(2 * f, 63), es.reshape(2 * f, 63),
        63))
    arow, acol, ascale = landmark_anchors(eyes)
    cids, flips = det.landmarks.schedule_arrays(f)
    npts = len(det.landmarks.point_schedule)
    anchors = torch.stack([arow, acol, ascale], 1).repeat_interleave(
        npts, 0).cpu().numpy()
    lmk_in = walker_inputs(anchors, cids, flips,
                           rng.random((f * npts, 63, 3), dtype=np.float32),
                           dev)
    return faces, pix, {"eyes": (pt, eyes_in), "landmarks": (lt, lmk_in)}


def walker_inputs(anchors, casc_id, flips, u, dev):
    """Walker inputs (casc_id, r0, c0, s0, col_sign) [G*P] on dev for G
    groups of P perturbations, as the main path makes them: anchors
    [G, 3] (row, col, scale), casc_id [G], flips [G], u [G, P, 3]."""
    a = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    return pupil_dense.walker_starts(
        torch.as_tensor(casc_id, device=dev), a[:, 0], a[:, 1], a[:, 2],
        torch.as_tensor(flips, device=dev),
        torch.as_tensor(u, dtype=torch.float32, device=dev))


def cases(dev):
    """name -> (kernel call, its plain result, reps) on the real frames;
    and per shape the cascade's and the prefix kernel's arguments and the
    finish's marks."""
    forest = FaceCascade(device=dev).tensors
    tables = (forest.codes, forest.preds, forest.thresh)
    never = (forest.codes, forest.preds,
             torch.full_like(forest.thresh, NEVER_FAIL))
    t_num = forest.num_trees
    rot = angle_index(ROT_ANGLE)
    gray = np.load(os.path.join(build.PKG_DIR, "assets", "sample_gray.npy"))
    hd = np.tile(gray, (1080 // 400 + 1, 1920 // 320 + 1))[:1080, :1920]
    det, cpu_det = FaceDetector(device=dev), FaceDetector(device="cpu")
    rng = np.random.default_rng(0)
    out, inputs = {}, {}
    for shape, frame, cfg, det_cfg in (("headline", gray, HEADLINE,
                                        DET_SAMPLE),
                                       ("hd1080", hd, HD, HD)):
        plan = build_window_plan(*frame.shape, **cfg)
        base, scale = face_cuda.device_plan(plan, dev)
        one = torch.from_numpy(np.ascontiguousarray(frame))[None].to(dev)
        args = (one, base, scale, *tables, t_num)
        inputs[shape] = {"cascade": args}
        q = face_dense.classify_windows(*args)
        alive = torch.nonzero(q[0] > 0).flatten()
        sub = (one, base[alive].contiguous(), scale[alive].contiguous(),
               *tables, t_num)
        out[f"{shape}/cascade"] = (
            lambda a=args: face_cuda.face_cascade(*a), q, 50)
        out[f"{shape}/cascade_rotated"] = (
            lambda a=args: face_cuda.face_cascade(*a, angle_idx=rot),
            face_dense.classify_windows(*args, angle_idx=rot), 50)
        out[f"{shape}/survivors_only"] = (
            lambda a=sub: face_cuda.face_cascade(*a),
            face_dense.classify_windows(*sub), 50)
        if shape == "headline":
            a_never = (one, base, scale, *never, t_num)
            out[f"{shape}/all_survive"] = (
                lambda a=a_never: face_cuda.face_cascade(*a),
                face_dense.classify_windows(*a_never), 5)
        routed = face_cuda.route_plan(plan, t_num, prefix=True)
        [seg] = [sg for sg in routed.segments if sg.prefix]
        pb, ps = base[seg.lo:seg.hi], scale[seg.lo:seg.hi]
        bargs = (one, pb, ps, *tables, seg.t_limit)
        inputs[shape]["prefix"] = bargs
        for label, a, tabs in (("prefix", 0, tables),
                               ("prefix_rotated", rot, tables),
                               ("prefix_all_survive", 0, never)):
            b = (one, pb, ps, *tabs, seg.t_limit)
            out[f"{shape}/{label}"] = (
                lambda b=b, a=a: face_cuda.face_prefix(*b, angle_idx=a),
                face_dense.classify_windows(*b, angle_idx=a), 50)
        for label, a in (("finish", 0), ("finish_rotated", rot)):
            marks = face_dense.classify_windows(*bargs, angle_idx=a)
            inputs[shape][label] = marks
            work = marks.clone()
            out[f"{shape}/{label}"] = (
                lambda w=work, m=marks, a=a, o=one, pb=pb, ps=ps:
                face_cuda.face_finish(o, pb, ps, *tables, w.copy_(m),
                                      angle_idx=a),
                face_dense.finish_marked(one, pb, ps, *tables, marks.clone(),
                                         angle_idx=a), 50)
            out[f"{shape}/{label}_copy"] = (
                lambda w=work, m=marks: w.copy_(m), marks, 50)
        rows, cols = frame.shape
        faces, pix, walks = post_walks(det, frame, det_cfg, rng,
                                       walk=pupil_dense.walk)
        for kind, (t, walkers) in walks.items():
            w_args = (t.codes, t.preds, *walkers, pix)
            kw = dict(nrows=rows, ncols=cols, dim=cols,
                      scale_mult=t.scale_mult)
            out[f"{shape}/{kind}"] = (
                lambda a=w_args, kw=kw: torch.stack(
                    pupil_cuda.pupil_walk(*a, **kw)),
                torch.stack(pupil_dense.walk(*w_args, **kw)), 50)
        # the post stage: fused_post's two ensemble launches over the
        # faces, against its plain route on the CPU
        f = len(faces)
        cids, flips = det.landmarks.schedule_arrays(f)
        p_args = [*(torch.from_numpy(np.ascontiguousarray(v))
                    for v in eye_anchors(faces).T),
                  pix.cpu(), None, None,
                  *(torch.from_numpy(rng.random((k, 63, 3), dtype=np.float32))
                    for k in (2 * f, 15 * f)),
                  torch.from_numpy(cids), torch.from_numpy(flips)]
        kw = dict(rows=rows, cols=cols, dim=cols)
        want = fused_post(*p_args[:4], cpu_det.pupil.tensors,
                          cpu_det.landmarks.tensors, *p_args[6:], **kw)
        p_args = [None if a is None else a.to(dev) for a in p_args]
        p_args[4:6] = det.pupil.tensors, det.landmarks.tensors
        out[f"{shape}/post"] = (
            lambda a=p_args, kw=kw: fused_post(*a, **kw), want.to(dev), 50)
    return out, inputs


def worklists(inputs, sched) -> dict:
    """Per shape, the longest phase-2 worklist of each kernel's blocks."""
    a, b = sched["face_cascade"], sched["face_prefix"]
    out = {}
    for shape, given in inputs.items():
        one, base, scale, *tables, _ = given["cascade"]
        # the windows still alive after k trees: k < T, so marked
        qa = face_dense.classify_windows(one, base, scale, *tables,
                                         a.phase1_trees)
        bone, pb, ps, *btables, _ = given["prefix"]
        qb = face_dense.classify_windows(bone, pb, ps, *btables,
                                         b.phase1_trees)
        out[shape] = {
            "cascade": worklist_max(qa != -1.0, a.block_windows),
            "prefix": worklist_max(qb != -1.0, b.block_windows),
            **{label: worklist_max(given[label] == face_dense.PREFIX_MARK,
                                   a.block_windows)
               for label in ("finish", "finish_rotated")}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--const", action="append", default=[],
                    metavar="NAME=V1,V2,...")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=CSRC_DIR")
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("face_sweep: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    names = [c.partition("=")[0] for c in opts.const]
    values = [[int(v) for v in c.partition("=")[2].split(",")]
              for c in opts.const]
    variants = {
        "_".join(f"{n}{v}" for n, v in zip(names, combo)) or "checkout":
        (dict(zip(names, combo)), build.CSRC_DIR)
        for combo in itertools.product(*values)}
    for spec in opts.tree:
        name, _, path = spec.partition("=")
        variants[name] = (None, os.path.abspath(path))
    libs = build_variants(variants)
    work, inputs = cases(dev)
    card = card_description()
    times: dict[str, dict[str, list[float]]] = {n: {} for n in libs}
    wrong: dict[str, list[str]] = {n: [] for n in libs}
    order = list(libs)
    for turn in (order, order[::-1]):
        for name in turn:
            face, walk = libs[name]["face"][0], libs[name]["walk"][0]
            with unittest.mock.patch.object(
                    face_cuda, "load_kernel", lambda lib=face: lib), \
                    unittest.mock.patch.object(
                        pupil_cuda, "load_kernel", lambda lib=walk: lib):
                for case, (fn, want, reps) in work.items():
                    try:
                        got = fn()
                    except AttributeError:  # an entry the library lacks
                        continue
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        wrong[name].append(case)  # not timed
                        continue
                    times[name].setdefault(case, []).append(
                        cuda_ms(fn, reps, True))
    report = []
    for name, lib in libs.items():
        sched, warps = lib["face"][1], lib["walk"][1]
        ms = {case: sum(v) / len(v) for case, v in times[name].items()}
        for shape in ("headline", "hd1080"):
            for label in ("finish", "finish_rotated"):
                key = f"{shape}/{label}"
                copy_ms = ms.pop(f"{key}_copy")
                if key in ms:
                    ms[key] -= copy_ms
        row = dict(variant=name, csrc=variants[name][1],
                   consts=variants[name][0], not_bitwise=wrong[name],
                   schedule={k: v._asdict() for k, v in sched.items()},
                   walk_warps_per_block=warps, ptxas=lib["ptxas"], ms=ms,
                   runs=times[name], card=card)
        # a library from before kernel B's schedule reports zeros for it
        if all(sched["face_prefix"]):
            row["worklist_max"] = worklists(inputs, sched)
        report.append(row)
        print(json.dumps(row), flush=True)
    summary = {r["variant"]: {k: round(v, 5) for k, v in r["ms"].items()}
               for r in report}
    print(json.dumps({"summary_ms": summary, "card": card}), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as fh:
            json.dump(report, fh, indent=1)
    return 1 if any(wrong.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
