"""Times builds of the face kernels' library against each other on one card.

    python -m pigo_tpu_torch.tools.face_sweep
        [--const kPhase1Trees=1,2,4,8 --const kThreads=64,256 ...]
        [--tree NAME=CSRC_DIR ...] [--out FILE]

Each variant is the library `face_cascade` (csrc/face_cascade.cu with
csrc/face_prefix.cu) built from a csrc/ directory: this checkout's with
its `constexpr int` constants set to each combination of the --const
values (`kPhase1Trees`, the trees a window walks alone before a survivor
goes to a warp; `kThreads`, the windows of a block), and each --tree
directory as it is (for example the csrc/ of a `git archive` of another
commit). The variants are built in parallel, then timed in turns on the
same inputs (in variant order, then in reverse order), each call first
held bit for bit against the plain version: a case that differs is
reported and not timed, and the run exits 1. The inputs are the main
path's: the facefinder forest over the sample frame's 400x320 headline
pyramid and its 1080x1920 tiling (the pyramids of chip_smoke.py), upright
and at angle 0.07. Cases:
  - cascade, cascade_rotated: face_cascade over every window, all trees;
  - survivors_only: face_cascade over the windows that survive all trees;
  - all_survive: face_cascade with thresholds that never fail (every
    window walks every tree; headline only);
  - finish, finish_rotated: face_finish of the tail scales' 32-tree marks
    (timed as copy + finish less the copy);
  - prefix: face_prefix over the tail scales (kernel B, for reference).
Each variant also gives its schedule and the largest per-block worklist:
for the cascade, the windows of one block still alive after kPhase1Trees
trees; for the finish, the marks of one block. Prints one JSON line per
variant and a summary line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import os
import re
import shutil
import sys
import unittest.mock

import numpy as np
import torch

from pigo_tpu_torch.models.face import FaceCascade, angle_index
from pigo_tpu_torch.ops import face_cuda, face_dense
from pigo_tpu_torch.ops.windows import build_window_plan
from pigo_tpu_torch.utils import build
from pigo_tpu_torch.utils.device import card_description, cuda_ms

HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)
HD = dict(min_size=40, max_size=1080, shift_factor=0.1, scale_factor=1.1)
ROT_ANGLE = 0.07
SWEEP_DIR = os.path.join(build.BUILD_DIR, "sweep")


def variant_sources(name: str, consts: dict[str, int] | None,
                    csrc: str) -> list[str]:
    """The library's sources for one variant: csrc's own, or a copy under
    SWEEP_DIR with each `constexpr int NAME = ...;` of face_cascade.cu in
    `consts` set to its value."""
    if consts is None:
        return [os.path.join(csrc, f) for f in build.sources("face_cascade")]
    out = os.path.join(SWEEP_DIR, name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "face_cascade.cu")
    with open(path) as fh:
        text = fh.read()
    for const, value in consts.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{path}: expected one constant {const}")
    with open(path, "w") as fh:
        fh.write(text)
    return [os.path.join(out, f) for f in build.sources("face_cascade")]


def build_variants(variants: dict[str, tuple[dict | None, str]]):
    """Compile every variant in parallel; -> {name: (CDLL, schedule)}."""
    os.makedirs(SWEEP_DIR, exist_ok=True)

    def one(item):
        name, (consts, csrc) = item
        so = os.path.join(SWEEP_DIR, f"lib{name}.so")
        build.compile_library(variant_sources(name, consts, csrc), so)
        return name, so

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(pool.map(one, variants.items()))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(so)
        try:
            face_cuda._bind(lib)
            sched = face_cuda.schedule(lib)
        except AttributeError:  # a library from before pigo_face_schedule
            sched = None
        libs[name] = (lib, sched)
    return libs


def worklist_max(alive: torch.Tensor, threads: int) -> int:
    """The largest count of True in a block of `threads` consecutive
    (frame, window) entries of alive bool [B, W] (frame-major): the
    longest phase-2 worklist of a face_cascade or face_finish block, given
    the windows it queues."""
    flat = alive.reshape(-1).to(torch.int32)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % threads))
    return int(flat.reshape(-1, threads).sum(1).max())


def cases(dev):
    """name -> (kernel call, its plain result, reps) on the real frames;
    and per shape the cascade's arguments and the finish's marks."""
    forest = FaceCascade(device=dev).tensors
    tables = (forest.codes, forest.preds, forest.thresh)
    never = (forest.codes, forest.preds,
             torch.full_like(forest.thresh, -1e4))
    t_num = forest.num_trees
    rot = angle_index(ROT_ANGLE)
    gray = np.load(os.path.join(build.PKG_DIR, "assets", "sample_gray.npy"))
    hd = np.tile(gray, (1080 // 400 + 1, 1920 // 320 + 1))[:1080, :1920]
    out, inputs = {}, {}
    for shape, frame, cfg in (("headline", gray, HEADLINE),
                              ("hd1080", hd, HD)):
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
        out[f"{shape}/prefix"] = (
            lambda a=(one, pb, ps, *tables, seg.t_limit):
            face_cuda.face_prefix(*a),
            face_dense.classify_windows(one, pb, ps, *tables, seg.t_limit),
            50)
        for label, a in (("finish", 0), ("finish_rotated", rot)):
            marks = face_dense.classify_windows(one, pb, ps, *tables,
                                                seg.t_limit, angle_idx=a)
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
    return out, inputs


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
            lib = libs[name][0]
            with unittest.mock.patch.object(face_cuda, "load_kernel",
                                            lambda lib=lib: lib):
                for case, (fn, want, reps) in work.items():
                    got = fn()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        wrong[name].append(case)  # not timed
                        continue
                    times[name].setdefault(case, []).append(
                        cuda_ms(fn, reps, True))
    report = []
    for name, (_, sched) in libs.items():
        ms = {case: sum(v) / len(v) for case, v in times[name].items()}
        for shape in ("headline", "hd1080"):
            for label in ("finish", "finish_rotated"):
                key = f"{shape}/{label}"
                copy_ms = ms.pop(f"{key}_copy")
                if key in ms:
                    ms[key] -= copy_ms
        row = dict(variant=name, csrc=variants[name][1],
                   consts=variants[name][0], not_bitwise=wrong[name],
                   phase1_trees=sched[0] if sched else None,
                   block_threads=sched[1] if sched else None,
                   ms=ms, runs=times[name], card=card)
        if sched:
            k, threads = sched
            for shape, given in inputs.items():
                one, base, scale, *tables, _ = given["cascade"]
                # the windows still alive after k trees: k < T, so marked
                qk = face_dense.classify_windows(one, base, scale, *tables, k)
                row[f"{shape}_worklist_max"] = {
                    "cascade": worklist_max(qk != -1.0, threads),
                    **{label: worklist_max(given[label]
                                           == face_dense.PREFIX_MARK,
                                           threads)
                       for label in ("finish", "finish_rotated")}}
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
