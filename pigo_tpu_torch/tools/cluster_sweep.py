"""Times builds of the cluster kernel against each other on one card.

    python -m pigo_tpu_torch.tools.cluster_sweep
        [--const kClusterStages=2,4 --const kClusterSoloEntries=0,128 ...]
        [--tree NAME=CSRC_DIR ...] [--reps N] [--out FILE]

Each variant is the `cluster_device` library (csrc/cluster_device.cu),
built from a csrc/ directory: this checkout's with its `constexpr int`
constants set to each combination of the --const values (as
`tools/face_sweep.py` sets them), and each --tree directory as it is (for
example the csrc/ of a `git archive` of another commit; a library without
`pigo_cluster_scratch_bytes` is called with the one-block kernel's
arguments, as before that function existed). The variants are built in
parallel, then timed in turns on the same inputs (in variant order, then
in reverse order, `cuda_ms` with the stream queued ahead), each call
first held bit for bit against the plain version: a case that differs is
reported and not timed, and the run exits 1. Cases, at the device
detector's capacity (FaceCascade.HIT_CAPACITY): the hit lists of the
sample frame (the golden sample's configuration) and of its 1080x1920
tiling, on this card's face kernel; the seeded random sets and the edge
sets of `tools/cluster_sets.py`. Prints one JSON line per variant (its
mean ms per case, each turn's ms, the compiler's register and spill
lines) and a summary line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import os
import sys

import numpy as np
import torch

from pigo_tpu_torch.models.face import FaceCascade
from pigo_tpu_torch.ops import cluster_device as cd
from pigo_tpu_torch.tools import cluster_sets
from pigo_tpu_torch.tools.face_sweep import (DET_IOU, DET_SAMPLE, HD,
                                             SWEEP_DIR, variant_sources)
from pigo_tpu_torch.utils import build
from pigo_tpu_torch.utils.device import card_description, cuda_ms

LIBRARY = "cluster_device"


def build_variants(variants: dict[str, tuple[dict | None, str]]):
    """Compile every variant in parallel; -> {name: (CDLL, the compiler's
    register and spill lines)}."""
    os.makedirs(SWEEP_DIR, exist_ok=True)
    sources = {name: variant_sources(name, consts, csrc, (LIBRARY,))[LIBRARY]
               for name, (consts, csrc) in variants.items()}

    def one(name):
        so = os.path.join(SWEEP_DIR, f"lib{LIBRARY}-{name}.so")
        report = build.compile_library(sources[name], so)
        return name, (so, [ln.strip() for ln in report.splitlines()
                           if "registers" in ln or "spill" in ln])

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(pool.map(one, variants))
    libs = {}
    for name, (so, ptxas) in built.items():
        lib = ctypes.CDLL(so)
        if hasattr(lib, "pigo_cluster_scratch_bytes"):
            build.bind_library(lib, cd._bind)
            call = _caller(lib)
        else:
            call = _one_block_caller(lib)
        libs[name] = (call, ptxas)
    return libs


def _caller(lib):
    """cluster_device through its wrapper, on `lib`."""
    def call(dets, valid, count, thr, capacity):
        saved = cd.load_kernel
        cd.load_kernel = lambda: lib
        try:
            return cd.cluster_device(dets, valid, count, thr,
                                     capacity=capacity)
        finally:
            cd.load_kernel = saved
    return call


def _one_block_caller(lib):
    """The one-block kernel's C interface (no scratch buffer)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pigo_cluster_device.restype = i
    lib.pigo_cluster_device.argtypes = [vp, vp, vp, i, ctypes.c_double, vp,
                                        vp, vp]

    def call(dets, valid, count, thr, capacity):
        out = torch.empty((capacity, 4), dtype=torch.float32,
                          device=dets.device)
        out_valid = torch.empty(capacity, dtype=torch.bool,
                                device=dets.device)
        rc = lib.pigo_cluster_device(
            dets.data_ptr(), valid.data_ptr(), count.data_ptr(), capacity,
            float(thr), out.data_ptr(), out_valid.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cluster_device launch failed ({rc})")
        return out, out_valid
    return call


def cases(dev) -> list[cluster_sets.ClusterSet]:
    """The hit lists of both frames, then the seeded sets."""
    gray = np.load(os.path.join(build.PKG_DIR, "assets", "sample_gray.npy"))
    hd = np.tile(gray, (1080 // 400 + 1, 1920 // 320 + 1))[:1080, :1920]
    face = FaceCascade(device=dev)
    out = []
    for name, frame, cfg in (("sample", gray, DET_SAMPLE),
                             ("hd1080", hd, HD)):
        hits = face.run_cascade(frame, *frame.shape, **cfg)
        out.append(cluster_sets.full(name, hits, DET_IOU))
    cap = FaceCascade.HIT_CAPACITY
    return out + cluster_sets.random_sets(cap) + cluster_sets.edge_sets(cap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--const", action="append", default=[],
                    metavar="NAME=V1,V2,...")
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=CSRC_DIR")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", default=None)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cluster_sweep: no CUDA device available", file=sys.stderr)
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
    cap = FaceCascade.HIT_CAPACITY
    work = []
    for cs in cases(dev):
        args = (*cluster_sets.buffers(cs, cap, dev), cs.iou)
        want = cd.cluster_plain(*args)
        work.append((cs, args, want))
    card = card_description()
    times: dict[str, dict[str, list[float]]] = {n: {} for n in libs}
    wrong: dict[str, list[str]] = {n: [] for n in libs}
    order = list(libs)
    for turn in (order, order[::-1]):
        for name in turn:
            call = libs[name][0]
            for cs, args, (want, wvalid) in work:
                got, gvalid = call(*args, cap)
                torch.cuda.synchronize()
                if not (torch.equal(gvalid, wvalid) and torch.equal(
                        got.view(torch.int32), want.view(torch.int32))):
                    wrong[name].append(cs.name)  # not timed
                    continue
                times[name].setdefault(cs.name, []).append(cuda_ms(
                    lambda a=args: call(*a, cap), opts.reps, True))
    report = []
    for name, (_, ptxas) in libs.items():
        ms = {case: sum(v) / len(v) for case, v in times[name].items()}
        row = dict(variant=name, csrc=variants[name][1],
                   consts=variants[name][0], not_bitwise=sorted(
                       set(wrong[name])), ptxas=ptxas, ms=ms,
                   runs=times[name], card=card)
        report.append(row)
        print(json.dumps(row), flush=True)
    sizes = {cs.name: [cs.entries().shape[0],
                       cluster_sets.seed_count(cs.entries(), cs.iou)]
             for cs, _, _ in work}
    summary = {r["variant"]: {k: round(v, 5) for k, v in r["ms"].items()}
               for r in report}
    print(json.dumps({"summary_ms": summary, "entries_seeds": sizes,
                      "card": card}), flush=True)
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)),
                    exist_ok=True)
        with open(opts.out, "w") as fh:
            json.dump({"variants": report, "entries_seeds": sizes}, fh,
                      indent=1)
    return 1 if any(wrong.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
