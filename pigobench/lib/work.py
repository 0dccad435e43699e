"""Operations and bytes of the kernels, from the reference's work counts, and
the card's published peaks.

What a kernel needs for these inputs, counting each input byte once and
each output byte once, whatever it reads again:
  - face cascade (A), one launch a frame: the distinct pixels (1 B), code
    words (4 B) and leaves (4 B) read, a threshold (4 B) for each tree
    reached, each window's base and scale (8 B) and its score (4 B);
    operations: per tree a window is alive at, `depth` pixel comparisons,
    a leaf addition and a threshold comparison;
  - the regression walk (C), one launch for a frame's eyes and one for its
    landmark points: the distinct pixels (1 B), code words (4 B) and
    leaves (8 B, dr and dc), each walker's cascade id, start and flip in
    (20 B) and its result out (12 B); operations: per walker, stage and
    tree, `depth` comparisons and the two leaf additions;
  - the cluster kernel, one launch a frame: each hit in and each cluster
    out (16 B each); operations: an IoU test (25 float64 operations) of
    each cluster's seed against every hit.
The least time of a launch is the larger of its bytes over the memory
bandwidth and its operations over the arithmetic peak.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense rates, 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12,
                              "f64_ops_per_s": 34e12},
}
IOU_OPS = 25


def peaks(kind: str) -> dict | None:
    return PEAKS.get(kind)


def face_cascade(c: dict, depth: int) -> tuple[float, float]:
    """(operations, bytes) of one launch of A from a frame's counts."""
    ops = c["evaluations"] * (depth + 2)
    nbytes = (c["pixels"] + 4 * c["code_words"] + 4 * c["leaves"]
              + 4 * c["trees"] + 12 * c["windows"])
    return ops, nbytes


def walk(c: dict, stages: int, trees: int, depth: int) -> tuple[float, float]:
    """(operations, bytes) of one launch of C from its counts."""
    ops = c["walkers"] * stages * trees * (depth + 2)
    nbytes = (c["pixels"] + 4 * c["code_words"] + 8 * c["leaves"]
              + 32 * c["walkers"])
    return ops, nbytes


def cluster(c: dict) -> tuple[float, float]:
    """(float64 operations, bytes) of one launch of the cluster kernel."""
    return (IOU_OPS * c["clusters"] * c["hits"],
            16 * (c["hits"] + c["clusters"]))


def least_s(ops: float, nbytes: float, peak: dict,
            ops_key: str = "f32_ops_per_s") -> float:
    return max(ops / peak[ops_key], nbytes / peak["bytes_per_s"])


def kernel_seconds(ctx, key: str) -> float:
    """The traced device time of the kernels whose name holds `key`."""
    return sum(sum(v) for k, v in ctx.trace["kernels"].items() if key in k)


def launches(ctx):
    """Per traced request: [(kernel key, operations, bytes, ops peak key)]
    of the launches these inputs need."""
    w = ctx.work
    out = []
    for face, walks in zip(w["face"], w["walks"]):
        got = [("face_cascade_kernel",
                *face_cascade(face, w["face_depth"]), "f32_ops_per_s"),
               ("cluster_kernel", *cluster(face), "f64_ops_per_s")]
        if walks is not None:
            got += [("pupil_walk_kernel", *walk(walks["eyes"], *w["pupil"]),
                     "f32_ops_per_s"),
                    ("pupil_walk_kernel",
                     *walk(walks["landmarks"], *w["landmarks"]),
                     "f32_ops_per_s")]
        out.append(got)
    return out


def roofline(ctx, key: str) -> float | None:
    """Percent of the traced time of the `key` kernels that the least time
    of the launches these inputs need takes; None without a trace, a
    known card or such a kernel in it."""
    if ctx.trace is None or ctx.work is None:
        return None
    peak, t = peaks(ctx.kind), kernel_seconds(ctx, key)
    if peak is None or t <= 0.0:
        return None
    least = sum(least_s(ops, nb, peak, pk) for req in launches(ctx)
                for k, ops, nb, pk in req if k == key)
    return 100.0 * least / t


def frame_ops(ctx) -> float:
    """float32 operations of A and both walks over the traced requests."""
    return sum(ops for req in launches(ctx) for _, ops, _, pk in req
               if pk == "f32_ops_per_s")
