"""The arithmetic schedule of the face kernels' two phases, on the CPU.

csrc/face_cascade.cu walks a window's first kPhase1Trees (K) trees in one
thread, tree by tree; a window still alive then goes to a warp, whose 32
lanes walk one tree each, 32 trees a round, after which the round's leaves
are added in tree order and the window fails if any of the round's running
sums is <= its tree's threshold. The finish (face_finish) sends every
PREFIX_MARK window to the warp from tree 0. (A block whose worklist is
nearly full walks on a thread per window instead: that is the sequential
walk of the plain version itself.) A CUDA kernel cannot run here, so
`schedule_scores` below repeats the schedule in torch: each round's leaves
from independent walks, the f32 sums in the kernel's order. It is held bit for bit against the plain
version (ops/face_dense.py), which walks tree by tree, on seeded random
forests, upright and rotated, at the tree limits where the schedule has
edges (1, K, K+1, 32, 33, T), with thresholds that make windows fail at
the first, a middle and the last tree of a round, and with thresholds that
never fail; and against the JAX package's classify_windows on one small
frame. Exact equality is the tolerance throughout. The kernel itself
against the plain version is in tests/test_torch_cuda.py and
chip_smoke.py (card only).
"""

import os
import re

import numpy as np
import pytest
import torch

from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.ops import face_cuda, face_dense, windows
from pigo_tpu_torch.ops.pupil_dense import QCOS_TABLE, QSIN_TABLE
from test_torch_face_kernel import (  # noqa: F401 (autouse fixture)
    jax_scores, one_torch_thread, random_forest)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pigo_tpu_torch", "csrc", "face_cascade.cu")
MARK = face_dense.PREFIX_MARK
CFG = dict(min_size=10, max_size=40, shift_factor=0.15, scale_factor=1.25)
NEVER = -1e4  # a threshold no running sum of these forests reaches


def source_constant(name: str) -> int:
    """A `constexpr int` of csrc/face_cascade.cu."""
    with open(SOURCE) as fh:
        m = re.search(rf"constexpr int {name} = (\d+);", fh.read())
    assert m is not None, f"{name} not found in {SOURCE}"
    return int(m.group(1))


K = source_constant("kPhase1Trees")


def leaf_slots(frames, frame, win, base, scale, codes, trees, angle_idx,
               cols):
    """The leaf slot (node index in [L, 2L)) that each of `trees` sends
    each (frame, window) pair to, each tree walked on its own: int64
    [N, len(trees)]. The reads of face_walk.cuh, upright or rotated."""
    _, nrows, dim = frames.shape
    leaves = codes.shape[1]
    depth = leaves.bit_length() - 1
    pix = frames.reshape(-1).to(torch.int64)
    b = base.to(torch.int64)[win][:, None]
    s = scale.to(torch.int64)[win][:, None]
    r, c = b // cols, b % cols
    origin = (frame * nrows * dim)[:, None]
    qc, qs = s * QCOS_TABLE[angle_idx], s * QSIN_TABLE[angle_idx]
    t = torch.as_tensor(trees, dtype=torch.int64)[None, :]
    idx = torch.ones(frame.numel(), t.shape[1], dtype=torch.int64)
    cd = codes.to(torch.int64)
    for _ in range(depth):
        node = cd[t, idx]  # [N, n, 4] (r1, c1, r2, c2)
        p = []
        for cr, cc in ((node[..., 0], node[..., 1]),
                       (node[..., 2], node[..., 3])):
            if angle_idx == 0:
                at = (r + ((cr * s) >> 8)) * dim + c + ((cc * s) >> 8)
            else:
                rr = ((r * 65536 + qc * cr - qs * cc).clamp_min(0)
                      >> 16).clamp_max(nrows - 1)
                rc = ((c * 65536 + qs * cr + qc * cc).clamp_min(0)
                      >> 16).clamp_max(nrows - 1)
                at = (rr * dim + rc).clamp_max(nrows * dim - 1)
            p.append(pix[origin + at])
        idx = 2 * idx + (p[0] <= p[1]).to(torch.int64)
    return idx


def warp_walk(frames, frame, win, base, scale, forest, acc, t_start, t_limit,
              angle_idx, cols):
    """Phase 2 for N windows from tree t_start with sums acc f32 [N]:
    (alive bool [N], sums f32 [N]). Each round walks its 32 trees
    independently, then forms every running sum in tree order and fails
    the window when any is <= its tree's threshold."""
    codes, preds, thresh = forest
    leaves = preds.shape[1]
    alive = torch.ones(acc.shape, dtype=torch.bool)
    acc = acc.clone()
    for t0 in range(t_start, t_limit, 32):
        trees = list(range(t0, min(t0 + 32, t_limit)))
        slots = leaf_slots(frames, frame, win, base, scale, codes, trees,
                           angle_idx, cols)
        vals = preds[torch.as_tensor(trees)[None, :], slots - leaves]
        run, fail = acc.clone(), torch.zeros_like(alive)
        for j, t in enumerate(trees):
            run = run + vals[:, j]
            fail |= run <= thresh[t]
        # a window that failed in an earlier round keeps its state
        acc = torch.where(alive, run, acc)
        alive &= ~fail
    return alive, acc


def schedule_scores(frames, base, scale, forest, t_limit, angle_idx=0,
                    k=K):
    """face_cascade's scores f32 [B, W] by the kernel's schedule."""
    codes, preds, thresh = forest
    b, _, dim = frames.shape
    cols = dim
    w = base.shape[0]
    frame = torch.arange(b).repeat_interleave(w)
    win = torch.arange(w).repeat(b)
    n = frame.numel()
    leaves = preds.shape[1]
    t_num = preds.shape[0]
    # phase 1: a thread per window, tree by tree
    acc = torch.zeros(n, dtype=torch.float32)
    alive = torch.ones(n, dtype=torch.bool)
    for t in range(min(k, t_limit)):
        slot = leaf_slots(frames, frame, win, base, scale, codes, [t],
                          angle_idx, cols)[:, 0]
        acc = torch.where(alive, acc + preds[t][slot - leaves], acc)
        alive &= ~(acc <= thresh[t])
    # phase 2: the survivors with trees left
    if k < t_limit:
        sel = torch.nonzero(alive).squeeze(1)
        ok, sums = warp_walk(frames, frame[sel], win[sel], base, scale,
                             forest, acc[sel], k, t_limit, angle_idx, cols)
        alive[sel] = ok
        acc[sel] = sums
    final = (torch.full_like(acc, MARK) if t_limit < t_num
             else acc - thresh[t_num - 1])
    return torch.where(alive, final, torch.full_like(acc, -1.0)).reshape(b, w)


def schedule_finish(frames, base, scale, forest, q, angle_idx=0):
    """face_finish by the kernel's schedule: every mark walks all trees in
    a warp from tree 0 with the sum 0; -> a new q."""
    t_num = forest[1].shape[0]
    frame, win = torch.nonzero(q == MARK, as_tuple=True)
    alive, acc = warp_walk(frames, frame, win, base, scale, forest,
                           torch.zeros(frame.numel(), dtype=torch.float32),
                           0, t_num, angle_idx, frames.shape[2])
    out = q.clone()
    out[frame, win] = torch.where(alive, acc - forest[2][t_num - 1],
                                  torch.full_like(acc, -1.0))
    return out


def make_case(seed, depth, trees, thresh=-1.5):
    """A seeded random forest (port tensors) and 2 random frames with the
    window plan of CFG."""
    jf = random_forest(seed, depth=depth, trees=trees, thresh=thresh)
    ft = face_forest_from_numpy(jf.depth, jf.codes, jf.preds, jf.thresh)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 44, 52),
                                           dtype=np.uint8))
    plan = windows.build_window_plan(44, 52, **CFG)
    base, scale = face_cuda.device_plan(plan, torch.device("cpu"))
    return (ft.codes, ft.preds, ft.thresh), frames, base, scale


def check_both(forest, frames, base, scale, t_limit, angle_idx, k=K):
    """Schedule == plain version for the cascade at t_limit, and for the
    finish of its marks; returns the plain scores."""
    want = face_dense.classify_windows(frames, base, scale, *forest, t_limit,
                                       angle_idx=angle_idx)
    got = schedule_scores(frames, base, scale, forest, t_limit, angle_idx, k)
    assert torch.equal(got, want), (t_limit, angle_idx, k)
    if t_limit < forest[1].shape[0]:
        fin = schedule_finish(frames, base, scale, forest, want, angle_idx)
        assert torch.equal(fin, face_dense.finish_marked(
            frames, base, scale, *forest, want.clone(), angle_idx=angle_idx))
    return want


@pytest.mark.parametrize("angle_idx", [0, 2])
@pytest.mark.parametrize("depth,trees", [(6, 80), (4, 37)])
def test_schedule_matches_plain_at_tree_limits(depth, trees, angle_idx):
    """Seeded random forests fail windows at random trees; every tree limit
    where the schedule has an edge gives the plain version's scores, and
    the finish of its marks the plain finish's."""
    forest, frames, base, scale = make_case(depth + trees, depth, trees)
    q = {t_limit: check_both(forest, frames, base, scale, t_limit, angle_idx)
         for t_limit in sorted({1, K, K + 1, 32, 33, trees})}
    full = q[trees]
    # both outcomes occur, and windows fail in phase 2 too
    assert (full == -1.0).any() and (full > 0.0).any()
    assert int((q[K] == MARK).sum()) > int((full > 0.0).sum())


def running_sums(frames, base, scale, codes, preds, angle_idx):
    """Every (frame, window) pair's running sum after each tree, with no
    fail: f32 [B * W, T] (frame-major), the f32 adds in tree order."""
    b, w = frames.shape[0], base.shape[0]
    t_num, leaves = preds.shape
    slots = leaf_slots(frames, torch.arange(b).repeat_interleave(w),
                       torch.arange(w).repeat(b), base, scale, codes,
                       list(range(t_num)), angle_idx, frames.shape[2])
    vals = preds[torch.arange(t_num)[None, :], slots - leaves]
    acc = torch.zeros(vals.shape[0], dtype=torch.float32)
    out = []
    for j in range(t_num):
        acc = acc + vals[:, j]
        out.append(acc)
    return torch.stack(out, 1)


@pytest.mark.parametrize("angle_idx", [0, 2])
@pytest.mark.parametrize("depth,trees", [(6, 80), (4, 37)])
def test_schedule_fails_at_chunk_edges(depth, trees, angle_idx):
    """Thresholds that never fail except at the first, a middle and the
    last tree of phase 2's rounds (trees K, K+15, K+31, K+32, K+63 where
    the forest has them), each set to fail about a third of the windows
    alive there: at each such tree some windows fail and some survive it,
    and the schedule matches the plain version."""
    (codes, preds, _), frames, base, scale = make_case(7 * depth + trees,
                                                       depth, trees)
    edges = [t for t in (K, K + 15, K + 31, K + 32, K + 63) if t < trees]
    sums = running_sums(frames, base, scale, codes, preds, angle_idx)
    thresh = torch.full((trees,), NEVER, dtype=torch.float32)
    alive = torch.ones(sums.shape[0], dtype=torch.bool)
    for t in edges:
        thresh[t] = torch.quantile(sums[alive, t].double(), 0.33).float()
        fails = alive & (sums[:, t] <= thresh[t])
        assert 0 < int(fails.sum()) < int(alive.sum()), t
        alive &= ~fails
    forest = (codes, preds, thresh)
    for t_limit in sorted({K + 1, 33, trees}):
        check_both(forest, frames, base, scale, t_limit, angle_idx)
    for t in edges:
        before = face_dense.classify_windows(frames, base, scale, *forest, t,
                                             angle_idx=angle_idx)
        after = face_dense.classify_windows(frames, base, scale, *forest,
                                            t + 1, angle_idx=angle_idx)
        assert 0 < int((after != -1.0).sum()) < int((before != -1.0).sum())


@pytest.mark.parametrize("angle_idx", [0, 2])
def test_schedule_never_failing_forest(angle_idx):
    """Thresholds that never fail: every window goes to phase 2 and walks
    every tree; scores and finish equal the plain version's."""
    forest, frames, base, scale = make_case(5, 6, 80, thresh=NEVER)
    for t_limit in (80, 36, K + 1):
        q = check_both(forest, frames, base, scale, t_limit, angle_idx)
        assert bool((q != -1.0).all())


@pytest.mark.parametrize("k", [1, 2, 8])
def test_schedule_other_phase1_lengths(k):
    """The schedule is exact for any phase-1 length, not only the
    committed one."""
    forest, frames, base, scale = make_case(11, 6, 80)
    for t_limit in sorted({1, k, k + 1, 33, 80}):
        check_both(forest, frames, base, scale, t_limit, 0, k)


def test_schedule_matches_jax_classify():
    """On one small frame the schedule gives the JAX package's
    classify_windows scores (pigo_tpu.ops.face_dense)."""
    jf = random_forest(3, depth=6, trees=40)
    frame = np.random.default_rng(12).integers(0, 256, (60, 64),
                                               dtype=np.uint8)
    cfg = dict(min_size=10, max_size=60, shift_factor=0.1, scale_factor=1.2)
    ft = face_forest_from_numpy(jf.depth, jf.codes, jf.preds, jf.thresh)
    plan = windows.build_window_plan(60, 64, **cfg)
    base, scale = face_cuda.device_plan(plan, torch.device("cpu"))
    got = schedule_scores(torch.from_numpy(frame)[None], base, scale,
                          (ft.codes, ft.preds, ft.thresh), 40)[0].numpy()
    want = jax_scores(jf, frame, cfg)
    assert np.array_equal(got, want)
    assert (got == -1.0).any() and (got > 0.0).any()


def test_worklist_max_counts_per_block():
    """The smoke's worklist length: the most queued windows in any block of
    consecutive (frame, window) entries, frame-major, the last block
    short."""
    from pigo_tpu_torch.tools.face_sweep import worklist_max

    alive = torch.zeros(2, 5, dtype=torch.bool)
    alive[0, 1] = alive[0, 3] = alive[1, 0] = alive[1, 4] = True
    # blocks of 4: [f0 w0-3] 2, [f0 w4, f1 w0-2] 1, [f1 w3-4] 1
    assert worklist_max(alive, 4) == 2
    assert worklist_max(alive, 3) == 1 + 1  # [f0 w3, f0 w4, f1 w0]
    assert worklist_max(alive, 16) == 4


def test_sweep_variant_sets_constants(tmp_path, monkeypatch):
    """face_sweep builds each variant from a copy of csrc/ with the named
    constants set, and refuses a constant the source does not have."""
    from pigo_tpu_torch.tools import face_sweep

    monkeypatch.setattr(face_sweep, "SWEEP_DIR", str(tmp_path))
    csrc = os.path.dirname(SOURCE)
    paths = face_sweep.variant_sources(
        "v", {"kPhase1Trees": 9, "kThreads": 128}, csrc)
    assert [os.path.basename(p) for p in paths] == ["face_cascade.cu",
                                                    "face_prefix.cu"]
    with open(paths[0]) as fh:
        text = fh.read()
    assert "constexpr int kPhase1Trees = 9;" in text
    assert "constexpr int kThreads = 128;" in text
    assert os.path.isfile(os.path.join(tmp_path, "v", "face_walk.cuh"))
    with open(SOURCE) as fh:  # the checkout's source is untouched
        assert f"constexpr int kPhase1Trees = {K};" in fh.read()
    with pytest.raises(RuntimeError, match="kNoSuch"):
        face_sweep.variant_sources("w", {"kNoSuch": 1}, csrc)
    assert face_sweep.variant_sources("x", None, csrc)[0] == SOURCE
