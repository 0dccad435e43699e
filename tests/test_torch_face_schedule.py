"""The arithmetic schedule of the face kernels' two phases, on the CPU.

csrc/face_walk.cuh holds the schedule that kernel A (face_cascade and
face_finish, csrc/face_cascade.cu) and kernel B (face_prefix,
csrc/face_prefix.cu) share: a window's first kPhase1Trees (K) trees in one
thread, tree by tree; a window still alive then goes to a warp, whose 32
lanes walk one tree each, 32 trees a round, after which the round's leaves
are added in tree order and the window fails if any of the round's running
sums is <= its tree's threshold. The finish (face_finish) sends every
PREFIX_MARK window to the warp from tree 0. Kernel A reads its tables from
global memory; kernel B stages its t_limit trees in shared memory with
each tree's slots XOR-swizzled (`swizzle` below), reads children pairs
through the swizzled pair index, and marks its survivors PREFIX_MARK. (A
block whose worklist is nearly full walks on a thread per window instead:
that is the sequential walk of the plain version itself.) A CUDA kernel
cannot run here, so `schedule_scores` below repeats the schedule in torch:
each round's leaves from independent walks, read through the kernel's
table layout, the f32 sums in the kernel's order. It is held bit for bit
against the plain version (ops/face_dense.py), which walks tree by tree,
on seeded random forests, upright and rotated, at the tree limits where
the schedule has edges (1, K, K+1, 32, 33, 64, T), with thresholds that
make windows fail at the first, a middle and the last tree of a round, and
with thresholds that never fail; and against the JAX package's
classify_windows on one small frame. Exact equality is the tolerance
throughout. The constants the emulation assumes are read from the
sources. The kernels themselves against the plain version are in
tests/test_torch_cuda.py and chip_smoke.py (card only).
"""

import dataclasses
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

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pigo_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "face_cascade.cu")
MARK = face_dense.PREFIX_MARK
CFG = dict(min_size=10, max_size=40, shift_factor=0.15, scale_factor=1.25)
NEVER = -1e4  # a threshold no running sum of these forests reaches


def read_source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def source_constant(name: str, fname: str = "face_cascade.cu") -> int:
    """A `constexpr int` of csrc/<fname>."""
    m = re.search(rf"constexpr int {name} = (\d+);", read_source(fname))
    assert m is not None, f"{name} not found in {fname}"
    return int(m.group(1))


K = source_constant("kPhase1Trees")  # kernel A and the finish
KB = source_constant("kPrefixPhase1Trees", "face_prefix.cu")  # kernel B
ROUND = source_constant("kRoundTrees", "face_walk.cuh")  # trees a round


def swizzle(t: torch.Tensor, depth: int) -> torch.Tensor:
    """The XOR mask of tree t's shared-memory slots (pigo::swizzle)."""
    return (((t & 15) << 1) | ((t >> 4) & 1)) & ((1 << depth) - 1)


@dataclasses.dataclass(frozen=True)
class GlobalTables:
    """Kernel A's tables (pigo::GlobalForest): node k of tree t at
    t * L + k."""

    codes: torch.Tensor  # int8 [T, L, 4]
    preds: torch.Tensor  # f32 [T, L]

    def node(self, t, k):
        return self.codes[t, k]

    def kids(self, t, idx):
        """Nodes (2 idx, 2 idx + 1) as one pair: [..., 2, 4]."""
        t_num, leaves, _ = self.codes.shape
        return self.codes.reshape(t_num, leaves // 2, 2, 4)[t, idx]

    def leaf(self, t, k):
        return self.preds[t, k]


@dataclasses.dataclass(frozen=True)
class SwizzledTables:
    """Kernel B's tables as face_prefix.cu stages them in shared memory
    (pigo::SwizzledForest): node and leaf k of tree t at slot
    t * L + (k ^ swizzle(t)); a children pair read as the aligned pair
    idx ^ (mask >> 1), its halves swapped when bit 0 of the mask is set."""

    codes: torch.Tensor  # int8 [t_limit * L, 4] slots
    preds: torch.Tensor  # f32 [t_limit * L] slots
    depth: int

    @classmethod
    def stage(cls, codes, preds, t_limit):
        leaves = preds.shape[1]
        depth = leaves.bit_length() - 1
        t = torch.arange(t_limit)[:, None]
        k = torch.arange(leaves)[None, :]
        slot = (t * leaves + (k ^ swizzle(t, depth))).reshape(-1)
        s_codes = torch.zeros(t_limit * leaves, 4, dtype=codes.dtype)
        s_preds = torch.zeros(t_limit * leaves, dtype=preds.dtype)
        s_codes[slot] = codes[:t_limit].reshape(-1, 4)
        s_preds[slot] = preds[:t_limit].reshape(-1)
        return cls(s_codes, s_preds, depth)

    def _slot(self, t, k):
        return (t << self.depth) + (k ^ swizzle(t, self.depth))

    def node(self, t, k):
        return self.codes[self._slot(t, k)]

    def kids(self, t, idx):
        m = swizzle(t, self.depth)
        pairs = self.codes.reshape(-1, 2, 4)
        pair = pairs[(t << (self.depth - 1)) + (idx ^ (m >> 1))]
        return torch.where((m & 1).bool()[..., None, None], pair.flip(-2),
                           pair)

    def leaf(self, t, k):
        return self.preds[self._slot(t, k)]


def leaf_slots(frames, frame, win, base, scale, tables, trees, angle_idx,
               cols, depth, paired=False):
    """The leaf slot (node index in [L, 2L)) that each of `trees` sends
    each (frame, window) pair to, each tree walked on its own: int64
    [N, len(trees)]. The reads of face_walk.cuh, upright or rotated; the
    node codes read one at a time (leaf_slot, phase 1) or, with `paired`,
    the root alone and then each level's children as one pair
    (survives_warp, phase 2)."""
    _, nrows, dim = frames.shape
    pix = frames.reshape(-1).to(torch.int64)
    b = base.to(torch.int64)[win][:, None]
    s = scale.to(torch.int64)[win][:, None]
    r, c = b // cols, b % cols
    origin = (frame * nrows * dim)[:, None]
    qc, qs = s * QCOS_TABLE[angle_idx], s * QSIN_TABLE[angle_idx]
    t = torch.as_tensor(trees, dtype=torch.int64)[None, :].expand(
        frame.numel(), -1)
    idx = torch.ones(frame.numel(), t.shape[1], dtype=torch.int64)
    if paired:
        code = tables.node(t, idx).to(torch.int64)
    for d in range(depth):
        if not paired:
            code = tables.node(t, idx).to(torch.int64)  # [N, n, 4]
        elif d + 1 < depth:
            kids = tables.kids(t, idx).to(torch.int64)  # [N, n, 2, 4]
        p = []
        for cr, cc in ((code[..., 0], code[..., 1]),
                       (code[..., 2], code[..., 3])):
            if angle_idx == 0:
                at = (r + ((cr * s) >> 8)) * dim + c + ((cc * s) >> 8)
            else:
                rr = ((r * 65536 + qc * cr - qs * cc).clamp_min(0)
                      >> 16).clamp_max(nrows - 1)
                rc = ((c * 65536 + qs * cr + qc * cc).clamp_min(0)
                      >> 16).clamp_max(nrows - 1)
                at = (rr * dim + rc).clamp_max(nrows * dim - 1)
            p.append(pix[origin + at])
        right = (p[0] <= p[1]).to(torch.int64)
        idx = 2 * idx + right
        if paired and d + 1 < depth:
            code = torch.gather(kids, 2, right[..., None, None].expand(
                -1, -1, 1, 4))[:, :, 0]
    return idx


def warp_walk(frames, frame, win, base, scale, tables, thresh, acc, t_start,
              t_limit, angle_idx, cols, depth):
    """Phase 2 for N windows from tree t_start with sums acc f32 [N]:
    (alive bool [N], sums f32 [N]). Each round walks its ROUND trees
    independently, then forms every running sum in tree order and fails
    the window when any is <= its tree's threshold."""
    leaves = 1 << depth
    alive = torch.ones(acc.shape, dtype=torch.bool)
    acc = acc.clone()
    for t0 in range(t_start, t_limit, ROUND):
        trees = list(range(t0, min(t0 + ROUND, t_limit)))
        slots = leaf_slots(frames, frame, win, base, scale, tables, trees,
                           angle_idx, cols, depth, paired=True)
        vals = tables.leaf(torch.as_tensor(trees)[None, :], slots - leaves)
        run, fail = acc.clone(), torch.zeros_like(alive)
        for j, t in enumerate(trees):
            run = run + vals[:, j]
            fail |= run <= thresh[t]
        # a window that failed in an earlier round keeps its state
        acc = torch.where(alive, run, acc)
        alive &= ~fail
    return alive, acc


def schedule_scores(frames, base, scale, forest, t_limit, angle_idx=0,
                    k=None, prefix=False):
    """face_cascade's scores f32 [B, W] by the kernel's schedule, or with
    `prefix` face_prefix's (tables swizzled in shared memory, survivors
    marked); k is the phase-1 length (the kernel's by default)."""
    codes, preds, thresh = forest
    if k is None:
        k = KB if prefix else K
    b, _, dim = frames.shape
    cols = dim
    w = base.shape[0]
    frame = torch.arange(b).repeat_interleave(w)
    win = torch.arange(w).repeat(b)
    n = frame.numel()
    t_num, leaves = preds.shape
    depth = leaves.bit_length() - 1
    if prefix:
        assert t_limit < t_num
        tables = SwizzledTables.stage(codes, preds, t_limit)
    else:
        tables = GlobalTables(codes, preds)
    # phase 1: a thread per window, tree by tree
    acc = torch.zeros(n, dtype=torch.float32)
    alive = torch.ones(n, dtype=torch.bool)
    for t in range(min(k, t_limit)):
        slot = leaf_slots(frames, frame, win, base, scale, tables, [t],
                          angle_idx, cols, depth)[:, 0]
        acc = torch.where(alive, acc + tables.leaf(t, slot - leaves), acc)
        alive &= ~(acc <= thresh[t])
    # phase 2: the survivors with trees left
    if k < t_limit:
        sel = torch.nonzero(alive).squeeze(1)
        ok, sums = warp_walk(frames, frame[sel], win[sel], base, scale,
                             tables, thresh, acc[sel], k, t_limit, angle_idx,
                             cols, depth)
        alive[sel] = ok
        acc[sel] = sums
    final = (torch.full_like(acc, MARK) if t_limit < t_num
             else acc - thresh[t_num - 1])
    return torch.where(alive, final, torch.full_like(acc, -1.0)).reshape(b, w)


def schedule_finish(frames, base, scale, forest, q, angle_idx=0):
    """face_finish by the kernel's schedule: every mark walks all trees in
    a warp from tree 0 with the sum 0; -> a new q."""
    codes, preds, thresh = forest
    t_num, leaves = preds.shape
    frame, win = torch.nonzero(q == MARK, as_tuple=True)
    alive, acc = warp_walk(frames, frame, win, base, scale,
                           GlobalTables(codes, preds), thresh,
                           torch.zeros(frame.numel(), dtype=torch.float32),
                           0, t_num, angle_idx, frames.shape[2],
                           leaves.bit_length() - 1)
    out = q.clone()
    out[frame, win] = torch.where(alive, acc - thresh[t_num - 1],
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


def check_both(forest, frames, base, scale, t_limit, angle_idx, k=None,
               prefix=False):
    """Schedule == plain version at t_limit for the cascade (and for the
    finish of its marks) or, with `prefix`, for face_prefix; returns the
    plain scores."""
    want = face_dense.classify_windows(frames, base, scale, *forest, t_limit,
                                       angle_idx=angle_idx)
    got = schedule_scores(frames, base, scale, forest, t_limit, angle_idx, k,
                          prefix)
    assert torch.equal(got, want), (t_limit, angle_idx, k, prefix)
    if not prefix and t_limit < forest[1].shape[0]:
        fin = schedule_finish(frames, base, scale, forest, want, angle_idx)
        assert torch.equal(fin, face_dense.finish_marked(
            frames, base, scale, *forest, want.clone(), angle_idx=angle_idx))
    return want


def mode_limits(mode, trees, *limits):
    """The mode's phase-1 length and the tree limits it takes among
    `limits` (face_prefix: below the forest size)."""
    k = KB if mode == "prefix" else K
    top = trees - 1 if mode == "prefix" else trees
    return k, sorted({t for t in limits if 1 <= t <= top})


MODES = ["cascade", "prefix"]
# upright and rotated for both kernels; kernel B also at the second
# rotation index of its card test
ANGLE_MODES = [(a, m) for a in (0, 2) for m in MODES] + [(4, "prefix")]


@pytest.mark.parametrize("angle_idx,mode", ANGLE_MODES)
@pytest.mark.parametrize("depth,trees", [(6, 80), (4, 37)])
def test_schedule_matches_plain_at_tree_limits(depth, trees, angle_idx,
                                               mode):
    """Seeded random forests fail windows at random trees; every tree limit
    where the schedule has an edge (1, K, K+1, 32, 33, 64, T, where the
    mode takes it) gives the plain version's scores, and the finish of the
    cascade's marks the plain finish's. face_prefix reads its tables
    through the swizzled shared-memory layout."""
    forest, frames, base, scale = make_case(depth + trees, depth, trees)
    k, limits = mode_limits(mode, trees, 1, K, KB, K + 1, KB + 1, 32, 33,
                            64, trees)
    prefix = mode == "prefix"
    q = {t_limit: check_both(forest, frames, base, scale, t_limit, angle_idx,
                             prefix=prefix)
         for t_limit in limits}
    full = face_dense.classify_windows(frames, base, scale, *forest, trees,
                                       angle_idx=angle_idx)
    # both outcomes occur, and windows fail in phase 2 too
    assert (full == -1.0).any() and (full > 0.0).any()
    assert int((q[k] == MARK).sum()) > int((q[limits[-1]] != -1.0).sum())


def running_sums(frames, base, scale, codes, preds, angle_idx):
    """Every (frame, window) pair's running sum after each tree, with no
    fail: f32 [B * W, T] (frame-major), the f32 adds in tree order."""
    b, w = frames.shape[0], base.shape[0]
    t_num, leaves = preds.shape
    slots = leaf_slots(frames, torch.arange(b).repeat_interleave(w),
                       torch.arange(w).repeat(b), base, scale,
                       GlobalTables(codes, preds), list(range(t_num)),
                       angle_idx, frames.shape[2], leaves.bit_length() - 1)
    vals = preds[torch.arange(t_num)[None, :], slots - leaves]
    acc = torch.zeros(vals.shape[0], dtype=torch.float32)
    out = []
    for j in range(t_num):
        acc = acc + vals[:, j]
        out.append(acc)
    return torch.stack(out, 1)


@pytest.mark.parametrize("angle_idx,mode", ANGLE_MODES)
@pytest.mark.parametrize("depth,trees", [(6, 80), (4, 37)])
def test_schedule_fails_at_chunk_edges(depth, trees, angle_idx, mode):
    """Thresholds that never fail except at the first, a middle and the
    last tree of phase 2's rounds (trees K, K+15, K+31, K+32, K+63 where
    the forest has them, K the mode's phase-1 length), each set to fail
    about a third of the windows alive there: at each such tree some
    windows fail and some survive it, and the schedule matches the plain
    version."""
    (codes, preds, _), frames, base, scale = make_case(7 * depth + trees,
                                                       depth, trees)
    k, limits = mode_limits(mode, trees, K + 1, KB + 1, 33, 64, trees)
    edges = [t for t in (k, k + 15, k + 31, k + 32, k + 63) if t < trees]
    sums = running_sums(frames, base, scale, codes, preds, angle_idx)
    thresh = torch.full((trees,), NEVER, dtype=torch.float32)
    alive = torch.ones(sums.shape[0], dtype=torch.bool)
    for t in edges:
        thresh[t] = torch.quantile(sums[alive, t].double(), 0.33).float()
        fails = alive & (sums[:, t] <= thresh[t])
        assert 0 < int(fails.sum()) < int(alive.sum()), t
        alive &= ~fails
    forest = (codes, preds, thresh)
    for t_limit in limits:
        check_both(forest, frames, base, scale, t_limit, angle_idx,
                   prefix=mode == "prefix")
    for t in edges:
        before = face_dense.classify_windows(frames, base, scale, *forest, t,
                                             angle_idx=angle_idx)
        after = face_dense.classify_windows(frames, base, scale, *forest,
                                            t + 1, angle_idx=angle_idx)
        assert 0 < int((after != -1.0).sum()) < int((before != -1.0).sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("angle_idx", [0, 2])
def test_schedule_never_failing_forest(angle_idx, mode):
    """Thresholds that never fail: every window goes to phase 2 and walks
    every tree; scores and finish equal the plain version's."""
    forest, frames, base, scale = make_case(5, 6, 80, thresh=NEVER)
    _, limits = mode_limits(mode, 80, 80, 64, 36, K + 1, KB + 1)
    for t_limit in limits:
        q = check_both(forest, frames, base, scale, t_limit, angle_idx,
                       prefix=mode == "prefix")
        assert bool((q != -1.0).all())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 2, 8])
def test_schedule_other_phase1_lengths(k, mode):
    """The schedule is exact for any phase-1 length, not only the
    committed one."""
    forest, frames, base, scale = make_case(11, 6, 80)
    for t_limit in mode_limits(mode, 80, 1, k, k + 1, 33, 80)[1]:
        check_both(forest, frames, base, scale, t_limit, 0, k,
                   prefix=mode == "prefix")


def test_emulation_matches_the_sources():
    """The layout and schedule the emulation assumes are the sources': the
    swizzle mask (face_walk.cuh), kernel B's staging through it and its
    schedule constants (face_prefix.cu), a round of one tree per lane."""
    walk = read_source("face_walk.cuh")
    prefix = read_source("face_prefix.cu")
    assert ("return (((t & 15) << 1) | ((t >> 4) & 1)) & ((1 << depth) - 1);"
            in walk)
    assert "idx ^ (m >> 1)" in walk and "(m & 1) ? make_int2(v.y, v.x)" in walk
    assert ("(t << depth) + ((k & (leaves - 1)) ^ pigo::swizzle(t, depth))"
            in prefix)
    assert re.search(r"classify_block<kPrefixThreads, kPrefixWindows,"
                     r"\s*kPrefixPhase1Trees,\s*kPrefixDenseItems", prefix)
    assert "pigo::SwizzledForest{s_codes, s_preds, s_thresh, depth}" in prefix
    assert ROUND == 32  # one tree a lane
    assert 1 <= KB < 32 and 1 <= K < 32


@pytest.mark.parametrize("depth", [4, 6, 8])
def test_swizzle_spreads_shared_memory_banks(depth):
    """Kernel B's shared-memory layout: read back through SwizzledTables it
    gives every node, children pair and leaf of the forest; the 32 lanes of
    a warp reading the same node (or leaf) of 32 consecutive trees hit 32
    distinct 4-byte banks (from depth 5 up; unswizzled, one bank), a
    half-warp's 8-byte pair reads distinct bank pairs, and one tree's nodes
    of a level (phase 1) distinct banks."""
    leaves = 1 << depth
    t_num = 70
    rng = np.random.default_rng(depth)
    codes = torch.from_numpy(rng.integers(-128, 128, (t_num, leaves, 4),
                                          dtype=np.int8))
    preds = torch.from_numpy(rng.standard_normal((t_num, leaves),
                                                 dtype=np.float32))
    tables = SwizzledTables.stage(codes, preds, t_num)
    t = torch.arange(t_num)[:, None]
    k = torch.arange(leaves)[None, :]
    assert torch.equal(tables.node(t, k), codes)
    assert torch.equal(tables.leaf(t, k), preds)
    idx = torch.arange(leaves // 2)[None, :]
    assert torch.equal(tables.kids(t, idx),
                       codes.reshape(t_num, leaves // 2, 2, 4))
    slot = tables._slot(t, k)  # [T, L] 4-byte slots
    assert bool((slot % 2 == k % 2).eq(swizzle(t, depth) % 2 == 0).all())
    for t0 in range(t_num - 31):
        warp = slot[t0:t0 + 32]  # [32, L]: node k of 32 trees
        banks = warp % 32
        if depth >= 5:
            assert bool((banks.sort(0).values
                         == torch.arange(32)[:, None]).all()), t0
            assert len(set(((t0 + torch.arange(32)) * leaves % 32)
                           .tolist())) == 1  # unswizzled: one bank
        pairs = torch.minimum(warp[:, 0::2], warp[:, 1::2]) // 2
        for half in (pairs[:16], pairs[16:]):
            if depth >= 5:
                assert bool((half % 16).sort(0).values.eq(
                    torch.arange(16)[:, None]).all()), t0
    for d in range(min(depth, 6)):
        level = slot[:, 1 << d:2 << d] % 32
        assert bool((level.sort(1).values.diff(dim=1) > 0).all())


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
    """face_sweep builds each variant's two libraries from a copy of csrc/
    with the named constants set wherever one source or header defines
    them (kernel A's and B's schedules, the walk's block), and refuses a
    constant no source has."""
    from pigo_tpu_torch.tools import face_sweep

    monkeypatch.setattr(face_sweep, "SWEEP_DIR", str(tmp_path))
    csrc = os.path.dirname(SOURCE)
    consts = {"kPhase1Trees": 9, "kThreads": 128, "kPrefixPhase1Trees": 6,
              "kPrefixDenseEighths": 5, "kRoundTrees": 32,
              "kWarpsPerBlock": 16}
    paths = face_sweep.variant_sources("v", consts, csrc)
    assert {k: [os.path.basename(p) for p in v] for k, v in paths.items()} \
        == {"face_cascade": ["face_cascade.cu", "face_prefix.cu"],
            "pupil_walk": ["pupil_walk.cu"]}
    texts = {}
    for name in ("face_cascade.cu", "face_prefix.cu", "face_walk.cuh",
                 "pupil_walk.cu"):
        with open(os.path.join(tmp_path, "v", name)) as fh:
            texts[name] = fh.read()
    assert "constexpr int kPhase1Trees = 9;" in texts["face_cascade.cu"]
    assert "constexpr int kThreads = 128;" in texts["face_cascade.cu"]
    assert ("constexpr int kPrefixPhase1Trees = 6;"
            in texts["face_prefix.cu"])
    assert ("constexpr int kPrefixDenseEighths = 5;"
            in texts["face_prefix.cu"])
    assert "constexpr int kRoundTrees = 32;" in texts["face_walk.cuh"]
    assert "constexpr int kWarpsPerBlock = 16;" in texts["pupil_walk.cu"]
    with open(SOURCE) as fh:  # the checkout's source is untouched
        assert f"constexpr int kPhase1Trees = {K};" in fh.read()
    with pytest.raises(RuntimeError, match="kNoSuch"):
        face_sweep.variant_sources("w", {"kNoSuch": 1}, csrc)
    plain = face_sweep.variant_sources("x", None, csrc)
    assert plain["face_cascade"][0] == SOURCE
    assert plain["pupil_walk"] == [os.path.join(csrc, "pupil_walk.cu")]
