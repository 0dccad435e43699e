"""The port's cascade kernel module against the JAX package.

pigo_tpu_torch.ops: the window plan, the plain PyTorch classifier
(face_dense) and the kernel wrapper (face_cuda). On the CPU the wrapper runs
the plain version, so these tests hold the plain version bit for bit
against the JAX package's jnp gather classifier and its Pallas kernel
(interpret mode). Inputs are made with numpy from fixed seeds and cross as
numpy arrays. Exact equality is the tolerance throughout: both sides do the
same integer math and the same sequence of f32 adds.

The kernel itself against the plain version on the card is in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pigo_tpu.cascade.format import FaceForest as JaxForest
from pigo_tpu.ops import face_dense as jax_dense
from pigo_tpu.ops import windows as jax_windows
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.ops import face_cuda, face_dense, windows
from pigo_tpu_torch.utils import build


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, restored after them; the
    other test_torch_*.py modules import this fixture. The plain versions
    run many small tensor ops, whose time is dispatch, not arithmetic, so
    extra threads do not speed them up; under a parallel test run (one
    worker process per core) they only oversubscribe the cores the other
    workers need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SAMPLE_CFG = dict(min_size=20, max_size=1000, shift_factor=0.1,
                  scale_factor=1.1)


def random_forest(seed: int, depth: int = 3, trees: int = 16,
                  thresh: float = -1.5) -> JaxForest:
    """A random forest (JAX package's type) whose soft cascade rejects
    windows at every tree and lets some survive the whole forest."""
    rng = np.random.default_rng(seed)
    leaves = 1 << depth
    codes = rng.integers(-128, 128, (trees, leaves, 4)).astype(np.int8)
    codes[:, 0] = 0
    preds = rng.uniform(-1.0, 1.0, (trees, leaves)).astype(np.float32)
    return JaxForest(depth=depth, codes=codes, preds=preds,
                     thresh=np.full(trees, thresh, np.float32))


def jax_scores(forest: JaxForest, frame: np.ndarray, cfg: dict) -> np.ndarray:
    """pigo_tpu.ops.face_dense.classify_windows over the upright pyramid."""
    codes_p, preds_p, thresh_p, t_pad = jax_dense.pad_trees(forest)
    padded = JaxForest(forest.depth, codes_p, preds_p, thresh_p)
    rows, cols = frame.shape
    plan = jax_windows.build_window_plan(
        padded, rows, cols, cols, cfg["min_size"], cfg["max_size"],
        cfg["shift_factor"], cfg["scale_factor"])
    q = jax_dense.classify_windows(
        jnp.asarray(frame.ravel()), jnp.asarray(plan.base),
        jnp.asarray(plan.scale_idx), jnp.asarray(plan.off1),
        jnp.asarray(plan.off2), jnp.asarray(preds_p), jnp.asarray(thresh_p),
        jnp.float32(forest.thresh[forest.num_trees - 1]),
        depth=forest.depth, num_leaves=forest.num_leaves, t_pad=t_pad)
    return np.asarray(q)[: plan.num_windows]


def port_scores(forest, frames: np.ndarray, cfg: dict,
                t_limit: int | None = None) -> np.ndarray:
    """The port's wrapper on CPU tensors (-> the plain version): [B, W]."""
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    _, rows, cols = frames.shape
    plan = windows.build_window_plan(rows, cols, **cfg)
    base, scale = face_cuda.device_plan(plan, torch.device("cpu"))
    return face_cuda.face_cascade(
        torch.from_numpy(frames), base, scale, ft.codes, ft.preds, ft.thresh,
        t_limit or ft.num_trees).numpy()


def test_window_plan_matches_jax(face_forest):
    rows, cols = 400, 320
    plan = windows.build_window_plan(rows, cols, **SAMPLE_CFG)
    jplan = jax_windows.build_window_plan(
        face_forest, rows, cols, cols, *SAMPLE_CFG.values())
    n = jplan.num_windows
    assert plan.num_windows == n == 218449
    assert np.array_equal(plan.base, jplan.base[:n])
    assert np.array_equal(plan.scale_idx, jplan.scale_idx[:n])
    assert np.array_equal(plan.rows_w, jplan.rows_w[:n])
    assert np.array_equal(plan.cols_w, jplan.cols_w[:n])
    assert np.array_equal(plan.scales, jplan.scales)
    assert np.array_equal(plan.scale_w, jplan.scales[jplan.scale_idx[:n]])
    # the node offsets the kernel and the plain version compute from the
    # int8 codes equal the JAX plan's per-scale tables
    c = face_forest.codes.astype(np.int64)[None]
    d = (c * plan.scales.astype(np.int64)[:, None, None, None]) >> 8
    assert np.array_equal(d[..., 0] * cols + d[..., 1], jplan.off1)
    assert np.array_equal(d[..., 2] * cols + d[..., 3], jplan.off2)


def test_window_plan_empty_when_frame_too_small():
    plan = windows.build_window_plan(10, 10, **SAMPLE_CFG)
    assert plan.num_windows == 0 and plan.scales.size == 0


@pytest.mark.parametrize("forest_kind", ["random", "facefinder"])
def test_plain_matches_jax_classify(forest_kind, face_forest, sample_gray):
    rng = np.random.default_rng(11)
    if forest_kind == "random":
        forest = random_forest(3)
        cfg = dict(min_size=10, max_size=60, shift_factor=0.1,
                   scale_factor=1.2)
        frames = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
    else:
        forest = face_forest
        cfg = dict(min_size=20, max_size=200, shift_factor=0.1,
                   scale_factor=1.1)
        crop = sample_gray[100:340, 40:280]
        frames = np.stack([crop, rng.integers(0, 256, crop.shape,
                                              dtype=np.uint8)])
    got = port_scores(forest, frames, cfg)
    for frame, q in zip(frames, got):
        want = jax_scores(forest, frame, cfg)
        assert q.dtype == np.float32 and q.shape == want.shape
        assert np.array_equal(q, want)
    # the inputs exercise both outcomes: rejected and surviving windows
    assert (got == -1.0).any() and (got > 0.0).any()


@pytest.mark.parametrize("tree_cap", [0, 32])
def test_plain_matches_pallas_interpret(tree_cap, monkeypatch):
    """One dense scale through the Pallas TPU kernel (interpret mode), as
    tests/test_face_kernels.py runs it, uncapped and capped at 32 trees
    (survivors -> PREFIX_MARK). A random depth-3, 40-tree forest keeps the
    interpret-mode compile short; some windows fail between trees 32
    and 40, so the capped and uncapped results differ."""
    from pigo_tpu.ops import face_pallas as fp

    monkeypatch.setenv("PIGO_TPU_TAIL_MIN_WINDOWS", "0")
    monkeypatch.setenv("PIGO_TPU_HOST_SHARE", "0")
    forest = random_forest(5, depth=3, trees=40)
    frame = np.random.default_rng(5).integers(0, 256, (60, 70),
                                              dtype=np.uint8)
    rows, cols = frame.shape
    cfg = dict(min_size=20, max_size=20, shift_factor=0.1, scale_factor=1.1)
    plan = fp.build_dense_plan(forest, rows, cols, 20, 20, 0.1, 1.1,
                               prefix=False, tree_cap=tree_cap)
    (sp,) = plan.scales
    assert not sp.fallback and sp.tree_cap == tree_cap
    want = np.asarray(fp.scale_scores(
        jnp.asarray(frame, jnp.float32), sp, forest,
        jnp.asarray(sp.tables.reshape(-1)),
        jnp.asarray(forest.preds.reshape(-1)), jnp.asarray(forest.thresh),
        interpret=True)).reshape(-1)
    got = port_scores(forest, frame[None], cfg, tree_cap or None)[0]
    assert np.array_equal(got, want)
    full = port_scores(forest, frame[None], cfg)[0]
    if tree_cap:
        marked = got == face_dense.PREFIX_MARK
        assert marked.any()
        # a mark is a window alive after 32 trees; some die later
        assert ((full > 0.0) | (full == -1.0))[marked].all()
        assert (full[marked] == -1.0).any()
        assert np.array_equal(got[~marked], full[~marked])
    else:
        assert np.array_equal(got, full)


def test_work_count_matches_alive_windows():
    """cascade_with_work counts one evaluation per alive window per tree."""
    forest = random_forest(4, depth=2, trees=6)
    frames = np.random.default_rng(4).integers(0, 256, (2, 30, 30),
                                               dtype=np.uint8)
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    plan = windows.build_window_plan(30, 30, 10, 20, 0.2, 1.3)
    args = (torch.from_numpy(frames), torch.from_numpy(plan.base),
            torch.from_numpy(plan.scale_w), ft.codes, ft.preds, ft.thresh)
    total = 0
    for t in range(1, 7):
        q, work = face_dense.cascade_with_work(*args, t)
        evals = work["evaluations"]
        if t > 1:
            # trees 1..t-1 saw every window still alive before tree t
            assert evals - total == int((q_prev != -1.0).sum())
        total, q_prev = evals, q
    assert total >= frames.shape[0] * plan.num_windows


def _reads(frames, pairs, base, scale, cols, forest, t_limit, angle_idx):
    """What the soft cascade reads for the (frame, window) pairs, one by one
    in plain Python (the reference loop, core/pigo.go:113-191): the distinct
    flat pixels, (tree, node) code words and (tree, leaf) leaves, the trees
    evaluated and the tree evaluations."""
    from pigo_tpu_torch.ops.pupil_dense import QCOS_TABLE, QSIN_TABLE

    _, nrows, dim = frames.shape
    leaves = forest.preds.shape[1]
    pixels, words, leaf_set, trees, evals = set(), set(), set(), set(), 0
    for f, w in pairs:
        r, c = divmod(int(base[w]), cols)
        s = int(scale[w])
        qc, qs = s * QCOS_TABLE[angle_idx], s * QSIN_TABLE[angle_idx]
        out = np.float32(0.0)
        for t in range(t_limit):
            trees.add(t)
            evals += 1
            idx = 1
            for _ in range(forest.depth):
                words.add((t, idx))
                at = []
                for cr, cc in np.asarray(forest.codes[t, idx],
                                         np.int64).reshape(2, 2):
                    if angle_idx:
                        rr = min(nrows - 1,
                                 max(0, r * 65536 + qc * cr - qs * cc)
                                 >> 16)
                        rc = min(nrows - 1,
                                 max(0, c * 65536 + qs * cr + qc * cc)
                                 >> 16)
                        at.append(min(rr * dim + rc, nrows * dim - 1))
                    else:
                        at.append((r + ((cr * s) >> 8)) * dim
                                  + c + ((cc * s) >> 8))
                at = [f * nrows * dim + a for a in at]
                pixels.update(at)
                p1, p2 = frames.reshape(-1)[at]
                idx = 2 * idx + int(p1 <= p2)
            leaf_set.add((t, idx - leaves))
            out = np.float32(out + forest.preds[t, idx - leaves])
            if out <= forest.thresh[t]:
                break
    return {"evaluations": evals, "trees": len(trees), "pixels": len(pixels),
            "code_words": len(words), "leaves": len(leaf_set)}


@pytest.mark.parametrize("angle_idx", [0, 4])
def test_work_counts_what_the_cascade_reads(angle_idx):
    """cascade_with_work and finish_with_work count (chip_smoke.py's byte
    bound) the distinct pixels, code words and leaves that the reference
    loop reads, over the whole batch, and fewer pixels than the frames
    hold; neither changes the scores."""
    forest = random_forest(9, depth=3, trees=12)
    frames = np.random.default_rng(9).integers(0, 256, (2, 36, 40),
                                               dtype=np.uint8)
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    plan = windows.build_window_plan(36, 40, 10, 30, 0.3, 1.3)
    args = (torch.from_numpy(frames), torch.from_numpy(plan.base),
            torch.from_numpy(plan.scale_w), ft.codes, ft.preds, ft.thresh)
    kw = dict(angle_idx=angle_idx)
    tables = (plan.base, plan.scale_w, 40, forest)
    q, work = face_dense.cascade_with_work(*args, 6, **kw)
    every = [(f, w) for f in range(2) for w in range(plan.num_windows)]
    assert work == _reads(frames, every, *tables, 6, angle_idx)
    assert 0 < work["pixels"] < frames.size
    assert torch.equal(q, face_dense.classify_windows(*args, 6, **kw))
    marked = q == face_dense.PREFIX_MARK
    assert marked.any() and (q == -1.0).any()
    full = face_dense.classify_windows(*args, 12, **kw)
    fin, fwork = face_dense.finish_with_work(*args, q.clone(), **kw)
    assert torch.equal(fin, full)
    marks = torch.nonzero(marked).tolist()
    assert fwork == _reads(frames, marks, *tables, 12, angle_idx)


def test_wrapper_cpu_runs_plain_without_launch():
    forest = random_forest(6)
    frames = np.random.default_rng(6).integers(0, 256, (2, 40, 50),
                                               dtype=np.uint8)
    cfg = dict(min_size=10, max_size=40, shift_factor=0.2, scale_factor=1.2)
    before = build.LAUNCHES["face_cascade"]
    got = port_scores(forest, frames, cfg)
    assert build.LAUNCHES["face_cascade"] == before  # no kernel on the CPU
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    plan = windows.build_window_plan(40, 50, **cfg)
    want = face_dense.classify_windows(
        torch.from_numpy(frames), torch.from_numpy(plan.base),
        torch.from_numpy(plan.scale_w), ft.codes, ft.preds, ft.thresh,
        ft.num_trees).numpy()
    assert np.array_equal(got, want)


def test_wrapper_rejects_bad_inputs():
    forest = random_forest(7)
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    frames = torch.zeros((1, 40, 40), dtype=torch.uint8)
    base = torch.full((3,), 20 * 40 + 20, dtype=torch.int32)
    scale = torch.full((3,), 10, dtype=torch.int32)
    ok = (frames, base, scale, ft.codes, ft.preds, ft.thresh, 16)
    assert face_cuda.face_cascade(*ok).shape == (1, 3)
    bad = [
        (frames.float(),) + ok[1:],
        (frames[0],) + ok[1:],
        ok[:1] + (base.long(),) + ok[2:],
        ok[:2] + (scale[:2],) + ok[3:],
        ok[:3] + (ft.codes.to(torch.int32),) + ok[4:],
        ok[:4] + (ft.preds.double(),) + ok[5:],
        ok[:5] + (ft.thresh[:-1],) + ok[6:],
        ok[:6] + (0,),
        ok[:6] + (17,),
        (frames.to("meta"),) + ok[1:],
        (frames.transpose(1, 2),) + ok[1:],
    ]
    for args in bad:
        with pytest.raises(ValueError):
            face_cuda.face_cascade(*args)


def test_convert_validates_forest():
    forest = random_forest(8)
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    assert ft.num_trees == 16 and ft.codes.dtype == torch.int8
    assert np.array_equal(ft.codes.numpy(), forest.codes)
    with pytest.raises(ValueError):
        face_forest_from_numpy(4, forest.codes, forest.preds, forest.thresh)
    with pytest.raises(ValueError):
        face_forest_from_numpy(3, forest.codes, forest.preds.astype(np.float64),
                               forest.thresh)


def test_build_names_library_by_source_and_flags(tmp_path, monkeypatch):
    """An edited source or changed flags never load a stale library."""
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    src = tmp_path / "k.cu"
    src.write_text("// a")
    paths = [build.library_path("k")]
    src.write_text("// b")
    paths.append(build.library_path("k"))
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    paths.append(build.library_path("k"))
    assert len(set(paths)) == 3
    assert all(p.startswith(build.BUILD_DIR) for p in paths)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing toolkit is an error at the first launch, never a silent
    fall back to the plain version."""
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    (tmp_path / "k.cu").write_text("// k")
    monkeypatch.setattr(build.os.path, "isfile", lambda path: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("k", lambda lib: None)
    assert "k" not in build._libs


def test_recording_counts_only_its_own_threads_launches():
    """Within build.recording() this thread's launches count into its
    recorder (a nested one keeps its own), another thread's into LAUNCHES;
    outside it they count into LAUNCHES, as a CUDA graph's replay adds
    what its capture recorded."""
    import collections
    import threading

    before = build.LAUNCHES.copy()
    with build.recording() as outer:
        build.count("face_cascade")
        with build.recording() as inner:
            build.count("pupil_walk", 2)
        other = threading.Thread(target=build.count,
                                 args=("cluster_device",))
        other.start()
        other.join(60)
        build.count("face_cascade")
    assert not other.is_alive()
    assert dict(outer) == {"face_cascade": 2}
    assert dict(inner) == {"pupil_walk": 2}
    assert build.LAUNCHES - before == collections.Counter(cluster_device=1)
    for kernel, n in outer.items():
        build.count(kernel, n)
    assert build.LAUNCHES - before == collections.Counter(
        cluster_device=1, face_cascade=2)


def test_launch_tally_loses_no_update_across_threads():
    """Threads counting at once, switched every few microseconds, lose
    no launch in LAUNCHES."""
    import os
    import sys
    import threading

    threads, each = min(2 * (os.cpu_count() or 1) + 1, 64), 5000
    before = build.LAUNCHES["face_cascade"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            build.count("face_cascade") for _ in range(each)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert build.LAUNCHES["face_cascade"] == before + threads * each
