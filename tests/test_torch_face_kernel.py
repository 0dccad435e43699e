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
        q, evals = face_dense.cascade_with_work(*args, t)
        if t > 1:
            # trees 1..t-1 saw every window still alive before tree t
            assert evals - total == int((q_prev != -1.0).sum())
        total, q_prev = evals, q
    assert total >= frames.shape[0] * plan.num_windows


def test_wrapper_cpu_runs_plain_without_launch():
    forest = random_forest(6)
    frames = np.random.default_rng(6).integers(0, 256, (2, 40, 50),
                                               dtype=np.uint8)
    cfg = dict(min_size=10, max_size=40, shift_factor=0.2, scale_factor=1.2)
    before = face_cuda.face_cascade_launches
    got = port_scores(forest, frames, cfg)
    assert face_cuda.face_cascade_launches == before  # no kernel on the CPU
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
