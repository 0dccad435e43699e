"""The port's rotated pyramid against the JAX package.

The plain rotated classifier (pigo_tpu_torch.ops.face_dense, run by the
kernel wrappers on CPU tensors) against
pigo_tpu.ops.face_dense.classify_windows_rotated on wide, tall and
strided tall frames; FaceCascade(device="cpu") against both frozen
rotation angles of every golden tag; the angle sweep; and FaceDetector at
an angle against the golden corpus and the JAX package's post stage run
op by op. Inputs come from the repository's assets or from numpy with
fixed seeds and cross as numpy arrays. Exact equality is the tolerance
throughout: both sides do the same integer math and the same sequence of
f32 adds.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigo_tpu.cascade.format import FaceForest as JaxForest
from pigo_tpu.ops import face_dense as jax_dense
from pigo_tpu.ops import windows as jax_windows
from pigo_tpu_torch import FaceCascade, FaceDetector, cluster_detections
from pigo_tpu_torch import detector as port_det
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.detector import CascadeParams, Detection, ImageParams
from pigo_tpu_torch.ops import face_cuda, face_dense, windows
from test_torch_face_kernel import (  # noqa: F401 (autouse fixture)
    one_torch_thread, random_forest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
ALL_TAGS = ["sample", "test", "sample_dense", "wide", "strided", "alpha"]
CFG = (10, 40, 0.1, 1.2)


def _golden(tag):
    with open(os.path.join(GOLDEN_DIR, tag + ".json")) as fh:
        return json.load(fh)


def _cfg(golden):
    c = golden["config"]
    return dict(min_size=c["min_size"], max_size=c["max_size"],
                shift_factor=c["shift_factor"], scale_factor=c["scale_factor"])


def jax_rotated(forest: JaxForest, pix: np.ndarray, rows, cols, dim, angle):
    """pigo_tpu.ops.face_dense.classify_windows_rotated over the pyramid
    of a frame pix (flat, row stride dim)."""
    codes_p, preds_p, thresh_p, t_pad = jax_dense.pad_trees(forest)
    padded = JaxForest(forest.depth, codes_p, preds_p, thresh_p)
    plan = jax_windows.build_window_plan(padded, rows, cols, dim, *CFG,
                                         angle=angle)
    q = jax_dense.classify_windows_rotated(
        jnp.asarray(pix), jnp.asarray(plan.rows_w), jnp.asarray(plan.cols_w),
        jnp.asarray(plan.scale_idx), jnp.asarray(plan.rot),
        jnp.asarray(preds_p), jnp.asarray(thresh_p),
        jnp.float32(forest.thresh[forest.num_trees - 1]),
        depth=forest.depth, num_leaves=forest.num_leaves, t_pad=t_pad,
        nrows=rows, dim=dim)
    return np.asarray(q)[:plan.num_windows]


def port_rotated(forest, pix, rows, cols, dim, angle_idx, t_limit):
    """The port's wrapper on CPU tensors (-> the plain version) over the
    same pyramid, reading the frame through its stride."""
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    plan = windows.build_window_plan(rows, cols, *CFG)
    base, scale = face_cuda.device_plan(plan, torch.device("cpu"))
    frames = torch.from_numpy(pix.reshape(1, rows, dim))
    return face_cuda.face_cascade(
        frames, base, scale, ft.codes, ft.preds, ft.thresh, t_limit,
        angle_idx=angle_idx, cols=cols)[0].numpy()


FRAMES = {
    # name: (rows, cols, dim); wide frames clamp columns at nrows-1 < cols,
    # tall ones wrap clamped columns into the next row
    "wide": (64, 80, 80),
    "tall": (90, 40, 40),
    "tall_strided": (90, 40, 53),
}


@pytest.mark.parametrize("kind", sorted(FRAMES))
def test_plain_rotated_matches_jax(kind):
    """At angles 0.07, 0.125 and 0.25 the port's rotated scores equal
    classify_windows_rotated's, for the whole random forest and with a
    tree limit of 8 (against the JAX classifier with every threshold past
    tree 8 at -inf: -1 where it rejects, PREFIX_MARK where it does not).
    On the strided tall
    frame the pad bytes are read (two pads give different scores), as the
    reference reads them."""
    rows, cols, dim = FRAMES[kind]
    forest = random_forest(21, depth=3, trees=24, thresh=-1.5)
    # the first 8 trees' verdicts: trees 8.. can no longer fail a window
    head = JaxForest(forest.depth, forest.codes, forest.preds,
                     np.where(np.arange(24) < 8, forest.thresh, -np.inf
                              ).astype(np.float32))
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (rows, dim), dtype=np.uint8)
    pads = [img]
    if dim > cols:
        zero_pad = img.copy()
        zero_pad[:, cols:] = 0
        pads.append(zero_pad)
    by_pad = []
    for frame in pads:
        pix = frame.reshape(-1)
        for angle in (0.07, 0.125, 0.25):
            a = int(32 * angle)
            want = jax_rotated(forest, pix, rows, cols, dim, angle)
            got = port_rotated(forest, pix, rows, cols, dim, a,
                               forest.num_trees)
            assert got.dtype == np.float32 and np.array_equal(got, want)
            assert (got == -1.0).any() and (got > 0.0).any()
            by_pad.append(got)
            want8 = jax_rotated(head, pix, rows, cols, dim, angle)
            got8 = port_rotated(forest, pix, rows, cols, dim, a, 8)
            assert np.array_equal(got8 == -1.0, want8 == -1.0)
            assert np.all(got8[got8 != -1.0] == face_dense.PREFIX_MARK)
    if dim > cols:
        assert any(not np.array_equal(x, y)
                   for x, y in zip(by_pad[:3], by_pad[3:]))


@pytest.mark.parametrize("tag", ALL_TAGS)
def test_golden_rotations(tag):
    """FaceCascade(device="cpu") in the default mode reproduces the frozen
    detections at both rotation angles (0.07, 0.125) of every golden tag;
    strided is the 400x320 frame with row stride 357, whose rotated pass
    reads through the stride."""
    from pigo_tpu.tools.make_golden import fixture_frame

    golden = _golden(tag)
    gray, rows, cols, dim = fixture_frame(golden["image"])
    fc = FaceCascade(device="cpu")
    assert [r["angle"] for r in golden["rotations"]] == [0.07, 0.125]
    for rot in golden["rotations"]:
        dets = fc.run_cascade(gray, rows, cols, dim, angle=rot["angle"],
                              **_cfg(golden))
        want = np.asarray(rot["detections"], np.float64).reshape(-1, 4)
        assert dets.dtype == np.float64 and np.array_equal(dets, want)


def test_sweep_matches_per_angle(sample_gray):
    """run_cascade_sweep equals run_cascade at each angle (a negative
    angle runs upright), tagged with the angle; detect_sweep clusters
    it."""
    fc = FaceCascade(device="cpu")
    rows, cols = sample_gray.shape
    cfg = _cfg(_golden("sample"))
    angles = (0.07, -0.5)
    got = fc.run_cascade_sweep(sample_gray, rows, cols, angles, **cfg)
    parts = []
    for a in angles:
        dets = fc.run_cascade(sample_gray, rows, cols, angle=a, **cfg)
        parts.append(np.concatenate(
            [dets, np.full((dets.shape[0], 1), max(a, 0.0))], axis=1))
    want = np.concatenate(parts)
    assert got.shape == want.shape and got.shape[1] == 5
    assert np.array_equal(got, want) and (got[:, 4] == 0.07).any()
    assert np.array_equal(
        fc.detect_sweep(sample_gray, rows, cols, angles, **cfg),
        cluster_detections(want[:, :4], 0.01))
    assert fc.run_cascade_sweep(sample_gray, rows, cols, []).shape == (0, 5)


def test_detector_rotated_matches_golden(sample_gray):
    """FaceDetector's faces at angle 0.07 equal the golden rotations[0]
    detections clustered at IoU 0.1, on the sample and on the strided tall
    frame; there the eye and landmark walks read the strided frame the
    face stage uploaded and equal fused_post over the contiguous frame."""
    from pigo_tpu.tools.make_golden import fixture_frame

    det = FaceDetector(device="cpu")
    for tag in ("sample", "strided"):
        golden = _golden(tag)
        gray, rows, cols, dim = fixture_frame(golden["image"])
        img = ImageParams(pixels=gray.reshape(-1), rows=rows, cols=cols,
                          dim=dim)
        params = CascadeParams(**_cfg(golden))
        want = [Detection(int(r), int(c), int(s), float(q))
                for r, c, s, q in cluster_detections(
                    np.asarray(golden["rotations"][0]["detections"]), 0.1)]
        assert want
        assert det.detect_faces(img, params=params, angle=0.07,
                                iou_threshold=0.1) == want
    # the strided frame's post stage against the contiguous frame's
    res = det.detect(img, params=params, angle=0.07, iou_threshold=0.1,
                     perturbs=15)
    eyed = [r for r in res if r.face.scale > port_det.MIN_EYE_FACE_SCALE]
    assert eyed
    u_eyes, u_lmk = det._uniforms(len(eyed), 15,
                                  torch.Generator().manual_seed(0), None)
    anchors = torch.from_numpy(port_det.eye_anchors([r.face for r in eyed]))
    cids, flips = det.landmarks.schedule_arrays(len(eyed))
    contiguous = gray.reshape(rows, dim)[:, :cols].reshape(-1)
    out = port_det.fused_post(
        *anchors.T.contiguous(), torch.from_numpy(contiguous.copy()),
        det.pupil.tensors, det.landmarks.tensors, u_eyes, u_lmk,
        torch.from_numpy(cids), torch.from_numpy(flips), rows=rows,
        cols=cols, dim=cols, angle=0.07).numpy()
    for i, r in enumerate(eyed):
        assert [(e.row, e.col) for e in r.eyes] == [
            (int(out[0, 2 * i + k]), int(out[1, 2 * i + k])) for k in (0, 1)]
        assert len(r.landmarks) == 15


def test_fused_post_rotated_matches_jax(sample_gray):
    """fused_post's eyes at angle 0.07 against the JAX package's eye
    ensemble (pigo_tpu.ops.pupil_dense._ensemble_impl, which
    pigo_tpu.detector._fused_post_impl runs for the eyes) run op by op
    with rotated=True, bit for bit on every median; upright eyes differ."""
    from pigo_tpu import detector as jax_det
    from pigo_tpu.ops import pupil_dense as jax_pupil

    jdet = jax_det.FaceDetector(face=object(), with_landmarks=False)
    det = FaceDetector(device="cpu", with_landmarks=False)
    rows, cols = sample_gray.shape
    faces = [Detection(206, 154, 261, 9.0), Detection(150, 200, 120, 9.0)]
    erow, ecol, escale = port_det.eye_anchors(faces).T
    pg = jdet.pupil.forest
    u = np.random.default_rng(4).random((4, 15, 3), dtype=np.float32)
    want = jax_pupil._ensemble_impl(
        jdet.pupil.codes, jdet.pupil.preds, jnp.zeros(4, jnp.int32),
        *(jnp.asarray(v) for v in (erow, ecol, escale)),
        jnp.zeros(4, bool), jnp.asarray(u),
        jnp.asarray(sample_gray.reshape(-1)), stages=pg.stages,
        trees=pg.trees, depth=pg.depth, nrows=rows, ncols=cols, dim=cols,
        scale_mult=float(pg.scale_mult), rotated=True, angle_idx=2)

    def eyes(angle):
        return port_det.fused_post(
            *(torch.from_numpy(np.ascontiguousarray(v))
              for v in (erow, ecol, escale)),
            torch.from_numpy(sample_gray.reshape(-1)), det.pupil.tensors,
            None, torch.from_numpy(u), None, None, None, rows=rows,
            cols=cols, dim=cols, angle=angle)

    got = eyes(0.07)
    assert got.shape == (3, 4)
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    assert not torch.equal(eyes(0.0), got)
