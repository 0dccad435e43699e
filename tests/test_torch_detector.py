"""The port's FaceDetector (face -> eyes -> landmarks) against the JAX
package.

pigo_tpu_torch.detector on the CPU (every kernel wrapper then runs its
plain PyTorch version) against pigo_tpu.detector: the fused post stage,
`detect` in the full, pupils-only and faces-only configurations, the JSON
helpers, and `detect_stream` against per-frame `detect`. The JAX package
draws its jitter with jax.random, the port with a torch.Generator, so the
tests reproduce the JAX uniforms (split(key) -> k_post -> split ->
uniform, pigo_tpu/detector.py:650-661, 187-208) and pass them in through
`uniforms=`. The tolerance is equality of the JSON payloads, and of every
f32 against the post stage run op by op; against the jitted JAX pipeline
the f32 scales agree within 1e-5 relative (XLA folds the scale_mult chain,
ROADMAP.md queue 3; tests/test_torch_pupil.py has the details).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigo_tpu import detector as jax_det
from pigo_tpu.models.face import FaceCascade as JaxFaceCascade
from pigo_tpu_torch import FaceCascade, FaceDetector, PupilLocalizer
from pigo_tpu_torch import detector as port_det
from pigo_tpu_torch.detector import CascadeParams, ImageParams
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(min_size=60, max_size=400, shift_factor=0.3, scale_factor=1.3)
P = 15


@pytest.fixture(scope="module")
def det():
    return FaceDetector(device="cpu")


@pytest.fixture(scope="module")
def jax_face(face_forest):
    return JaxFaceCascade(face_forest, backend="reference")


def _jax_uniforms(key, f, landmarks=True):
    """The uniforms pigo_tpu's FaceDetector.detect draws for F eyed faces."""
    _, k_post = jax.random.split(key)
    if not landmarks:  # pupils-only draws straight from k_post
        return (np.asarray(jax.random.uniform(k_post, (2 * f, P, 3))),)
    k_eyes, k_lmk = jax.random.split(k_post)
    return (np.asarray(jax.random.uniform(k_eyes, (2 * f, P, 3))),
            np.asarray(jax.random.uniform(k_lmk, (15 * f, P, 3))))


def _payload(results):
    return [r.to_json_dict() for r in results]


def _scales(results):
    return np.array([p.scale for r in results for p in r.eyes + r.landmarks],
                    np.float32)


def _same(a, b):
    return _payload(a) == _payload(b) and np.array_equal(
        _scales(a).view(np.int32), _scales(b).view(np.int32))


def test_fused_post_matches_jax(sample_gray, det):
    """fused_post against pigo_tpu.detector._fused_post_impl run op by op,
    for two faces, bit for bit on every median."""
    jdet = jax_det.FaceDetector(face=object())
    rows, cols = sample_gray.shape
    faces = [(206, 154, 261), (150, 200, 120)]
    erow, ecol, escale = [], [], []
    for r, c, s in faces:
        o_row, o_l, o_r = port_det._eye_anchor_offsets(s)
        erow += [r - o_row] * 2
        ecol += [c - o_l, c + o_r]
        escale += [s * 0.25] * 2
    key = jax.random.PRNGKey(3)
    pg, lg = jdet.pupil.forest, jdet.landmarks.geometry
    sched = jdet.landmarks.point_schedule
    cids = np.tile([jdet.landmarks._name_to_id[n] for n, _ in sched],
                   2).astype(np.int32)
    flips = np.tile([fl for _, fl in sched], 2)
    want = jax_det._fused_post_impl(
        key, *(jnp.asarray(v, jnp.float32) for v in (erow, ecol, escale)),
        jnp.asarray(sample_gray.reshape(-1)), jdet.pupil.codes,
        jdet.pupil.preds, jdet.landmarks.codes, jdet.landmarks.preds, f=2,
        perturbs=P, rows=rows, cols=cols, dim=cols, angle_idx=0,
        rotated=False,
        pupil_geom=(pg.stages, pg.trees, pg.depth, float(pg.scale_mult)),
        lmk_geom=(lg.stages, lg.trees, lg.depth, float(lg.scale_mult)),
        lmk_cids=jnp.asarray(cids), lmk_flips=jnp.asarray(flips))
    k_eyes, k_lmk = jax.random.split(key)
    u_eyes = np.array(jax.random.uniform(k_eyes, (4, P, 3)))
    u_lmk = np.array(jax.random.uniform(k_lmk, (30, P, 3)))
    got = port_det.fused_post(
        *(torch.tensor(v, dtype=torch.float32) for v in (erow, ecol, escale)),
        torch.from_numpy(sample_gray.reshape(-1)), det.pupil.tensors,
        det.landmarks.tensors, torch.from_numpy(u_eyes),
        torch.from_numpy(u_lmk), torch.from_numpy(cids),
        torch.from_numpy(flips), rows=rows, cols=cols, dim=cols)
    assert got.shape == (3, 4 + 30)
    assert np.array_equal(got.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    eyes_only = port_det.fused_post(
        *(torch.tensor(v, dtype=torch.float32) for v in (erow, ecol, escale)),
        torch.from_numpy(sample_gray.reshape(-1)), det.pupil.tensors, None,
        torch.from_numpy(u_eyes), None, None, None, rows=rows, cols=cols,
        dim=cols)
    assert torch.equal(eyes_only, got[:, :4])


@pytest.mark.parametrize("landmarks", [True, False])
def test_fused_post_reads_uniform_rows(sample_gray, det, landmarks):
    """fused_post with per-group uniform rows (the stream's flat draw, a
    pad slot reading the first face's rows) equals fused_post on the rows
    gathered first, bit for bit."""
    rng = np.random.default_rng(9)
    rows, cols = sample_gray.shape
    faces = [port_det.Detection(206, 154, 261, 9.0),
             port_det.Detection(150, 200, 120, 9.0),
             port_det.Detection(0, 0, 100, 0.0)]  # a pad slot
    anchors = torch.from_numpy(port_det.eye_anchors(faces)).T.contiguous()
    cids, flips = det.landmarks.schedule_arrays(3)
    table = torch.from_numpy(rng.random((60, P, 3), dtype=np.float32))
    eye_rows = torch.tensor([0, 1, 2, 3, 0, 1])
    lmk_rows = torch.cat([4 + torch.arange(30), 4 + torch.arange(15)])
    lmk = det.landmarks.tensors if landmarks else None
    tail = (torch.from_numpy(cids), torch.from_numpy(flips)) if landmarks \
        else (None, None)
    kw = dict(rows=rows, cols=cols, dim=cols)
    pix = torch.from_numpy(sample_gray.reshape(-1))
    got = port_det.fused_post(
        *anchors, pix, det.pupil.tensors, lmk, table, table, *tail,
        u_rows=(eye_rows, lmk_rows), **kw)
    want = port_det.fused_post(
        *anchors, pix, det.pupil.tensors, lmk, table[eye_rows],
        table[lmk_rows] if landmarks else None, *tail, **kw)
    assert got.shape == (3, 6 + 45 * landmarks)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_post_stage_staging_is_reused(sample_gray):
    """`detect` packs its eye anchors and uniforms into one staging
    buffer, returned to the detector's pool when the stage is collected:
    repeated calls reuse it, and draw what the generator gives (equal to
    passing those draws as `uniforms=`); streamed stages in flight hold
    one buffer each."""
    det = FaceDetector(device="cpu")
    rows, cols = sample_gray.shape
    params = CascadeParams(**CFG)
    first = det.detect(sample_gray, rows, cols, params, perturbs=P,
                       generator=torch.Generator().manual_seed(4))
    [buf] = det._post_staging
    again = det.detect(sample_gray, rows, cols, params, perturbs=P,
                       generator=torch.Generator().manual_seed(4))
    assert det._post_staging == [buf] and _same(first, again)
    gen = torch.Generator().manual_seed(4)
    drawn = (torch.rand((2, P, 3), generator=gen).numpy(),
             torch.rand((15, P, 3), generator=gen).numpy())
    given = det.detect(sample_gray, rows, cols, params, perturbs=P,
                       uniforms=drawn)
    assert _same(first, given)
    streamed = list(det.detect_stream([sample_gray] * 4, params,
                                      perturbs=P, seed=4, depth=3))
    assert _same(streamed[0], first) and len(det._post_staging) == 3


FRAMES = {
    # name: (frame function, cascade params, IoU threshold)
    "portrait": (lambda g: g, CFG, 0.1),
    "two_faces": (lambda g: np.concatenate([g, g], axis=1),
                  dict(min_size=100, max_size=400, shift_factor=0.15,
                       scale_factor=1.15), 0.2),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_detect_matches_jax(name, sample_gray, det, jax_face):
    """FaceDetector(device="cpu").detect against pigo_tpu's detect with
    the same uniforms (one face, and two side by side): equal JSON
    payloads, detect_faces and accumulated payloads."""
    build, cfg, iou = FRAMES[name]
    frame = np.ascontiguousarray(build(sample_gray))
    rows, cols = frame.shape
    jdet = jax_det.FaceDetector(face=jax_face)
    key = jax.random.PRNGKey(7)
    want = jdet.detect(frame, rows, cols, jax_det.CascadeParams(**cfg),
                       iou_threshold=iou, perturbs=P, key=key)
    f = sum(r.face.scale > port_det.MIN_EYE_FACE_SCALE for r in want)
    assert f == (2 if name == "two_faces" else 1)
    got = det.detect(frame, rows, cols, CascadeParams(**cfg),
                     iou_threshold=iou, perturbs=P,
                     uniforms=_jax_uniforms(key, f))
    assert _payload(got) == _payload(want)
    assert all(len(r.eyes) == 2 and len(r.landmarks) == 15 for r in got)
    a, b = _scales(got), _scales(want)
    assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b))
    assert det.detect_faces(frame, rows, cols, CascadeParams(**cfg),
                            iou_threshold=iou) == [
        port_det.Detection(d.row, d.col, d.scale, d.q)
        for d in jdet.detect_faces(frame, rows, cols,
                                   jax_det.CascadeParams(**cfg),
                                   iou_threshold=iou)]
    payload = _payload(got)
    assert port_det.accumulate_json_payload(payload) == \
        jax_det.accumulate_json_payload(payload)


def test_partial_configurations_match_jax(sample_gray, face_forest,
                                          jax_face):
    """Pupils-only (landmarks=None) and faces-only detectors."""
    rows, cols = sample_gray.shape
    key = jax.random.PRNGKey(5)
    face = FaceCascade(device="cpu")
    for with_pupils, with_landmarks in ((True, False), (False, False)):
        jdet = jax_det.FaceDetector(face=jax_face, with_pupils=with_pupils,
                                    with_landmarks=with_landmarks)
        port = FaceDetector(face=face, with_pupils=with_pupils,
                            with_landmarks=with_landmarks, device="cpu")
        want = jdet.detect(sample_gray, rows, cols,
                           jax_det.CascadeParams(**CFG), iou_threshold=0.1,
                           perturbs=P, key=key)
        got = port.detect(sample_gray, rows, cols, CascadeParams(**CFG),
                          iou_threshold=0.1, perturbs=P,
                          uniforms=(_jax_uniforms(key, 1, False)
                                    if with_pupils else None))
        assert _payload(got) == _payload(want)
        assert [len(r.eyes) for r in got] == [2 if with_pupils else 0]
        assert all(not r.landmarks for r in got)


@pytest.mark.parametrize("depth", [1, 3])
def test_detect_stream_matches_detect(depth, sample_gray, det):
    """detect_stream yields per-frame detect with the generator seeded
    seed + i, in order, with a faceless frame among them."""
    rows, cols = sample_gray.shape
    frames = [np.roll(sample_gray, 3 * i, axis=1) for i in range(4)]
    frames.insert(2, np.zeros_like(sample_gray))
    params = CascadeParams(**CFG)
    streamed = list(det.detect_stream(iter(frames), params,
                                      iou_threshold=0.1, perturbs=P,
                                      seed=11, depth=depth))
    assert len(streamed) == len(frames)
    assert streamed[2] == []
    for i, (frame, got) in enumerate(zip(frames, streamed)):
        want = det.detect(frame, rows, cols, params, iou_threshold=0.1,
                          perturbs=P,
                          generator=torch.Generator().manual_seed(11 + i))
        assert _same(got, want), i
    assert all(len(r.landmarks) == 15 for frame in streamed for r in frame)


def test_detector_rules(sample_gray, det):
    """Angles above zero run rotated in every entry point (detect's faces
    are detect_faces' above Q_THRESH, detect_stream equals detect); the
    default generator is seed 0; a strided ImageParams equals the
    contiguous frame; malformed uniforms and parts on another device are
    refused; no card means no default detector."""
    rows, cols = sample_gray.shape
    params = CascadeParams(**CFG)
    rot = det.detect(sample_gray, rows, cols, params, angle=0.1, perturbs=P)
    faces = det.detect_faces(sample_gray, rows, cols, params, angle=0.1)
    assert [r.face for r in rot] == [d for d in faces
                                     if d.q > port_det.Q_THRESH]
    [streamed] = det.detect_stream([sample_gray], params, angle=0.1,
                                   perturbs=P)
    assert _same(streamed, rot)
    assert faces != det.detect_faces(sample_gray, rows, cols, params)
    base = det.detect(sample_gray, rows, cols, params, perturbs=P)
    seeded = det.detect(sample_gray, rows, cols, params, perturbs=P,
                        generator=torch.Generator().manual_seed(0))
    assert _same(base, seeded)
    pad = np.random.default_rng(0).integers(0, 256, (rows, 37),
                                            dtype=np.uint8)
    strided = ImageParams(
        pixels=np.concatenate([sample_gray, pad], axis=1).reshape(-1),
        rows=rows, cols=cols, dim=cols + 37)
    assert _same(det.detect(strided, params=params, perturbs=P), base)
    with pytest.raises(ValueError):
        det.detect(sample_gray, rows, cols, params, perturbs=P,
                   uniforms=(np.zeros((2, P, 3)), np.zeros((14, P, 3))))
    moved = PupilLocalizer(device="cpu")
    moved.device = torch.device("meta")
    with pytest.raises(ValueError):
        FaceDetector(pupil=moved, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            FaceDetector()
    for s in range(0, 1200):
        assert port_det._eye_anchor_offsets(s) == \
            jax_det._eye_anchor_offsets(s)


def test_eye_anchors_match_jax():
    """eye_anchors gives the eye anchors of the golden corpus tool (its copy
    of the reference CLI's, pigo_tpu/tools/make_golden.py) for every face
    scale up to 1200, in f32 as the walk takes them."""
    from pigo_tpu.tools.make_golden import _eye_anchors

    faces = [port_det.Detection(row=500 + s % 7, col=600 - s % 5, scale=s,
                                q=6.0) for s in range(0, 1200)]
    want = np.array([a for d in faces
                     for a in _eye_anchors(d.row, d.col, d.scale)],
                    np.float32)
    got = port_det.eye_anchors(faces)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert port_det.eye_anchors([]).shape == (0, 3)
