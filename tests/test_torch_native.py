"""The port's host C++ engine and its host tail routing against the JAX
package.

pigo_tpu_torch.native (the port's copy of the engine, built with g++ into
build/pigo_tpu_torch/) against pigo_tpu.native on the sample frame, with
its AVX-512 paths on and off; face_cuda.route_plan(host_tail=True) against
the host scales of pigo_tpu.ops.face_pallas.build_dense_plan; FaceCascade
and FaceDetector with host_tail=True on the CPU against the frozen golden
corpus, against host_tail=False and, at an angle below 1/32 of a turn,
against the JAX package's host tail; the device stream's tail merge
against `detect`; and the paths that must raise instead of running
all-card. Inputs come from the repository's assets or from numpy with
fixed seeds and cross as numpy arrays. Exact equality is the tolerance
throughout. The engine runs with one thread here (threads=1).
"""

import json
import os

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceCascade, FaceDetector, cluster_detections
from pigo_tpu_torch import detector as port_det
from pigo_tpu_torch import native as port_native
from pigo_tpu_torch.detector import CascadeParams, Detection, ImageParams
from pigo_tpu_torch.models.face import merge_scan_order
from pigo_tpu_torch.ops import face_cuda, windows
from pigo_tpu_torch.utils import build
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
ALL_TAGS = ["sample", "test", "sample_dense", "wide", "strided", "alpha"]
ANGLES = (0.0, 0.07, 0.125)
GEOMETRIES = {
    "headline": (400, 320, (20, 1000, 0.1, 1.1)),
    "hd1080": (1080, 1920, (40, 1080, 0.1, 1.1)),
}


def _golden(tag):
    with open(os.path.join(GOLDEN_DIR, tag + ".json")) as fh:
        return json.load(fh)


def _cfg(golden):
    c = golden["config"]
    return dict(min_size=c["min_size"], max_size=c["max_size"],
                shift_factor=c["shift_factor"], scale_factor=c["scale_factor"])


def _frame(golden):
    from pigo_tpu.tools.make_golden import fixture_frame

    return fixture_frame(golden["image"])


def _asset(*parts):
    from pigo_tpu_torch.cascade.assets import asset_path

    with open(asset_path(*parts), "rb") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def engines():
    """(port face engine, port pupil engine, JAX face, JAX pupil)."""
    from pigo_tpu.native import NativeFaceCascade, NativePupilLocalizer

    return (port_native.NativeFaceCascade(threads=1),
            port_native.NativePupilLocalizer(),
            NativeFaceCascade(), NativePupilLocalizer())


def _windows(rng, rows, cols, n=300):
    """Seeded windows int32 [n, 3] (row, col, scale) inside the frame."""
    s = rng.integers(20, 160, n)
    r = rng.integers(s // 2 + 1, rows - s // 2 - 1)
    c = rng.integers(s // 2 + 1, cols - s // 2 - 1)
    return np.stack([r, c, s], 1).astype(np.int32)


@pytest.mark.parametrize("angle", ANGLES)
def test_face_engine_matches_jax(angle, engines, sample_gray):
    """classify_region, run_cascade, run_scales, classify_batch, detect and
    find_faces of the port's engine equal pigo_tpu.native's, bit for bit,
    upright and at both frozen angles."""
    port, _, jax_face, _ = engines
    rows, cols = sample_gray.shape
    pix = sample_gray.ravel()
    cfg = dict(min_size=20, max_size=1000, shift_factor=0.1,
               scale_factor=1.1)
    assert (port.depth, port.num_trees) == (jax_face.depth,
                                            jax_face.num_trees)
    faces = np.asarray(_golden("sample_dense")["detections"])[:, :3]
    w = np.concatenate([_windows(np.random.default_rng(7), rows, cols),
                        faces.astype(np.int32)])
    got = port.classify_batch(pix, rows, cols, w, angle)
    assert np.array_equal(got.view(np.int32), jax_face.classify_batch(
        pix, rows, cols, w, angle).view(np.int32))
    assert angle > 0 or (got[-len(faces):] > 0).all()
    assert [port.classify_region(*x, pix, rows, cols, angle)
            for x in w[-40:]] \
        == [jax_face.classify_region(*x, pix, rows, cols, angle)
            for x in w[-40:]]
    dets = port.run_cascade(pix, rows, cols, angle=angle, **cfg)
    assert np.array_equal(dets, jax_face.run_cascade(pix, rows, cols,
                                                     angle=angle, **cfg))
    scales = np.asarray(windows.pyramid_scales(20, 1000, 1.1)[10:], np.int32)
    assert np.array_equal(
        port.run_scales(pix, rows, cols, scales, angle=angle),
        jax_face.run_scales(pix, rows, cols, scales, angle=angle))
    assert np.array_equal(port.detect(pix, rows, cols, angle=angle, **cfg),
                          jax_face.detect(pix, rows, cols, angle=angle,
                                          **cfg))
    assert np.array_equal(port.find_faces(pix, rows, cols, angle=angle),
                          jax_face.find_faces(pix, rows, cols, angle=angle))
    if angle == 0.0:
        assert dets.shape == (22, 4)


@pytest.mark.parametrize("angle", ANGLES)
def test_pupil_engine_matches_jax(angle, engines, sample_gray):
    """The pupil walk (run_detector, from the engine's own jitter and from
    seeded starts, with and without the flip) and `landmark` of the port's
    engine equal pigo_tpu.native's, bit for bit."""
    from pigo_tpu.native import NativePupilLocalizer

    _, port_pl, _, jax_pl = engines
    rows, cols = sample_gray.shape
    pix = sample_gray.ravel()
    lmk = _asset("cascade", "lps", "lp46")
    port_lmk = port_native.NativePupilLocalizer(lmk)
    jax_lmk = NativePupilLocalizer(lmk)
    assert port_pl.stages == jax_pl.stages == 5
    starts = port_pl.jitter(184.0, 114.0, 60.0, 63, seed=3)
    assert np.array_equal(starts, jax_pl.jitter(184.0, 114.0, 60.0, 63, 3))
    rng = np.random.default_rng(11)
    rand = np.stack([rng.uniform(20, 380, 40), rng.uniform(20, 300, 40),
                     rng.uniform(10, 150, 40)], 1).astype(np.float32)
    for st in (starts, rand):
        for flip in (False, True):
            got = port_pl.run_detector(st, pix, rows, cols, angle=angle,
                                       flip_v=flip)
            assert got == jax_pl.run_detector(st, pix, rows, cols,
                                              angle=angle, flip_v=flip)
    for flip in (False, True):
        got = port_lmk.landmark((184.0, 114.0), (182.0, 204.0), pix, rows,
                                cols, seed=5, angle=angle, flip_v=flip)
        assert got == jax_lmk.landmark((184.0, 114.0), (182.0, 204.0), pix,
                                       rows, cols, seed=5, angle=angle,
                                       flip_v=flip)
        assert got[0] > 0 and got[1] > 0


def test_cluster_and_grayscale_match_jax(sample_image):
    """native_cluster equals pigo_tpu.native's and the port's host
    clustering on the golden detection lists and on seeded random sets
    with equal-q ties; native_grayscale equals pigo_tpu.native's on RGBA,
    RGB, gray+alpha and gray inputs."""
    from pigo_tpu.native import native_cluster, native_grayscale

    rng = np.random.default_rng(3)
    lists = [np.asarray(_golden(t)["detections"], np.float64).reshape(-1, 4)
             for t in ("sample_dense", "wide")]
    for n in (0, 1, 60, 312):
        lists.append(np.stack([
            rng.integers(20, 1060, n), rng.integers(20, 1900, n),
            rng.choice(np.arange(40, 200, 7), n),
            rng.choice(np.float32([0.5, 1.25, 2.0, 5.5]), n)], 1
        ).astype(np.float64))
    for dets in lists:
        for iou in (0.1, 0.2):
            got = port_native.native_cluster(dets, iou)
            assert np.array_equal(got, native_cluster(dets, iou))
            assert np.array_equal(got, cluster_detections(dets, iou))
    alpha = rng.integers(0, 256, (30, 40, 4), dtype=np.uint8)
    for img in (sample_image, sample_image[..., :3], alpha,
                alpha[..., [0, 3]], alpha[..., 0]):
        assert np.array_equal(port_native.native_grayscale(img),
                              native_grayscale(img))


@pytest.mark.parametrize("angle", (0.0, 0.125))
def test_simd_scalar_equivalence(angle, sample_gray):
    """simd=False (the scalar paths) equals simd=True, and one scan thread
    equals four: face scans and window lists over the 1080p tiling
    (rotated reads clamp there) and the sample, the pupil walk. Both
    sides are checked to have run (the AVX-512 side where the CPU has
    it)."""
    hd = np.tile(sample_gray, (3, 6))[:1080, :1920]
    vec = port_native.NativeFaceCascade(threads=4)
    scalar = port_native.NativeFaceCascade(threads=1, simd=False)
    assert not scalar.simd_active
    assert vec.simd_active == port_native.simd_available()
    for frame, cfg in ((sample_gray, (20, 1000, 0.1, 1.1)),
                       (hd, (40, 1080, 0.1, 1.1))):
        rows, cols = frame.shape
        kw = dict(zip(("min_size", "max_size", "shift_factor",
                       "scale_factor"), cfg))
        a = vec.run_cascade(frame, rows, cols, angle=angle, **kw)
        assert np.array_equal(a, scalar.run_cascade(frame, rows, cols,
                                                    angle=angle, **kw))
        assert a.shape[0] > 0 or angle > 0
        w = _windows(np.random.default_rng(1), rows, cols, 500)
        assert np.array_equal(
            vec.classify_batch(frame, rows, cols, w, angle).view(np.int32),
            scalar.classify_batch(frame, rows, cols, w, angle).view(np.int32))
    pv = port_native.NativePupilLocalizer()
    ps = port_native.NativePupilLocalizer(simd=False)
    starts = pv.jitter(184.0, 114.0, 60.0, 63, seed=2)
    assert pv.run_detector(starts, sample_gray, 400, 320, angle=angle) \
        == ps.run_detector(starts, sample_gray, 400, 320, angle=angle)


def test_engine_build_location_and_flags():
    """The engine builds with the native/Makefile flags (-ffp-contract=off
    among them) into build/pigo_tpu_torch/, named by a hash of its source
    and flags, never into the repository's native/; its source reads no
    environment variable."""
    port_native.load_library()
    path = build.native_library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "pigo_tpu_torch")
    assert "-ffp-contract=off" in build.NATIVE_FLAGS
    assert {"-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
            "-pthread"} <= set(build.NATIVE_FLAGS)
    with open(build.NATIVE_SOURCE) as fh:
        src = fh.read()
    assert "getenv" not in src and "PIGO_NATIVE" not in src


def _geometries():
    out = dict(GEOMETRIES)
    for tag in ALL_TAGS:
        g = _golden(tag)
        c = _cfg(g)
        out[tag] = (g["rows"], g["cols"], tuple(c.values()))
    return out


@pytest.mark.parametrize("geometry", sorted(_geometries()))
def test_host_scales_match_jax_plan(geometry, face_forest):
    """route_plan(host_tail=True) hands the host exactly the scales that
    build_dense_plan(prefix=False, tree_cap=0) leaves to the JAX package's
    engine (fallback), for every golden geometry and for the headline and
    1080p pyramids; those scales get no launch and their windows are the
    plan's host_ranges. host_tail with tree_cap keeps the same host
    scales."""
    from pigo_tpu.ops import face_pallas as fp

    rows, cols, cfg = _geometries()[geometry]
    plan = windows.build_window_plan(rows, cols, *cfg)
    jplan = fp.build_dense_plan(face_forest, rows, cols, *cfg, angle_idx=0,
                                prefix=False, tree_cap=0)
    want = {sp.scale for sp in jplan.scales if sp.fallback}
    for cap in (0, 32):
        routed = face_cuda.route_plan(plan, face_forest.num_trees,
                                      prefix=False, tree_cap=cap,
                                      host_tail=True)
        assert set(routed.host_scales.tolist()) == want
        host = np.isin(plan.scale_w, routed.host_scales)
        covered = np.zeros(plan.num_windows, bool)
        for lo, hi in routed.host_ranges:
            covered[lo:hi] = True
        assert np.array_equal(covered, host)
        for seg in routed.segments:
            assert not host[seg.lo:seg.hi].any()
            assert seg.t_limit == (cap or face_forest.num_trees)
    if geometry in GEOMETRIES:
        assert 0 < len(want) < plan.scales.size


def test_host_scales_tie_is_no_suffix(monkeypatch):
    """The promotion sorts by (windows, scale), so at a tie across the
    break a larger scale can go to the host while a smaller one stays on
    the card: the host scales are then no suffix, and the card's segments
    and the host ranges interleave."""
    monkeypatch.setattr(face_cuda, "TAIL_MIN_WINDOWS", 0)
    monkeypatch.setattr(face_cuda, "HOST_SHARE_TARGET", 0.5)
    counts = np.array([40, 30, 30, 30])
    host = face_cuda.host_tail_scales(counts, np.array([10, 12, 14, 16]))
    assert host.tolist() == [False, True, True, False]


@pytest.mark.parametrize("tag", ALL_TAGS)
def test_host_tail_matches_golden(tag):
    """FaceCascade(host_tail=True) (alone and with tree_cap=32) and
    FaceDetector(host_tail=True) reproduce each tag's frozen detections
    and clusters, upright and at both frozen angles, and every detection
    equals host_tail=False."""
    golden = _golden(tag)
    gray, rows, cols, dim = _frame(golden)
    cfg = _cfg(golden)
    iou = golden["config"]["iou"]
    plain = FaceCascade(device="cpu")
    det = FaceDetector(device="cpu", host_tail=True, host_threads=1)
    assert det.face.host_tail
    img = ImageParams(pixels=gray.reshape(-1), rows=rows, cols=cols, dim=dim)
    for fc in (det.face, FaceCascade(device="cpu", host_tail=True,
                                     host_threads=1, tree_cap=32)):
        for angle, want in [(0.0, golden["detections"])] + [
                (r["angle"], r["detections"]) for r in golden["rotations"]]:
            dets = fc.run_cascade(gray, rows, cols, dim, angle=angle, **cfg)
            want = np.asarray(want, np.float64).reshape(-1, 4)
            assert np.array_equal(dets, want), (tag, angle)
            assert np.array_equal(dets, plain.run_cascade(
                gray, rows, cols, dim, angle=angle, **cfg))
            faces = det.detect_faces(img, params=CascadeParams(**cfg),
                                     angle=angle, iou_threshold=iou)
            assert faces == [Detection(int(r), int(c), int(s), float(q))
                             for r, c, s, q in cluster_detections(want, iou)]
        assert np.array_equal(
            fc.detect(gray, rows, cols, dim, iou_threshold=iou, **cfg),
            np.asarray(golden["clusters"], np.float64).reshape(-1, 4))


def test_host_tail_entry_points_equal_all_card(sample_gray):
    """Every public entry point of FaceCascade(host_tail=True) equals
    host_tail=False on the sample frame: window_scores, sparse_hits,
    sparse_hits_batch, stream_hits, run_cascade (also strided),
    run_cascade_sweep, detect_sweep and detect; the host scales' windows
    hold hits, and FaceDetector.detect and detect_stream equal the
    all-card detector's."""
    rows, cols = sample_gray.shape
    cfg = dict(min_size=20, max_size=1000, shift_factor=0.2,
               scale_factor=1.1)
    ht = FaceCascade(device="cpu", host_tail=True, host_threads=1)
    fc = FaceCascade(device="cpu")
    frames = [np.roll(sample_gray, k, axis=1) for k in range(3)]
    routed = ht._plan(rows, cols, *cfg.values())[0]
    assert routed.host_ranges
    for angle in (0.0, 0.07):
        c1, q1 = ht.window_scores(sample_gray, rows, cols, cols,
                                  *cfg.values(), angle=angle)
        c0, q0 = fc.window_scores(sample_gray, rows, cols, cols,
                                  *cfg.values(), angle=angle)
        assert np.array_equal(c1, c0)
        assert np.array_equal(q1.view(np.int32), q0.view(np.int32))
        lo, hi = routed.host_ranges[0]
        assert angle > 0 or (q1[lo:hi] > 0).any()
        kw = dict(angle=angle, **cfg)
        assert np.array_equal(ht.sparse_hits(sample_gray, rows, cols, **kw),
                              fc.sparse_hits(sample_gray, rows, cols, **kw))
        for a, b in zip(ht.sparse_hits_batch(np.stack(frames), **kw),
                        fc.sparse_hits_batch(np.stack(frames), **kw)):
            assert np.array_equal(a, b)
        for a, b in zip(ht.stream_hits(frames, depth=2, **kw),
                        fc.stream_hits(frames, depth=2, **kw)):
            assert np.array_equal(a, b)
        assert np.array_equal(ht.detect(sample_gray, rows, cols, **kw),
                              fc.detect(sample_gray, rows, cols, **kw))
    padded = np.zeros((rows, cols + 11), np.uint8)
    padded[:, :cols] = sample_gray
    assert np.array_equal(
        ht.run_cascade(padded.ravel(), rows, cols, cols + 11, **cfg),
        fc.run_cascade(sample_gray, rows, cols, **cfg))
    angles = (0.0, 0.07, 0.125)
    assert np.array_equal(
        ht.run_cascade_sweep(sample_gray, rows, cols, angles, **cfg),
        fc.run_cascade_sweep(sample_gray, rows, cols, angles, **cfg))
    assert np.array_equal(
        ht.detect_sweep(sample_gray, rows, cols, angles, **cfg),
        fc.detect_sweep(sample_gray, rows, cols, angles, **cfg))
    det = FaceDetector(device="cpu", host_tail=True, host_threads=1)
    det0 = FaceDetector(device="cpu")
    prm = CascadeParams(**cfg)
    for angle in (0.0, 0.07):
        a = det.detect(sample_gray, rows, cols, prm, angle=angle,
                       iou_threshold=0.1,
                       generator=torch.Generator().manual_seed(1))
        b = det0.detect(sample_gray, rows, cols, prm, angle=angle,
                        iou_threshold=0.1,
                        generator=torch.Generator().manual_seed(1))
        assert [r.to_json_dict() for r in a] == [r.to_json_dict() for r in b]
        assert a and a[0].landmarks
    for a, b in zip(det.detect_stream(frames, prm, iou_threshold=0.1),
                    det0.detect_stream(frames, prm, iou_threshold=0.1)):
        assert [r.to_json_dict() for r in a] == [r.to_json_dict() for r in b]


def test_wide_below_one_32nd_matches_jax_host_tail(face_forest):
    """At angle 0.01 (angle index 0) the JAX package's card scales run
    upright while its engine reads rotated with the reference's clamps;
    FaceCascade(host_tail=True) does the same, so on the wide golden frame
    it equals the JAX package's host tail path (its `_fallback_hits` over
    its plan's host scales, merged with its card part, which runs upright
    and is the upright golden's detections on the card scales) and
    differs from host_tail=False, which equals the upright golden. The
    first window that differs, in scan order, is (100, 236, 86)."""
    from pigo_tpu.models.face import FaceCascade as JaxCascade
    from pigo_tpu.ops import face_pallas as fp

    golden = _golden("wide")
    gray, rows, cols, dim = _frame(golden)
    cfg = _cfg(golden)
    jfc = JaxCascade()
    jplan = fp.build_dense_plan(face_forest, rows, cols, *cfg.values(),
                                angle_idx=0, prefix=False, tree_cap=0)
    tail = jfc._fallback_hits(gray.reshape(rows, cols), jplan, rows, cols,
                              *cfg.values(), angle=0.01)
    host = {sp.scale for sp in jplan.scales if sp.fallback}
    upright = np.asarray(golden["detections"], np.float64).reshape(-1, 4)
    card = upright[~np.isin(upright[:, 2], list(host))]
    want = merge_scan_order(card, tail)
    got = FaceCascade(device="cpu", host_tail=True, host_threads=1
                      ).run_cascade(gray, rows, cols, angle=0.01, **cfg)
    assert np.array_equal(got, want)
    off = FaceCascade(device="cpu").run_cascade(gray, rows, cols, angle=0.01,
                                                **cfg)
    assert np.array_equal(off, upright) and off.shape[0] == 118
    assert got.shape[0] != off.shape[0]
    n = min(got.shape[0], off.shape[0])
    first = np.flatnonzero((got[:n, :3] != off[:n, :3]).any(1))[0]
    assert off[first, :3].tolist() == [100, 236, 86]
    assert off[first, 3] == np.float32(3.711442)


def test_merge_tail_matches_scan_order():
    """detector.merge_tail (the device stream's merge, on tensors) gives
    the host merge's order (models/face.merge_scan_order) for seeded card
    and tail lists that interleave by scale, with invalid slots of both
    last, and reports the tail's count."""
    rng = np.random.default_rng(5)
    rows, cols = 300, 500

    def hits(scales, n):
        s = np.sort(rng.choice(scales, n))
        r = rng.integers(0, rows, n)
        c = rng.integers(0, cols, n)
        d = np.stack([r, c, s, rng.random(n).astype(np.float32) + 1], 1)
        return d[np.lexsort((d[:, 1], d[:, 0], d[:, 2]))]

    card = hits([20, 24, 40, 52], 30)
    tail = hits([30, 34, 60], 12)
    want = merge_scan_order(card, tail)
    dense = np.zeros((40, 4), np.float32)
    dense[:30] = card
    t = np.zeros(1 + 4 * 16, np.float32)
    t[0] = 12
    t[1:1 + 48] = tail.reshape(-1)
    dets, valid, tail_n = port_det.merge_tail(
        torch.from_numpy(dense), torch.arange(40) < 30, torch.from_numpy(t),
        16, rows, cols)
    assert int(tail_n) == 12 and int(valid.sum()) == 42
    assert valid[:42].all() and not valid[42:].any()
    assert np.array_equal(dets[:42].numpy(), want.astype(np.float32))


@pytest.mark.parametrize("caps", [None, (4096, 1, 2)])
def test_stream_device_host_tail_equals_detect(caps, sample_gray):
    """detect_stream_device on a host-tail detector equals per-frame
    `detect` bit for bit, on the sample frames (whose hits lie in host and
    card scales) and on a frame whose four faces put more tail hits in
    than a tail cap of one holds: that frame climbs the ladder (a hit-cap
    escalation) and still equals `detect`."""
    det = FaceDetector(device="cpu", host_tail=True, host_threads=1,
                       device_caps=caps)
    quad = np.tile(sample_gray, (2, 2))
    frames = [sample_gray, np.roll(sample_gray, 3, axis=1), quad]
    prm = CascadeParams(min_size=40, max_size=400, shift_factor=0.2,
                        scale_factor=1.2)
    routed = det.face._plan(*quad.shape, *vars(prm).values())[0]
    assert routed.host_ranges and routed.segments
    got = list(det.detect_stream_device(frames, prm, iou_threshold=0.1,
                                        seed=4, depth=2))
    want = [det.detect(f, *f.shape, prm, iou_threshold=0.1,
                       generator=torch.Generator().manual_seed(4 + i))
            for i, f in enumerate(frames)]
    for a, b in zip(got, want):
        assert [r.to_json_dict() for r in a] == [r.to_json_dict() for r in b]
        assert [r.face.q for r in a] == [r.face.q for r in b]
    assert len(got[2]) == 4
    ladder = det.ladder
    if caps is None:
        assert ladder["hit_cap_escalations"] == 0
        assert ladder["device_frame_waits"] == len(frames) \
            + ladder["face_slot_escalations"]
    else:
        assert ladder["hit_cap_escalations"] == len(frames)
        assert ladder["tail_cap_escalations"] == len(frames)
    tails = det.face._dispatch(quad[None], det.face._single, vars(prm)).tail
    assert tails[0].shape[0] > 1


def test_host_tail_never_runs_all_card(tmp_path, monkeypatch, face_forest):
    """host_tail raises instead of carrying on all-card: with prefix
    (FaceCascade and route_plan), on a cascade without bytes (from_forest,
    a bare forest), on a FaceDetector given a cascade built without it,
    and when the engine cannot be built (a compiler that does not exist,
    into an empty build directory): NativeUnavailable from the loader,
    FaceCascade and FaceDetector alike."""
    plan = windows.build_window_plan(400, 320, 20, 1000, 0.1, 1.1)
    with pytest.raises(ValueError, match="prefix"):
        face_cuda.route_plan(plan, 468, prefix=True, host_tail=True)
    with pytest.raises(ValueError, match="prefix"):
        FaceCascade(device="cpu", prefix=True, host_tail=True)
    with pytest.raises(ValueError, match="bytes"):
        FaceCascade.from_forest(face_forest, device="cpu", host_tail=True)
    with pytest.raises(ValueError, match="bytes"):
        FaceCascade(FaceCascade(device="cpu").forest, "cpu", host_tail=True)
    with pytest.raises(ValueError, match="host_tail"):
        FaceDetector(FaceCascade(device="cpu"), device="cpu", host_tail=True)
    raw = _asset("cascade", "facefinder")
    assert FaceCascade.from_bytes(raw, "cpu", host_tail=True).native
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "GXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(port_native.NativeUnavailable):
        port_native.load_library()
    with pytest.raises(port_native.NativeUnavailable):
        FaceCascade.from_bytes(raw, "cpu", host_tail=True)
    with pytest.raises(port_native.NativeUnavailable):
        FaceDetector(device="cpu", host_tail=True)
    assert not list(tmp_path.iterdir())
