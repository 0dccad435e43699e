"""The port's device-resident detector stream against the JAX package and
against its own host path.

pigo_tpu_torch on the CPU, where `cluster_device` runs its plain version
and every other kernel wrapper its own: the on-device clustering against
pigo_tpu.ops.cluster_device (coordinates exact, q within 1e-6 relative:
the JAX function sums q in XLA's order) and against the port's host
`cluster_detections` (bit for bit, ties and an IoU at the threshold
included); the device eye anchors; the prefix property of torch.rand that
the stream's jitter rests on; `detect_stream_device` against per-frame
`detect` bit for bit (upright, rotated, every rung of the ladder, the
other face modes, the partial configurations); and the JAX
`detect_stream_device`, whose faces the port's equal (its jitter is
gathered by face slot, so its eyes may differ from its own `detect`,
ROADMAP.md queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigo_tpu import detector as jax_det
from pigo_tpu.models.face import FaceCascade as JaxFaceCascade
from pigo_tpu.ops.cluster_device import cluster_device as jax_cluster_device
from pigo_tpu_torch import FaceCascade, FaceDetector
from pigo_tpu_torch import detector as port_det
from pigo_tpu_torch.detector import CascadeParams
from pigo_tpu_torch.models.pupil import draw_uniforms
from pigo_tpu_torch.ops import cluster_device as cd
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.utils import profiling
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

CAP = 64
P = 15  # perturbations per anchor, as tests/test_torch_detector.py
# the sample frame beside itself: two faces with eyes and 15 points
TWO = (CascadeParams(100, 400, 0.2, 1.2), 0.1)
# the golden sample's configuration: at angle 0.07 one face, rotated
GOLDEN = (CascadeParams(20, 1000, 0.2, 1.1), 0.1)
# the pair of boxes whose IoU is exactly 0.2 in f64 (12 / 60) and 0.5
# (6 / 12): at these thresholds neither joins the other
AT_THRESHOLD = {0.2: [(10, 10, 6, 3.0), (10, 14, 6, 2.0)],
                0.5: [(20, 20, 3, 1.5), (20, 21, 3, 1.5)]}


def random_dets(n, seed):
    """n detections, heavily overlapping, with equal-q ties."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(40, 80, n)
    cols = rng.integers(40, 80, n)
    scales = rng.choice([20, 24, 29, 35], n)
    q = rng.choice(np.float32([0.5, 1.25, 2.0, 3.7, 5.5]), n)
    return np.stack([rows, cols, scales, q], axis=1).astype(np.float32)


def port_clusters(dets, iou, capacity=CAP, count=None):
    """The port's cluster_device on the CPU: (slots [CC, 4], valid [CC])."""
    n = dets.shape[0]
    buf = np.zeros((capacity, 4), np.float32)
    buf[:n] = dets
    out, ov = cd.cluster_device(
        torch.from_numpy(buf), torch.arange(capacity) < n,
        torch.tensor([n if count is None else count], dtype=torch.int32),
        iou, capacity=capacity)
    return out.numpy(), ov.numpy()


@pytest.mark.parametrize("iou", [0.1, 0.2, 0.5])
@pytest.mark.parametrize("n", [0, 1, 7, 60])
def test_cluster_device_matches_jax(n, iou):
    """Slot for slot against pigo_tpu's cluster_device: the same valid
    slots, (row, col, scale) exact, q within 1e-6 relative."""
    dets = random_dets(n, seed=n)
    buf = np.zeros((CAP, 4), np.float32)
    buf[:n] = dets
    want, wvalid = jax_cluster_device(
        jnp.asarray(buf), jnp.asarray(np.arange(CAP) < n), iou, capacity=CAP)
    want, wvalid = np.asarray(want), np.asarray(wvalid)
    got, gvalid = port_clusters(dets, iou)
    assert np.array_equal(gvalid, wvalid)
    assert np.array_equal(got[:, :3], want[:, :3])
    assert np.allclose(got[:, 3], want[:, 3], rtol=1e-6, atol=0.0)
    assert np.all(got[~gvalid] == 0.0)
    assert n == 0 or gvalid.sum() >= 1


CASES = {
    **{f"random_{n}_{iou}": (random_dets(n, seed=100 + n), iou)
       for n in (1, 7, 60) for iou in (0.1, 0.2, 0.5)},
    **{f"at_threshold_{iou}": (np.float32(pair), iou)
       for iou, pair in AT_THRESHOLD.items()},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_device_equals_host_clustering(case):
    """The valid slots, compacted, are the host's clusters bit for bit
    (the pairs at the threshold stay apart); entries past `count` are not
    read."""
    dets, iou = CASES[case]
    want = cluster_detections(dets.astype(np.float64), iou).astype(np.float32)
    got, gvalid = port_clusters(dets, iou)
    assert np.array_equal(got[gvalid].view(np.int32), want.view(np.int32))
    if case.startswith("at_threshold"):
        assert want.shape[0] == 2
    half = dets.shape[0] // 2
    got, gvalid = port_clusters(dets, iou, count=half)
    want = cluster_detections(dets[:half].astype(np.float64), iou)
    assert np.array_equal(got[gvalid], want.astype(np.float32))


def test_cluster_device_on_sample_hits(sample_gray):
    """The sample frame's real hit list (golden configuration) through
    cluster_device_host equals the host clustering, bit for bit."""
    det = FaceDetector(device="cpu", with_pupils=False,
                       with_landmarks=False)
    rows, cols = sample_gray.shape
    hits = det.face.run_cascade(sample_gray, rows, cols, min_size=20,
                                max_size=1000, shift_factor=0.2,
                                scale_factor=1.1)
    assert hits.shape[0] >= 4
    got = cd.cluster_device_host(hits, 0.1, capacity=CAP, device="cpu")
    want = cluster_detections(hits, 0.1)
    assert np.array_equal(got, want) and got.shape[0] >= 1


def test_cluster_device_guards():
    """Capacity, shapes and devices are checked; no card, no default."""
    with pytest.raises(ValueError, match="exceed device capacity"):
        cd.cluster_device_host(random_dets(9, 0), 0.2, capacity=8,
                               device="cpu")
    big = cd.MAX_CAPACITY + 1
    with pytest.raises(ValueError, match="capacity"):
        cd.cluster_device(torch.zeros((big, 4)), torch.zeros(big, dtype=bool),
                          torch.zeros(1, dtype=torch.int32), 0.2,
                          capacity=big)
    with pytest.raises(ValueError, match="dets"):
        cd.cluster_device(torch.zeros((8, 4)), torch.zeros(8, dtype=bool),
                          torch.zeros(1, dtype=torch.int32), 0.2, capacity=9)
    with pytest.raises(ValueError, match="count"):
        cd.cluster_device(torch.zeros((8, 4)), torch.zeros(8, dtype=bool),
                          torch.zeros(1), 0.2, capacity=8)
    out, ov = cd.cluster_device(
        torch.zeros((0, 4)), torch.zeros(0, dtype=torch.bool),
        torch.zeros(1, dtype=torch.int32), 0.2, capacity=0)
    assert out.shape == (0, 4) and ov.shape == (0,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cd.cluster_device_host(random_dets(3, 0), 0.2)


def test_device_eye_anchors_match_host_and_jax():
    """f32 on the device equals the host offsets and the JAX function."""
    s = np.array([51, 100, 238, 360, 680, 720, 999])
    rows, cols = 500 + s % 7, 600 - s % 5
    got = port_det._device_eye_anchors(
        *(torch.from_numpy(v.astype(np.float32)) for v in (rows, cols, s)))
    want = jax_det._device_eye_anchors(*(jnp.asarray(v, jnp.float32)
                                         for v in (rows, cols, s)))
    faces = [port_det.Detection(int(r), int(c), int(sc), 6.0)
             for r, c, sc in zip(rows, cols, s)]
    host = port_det.eye_anchors(faces).T
    for g, w, h in zip(got, want, host):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), h)


@pytest.mark.parametrize("slots", [2, 16])
@pytest.mark.parametrize("faces", [1, 3, 15])
def test_flat_draw_prefix(faces, slots):
    """One flat draw for S slots begins with what `detect` draws for F
    eyed faces, eyes then landmarks (as far as the shorter one goes)."""
    npts = 15
    gen = torch.Generator().manual_seed(faces)
    eyes = draw_uniforms((2 * faces, P, 3), gen)
    lmk = draw_uniforms((npts * faces, P, 3), gen)
    want = torch.cat([eyes.reshape(-1), lmk.reshape(-1)])
    flat = draw_uniforms(((2 * slots + slots * npts) * P * 3,),
                         torch.Generator().manual_seed(faces))
    n = min(want.numel(), flat.numel())
    assert torch.equal(flat[:n], want[:n])


def _same(a, b):
    """Two list[FaceResult] agree: JSON payload, q and every f32 scale."""
    def floats(results):
        return [[p.scale for p in r.eyes + r.landmarks] + [r.face.q]
                for r in results]

    return ([r.to_json_dict() for r in a] == [r.to_json_dict() for r in b]
            and floats(a) == floats(b))


def _check_stream(det, frames, params, iou, angle, seed, depth):
    got = list(det.detect_stream_device(iter(frames), params, angle=angle,
                                        iou_threshold=iou, perturbs=P,
                                        seed=seed, depth=depth))
    assert len(got) == len(frames)
    for i, (frame, res) in enumerate(zip(frames, got)):
        want = det.detect(frame, frame.shape[0], frame.shape[1], params,
                          angle=angle, iou_threshold=iou, perturbs=P,
                          generator=torch.Generator().manual_seed(seed + i))
        assert _same(res, want), i
    return got


def _counts(det):
    """det's ladder: (face-slot escalations, hit-cap escalations, detect
    fallbacks, host waits)."""
    return tuple(det.ladder[k] for k in (
        "face_slot_escalations", "hit_cap_escalations", "detect_fallbacks",
        "device_frame_waits"))


@pytest.fixture(scope="module")
def det():
    return FaceDetector(device="cpu")


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_device_equals_detect_upright(depth, sample_gray):
    """Two faces a frame, with 1-slot caps: every frame climbs the
    face-slot rung once, and equals `detect`; a faceless frame among them
    yields nothing."""
    frames = [np.concatenate([np.roll(sample_gray, 3 * i, axis=1),
                              sample_gray], axis=1) for i in range(3)]
    frames.insert(1, np.zeros_like(frames[0]))
    det = FaceDetector(device="cpu", device_caps=(4096, 0, 1))
    got = _check_stream(det, frames, *TWO, 0.0, seed=5, depth=depth)
    assert [len(r) for r in got] == [2, 0, 2, 2]
    assert all(len(f.eyes) == 2 and len(f.landmarks) == 15
               for r in got for f in r)
    assert _counts(det) == (3, 0, 0, 7)


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_device_equals_detect_rotated(depth, sample_gray, det):
    """At angle 0.07 the face stage and the eyes run rotated, the points
    upright, as in `detect`; one wait a frame, no rung; under a
    profiler, the program's spans count each frame's dispatch, collect
    and wait."""
    frames = [np.roll(sample_gray, i, axis=1) for i in range(2)]
    det.ladder.clear()
    profiling.TRACE.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _check_stream(det, frames, *GOLDEN, 0.07, seed=9,
                            depth=depth)
    assert [len(r) for r in got] == [1, 1]
    assert len(got[0][0].landmarks) == 15
    assert _counts(det) == (0, 0, 0, 2)
    assert {k: v.calls for k, v in profiling.TRACE.stages.items()
            if k.startswith("stream.")} == {
        "stream.dispatch": 2, "stream.collect": 2, "stream.wait": 2}


def test_device_stream_runs_op_by_op_on_cpu(sample_gray):
    """Off the card DeviceStream runs each frame program op by op: under
    a profiler it counts every frame program it dispatches, the ladder's
    re-dispatches included, in stream.dispatches, and no CUDA graph capture
    or replay; it keeps no graph, and its answers equal `detect`'s."""
    frames = [np.concatenate([np.roll(sample_gray, 3 * i, axis=1),
                              sample_gray], axis=1) for i in range(2)]
    det = FaceDetector(device="cpu", device_caps=(4096, 0, 1))
    params, iou = TWO
    stream = port_det.DeviceStream(det, (params, 0.0, iou, P), depth=2)
    profiling.TRACE.reset()
    got = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i, frame in enumerate(frames):
            stream.submit(frame, 6 + i)
            if stream.full:
                got.append(stream.collect_oldest())
        while len(stream):
            got.append(stream.collect_oldest())
    counts = profiling.TRACE.as_dict()["counts"]
    profiling.TRACE.reset()
    assert _counts(det) == (2, 0, 0, 4)  # each frame climbs from one slot
    assert counts["stream.dispatches"] == 4
    assert "stream.graph_replays" not in counts
    assert "stream.graph_captures" not in counts
    assert not det._graphs
    for i, (frame, res) in enumerate(zip(frames, got)):
        want = det.detect(frame, frame.shape[0], frame.shape[1], params,
                          iou_threshold=iou, perturbs=P,
                          generator=torch.Generator().manual_seed(6 + i))
        assert [len(r) for r in (res, want)] == [2, 2]
        assert _same(res, want), i


@pytest.mark.parametrize("rung", ["face_slots", "hit_caps", "detect"])
def test_stream_device_ladder(rung, sample_gray, monkeypatch):
    """Each rung, forced with small caps: the results still equal
    `detect`, and the counters say which rung ran."""
    frame = np.concatenate([sample_gray, sample_gray], axis=1)
    caps, escalated, want = {
        "face_slots": ((4096, 0, 1), (4096, 0, 16), (1, 0, 0, 2)),
        "hit_caps": ((2, 0, 2), (4096, 0, 16), (0, 1, 0, 2)),
        "detect": ((2, 0, 2), (2, 0, 16), (0, 0, 1, 1)),
    }[rung]
    monkeypatch.setattr(port_det, "DEV_CAPS_ESCALATED", escalated)
    det = FaceDetector(device="cpu", device_caps=caps)
    [got] = _check_stream(det, [frame], *TWO, 0.0, seed=1, depth=1)
    assert len(got) == 2
    assert _counts(det) == want


def test_ladder_counts_on_its_own_detector(sample_gray):
    """Each detector keeps its own ladder: a frame of two faces climbs
    the face-slot rung of a detector with one slot, while a second
    detector on the same models counts nothing until it runs, and then
    only its own wait."""
    frame = np.concatenate([sample_gray, sample_gray], axis=1)
    one = FaceDetector(device="cpu", device_caps=(4096, 0, 1))
    other = FaceDetector(one.face, one.pupil, one.landmarks, device="cpu")
    _check_stream(one, [frame], *TWO, 0.0, seed=1, depth=1)
    assert _counts(one) == (1, 0, 0, 2)
    assert not other.ladder
    _check_stream(other, [frame], *TWO, 0.0, seed=1, depth=1)
    assert _counts(other) == (0, 0, 0, 1)
    assert _counts(one) == (1, 0, 0, 2)


@pytest.mark.parametrize("mode", [{"prefix": True}, {"tree_cap": 32}])
def test_stream_device_in_other_face_modes(mode, sample_gray):
    """The face stage's tree-prefix and tree-cap modes finish every mark
    before `compact_hits`, so the device stream equals `detect` there
    too."""
    det = FaceDetector(face=FaceCascade(device="cpu", **mode), device="cpu")
    [got] = _check_stream(det, [sample_gray], *GOLDEN, 0.0, seed=4,
                          depth=1)
    assert len(got) == 1 and len(got[0].landmarks) == 15
    assert _counts(det) == (0, 0, 0, 1)


def test_stream_device_partial_configurations(sample_gray):
    """Pupils-only and faces-only detectors run `detect_stream`."""
    frames = [sample_gray, np.roll(sample_gray, 2, axis=1)]
    for with_pupils in (True, False):
        det = FaceDetector(device="cpu", with_pupils=with_pupils,
                           with_landmarks=False)
        got = _check_stream(det, frames, *GOLDEN, 0.0, seed=2, depth=2)
        assert [len(r) for r in got] == [1, 1]
        assert all(len(f.eyes) == (2 if with_pupils else 0)
                   and not f.landmarks for r in got for f in r)
        assert _counts(det) == (0, 0, 0, 0)


def test_stream_device_rules(sample_gray):
    """Caps are checked; a frame smaller than the smallest face yields
    nothing without a wait."""
    for caps in ((0, 0, 2), (4097, 0, 2), (64, 0, 0), (64, 2)):
        with pytest.raises(ValueError, match="device_caps"):
            FaceDetector(device="cpu", device_caps=caps)
    det = FaceDetector(device="cpu")
    assert list(det.detect_stream_device([sample_gray[:10, :10]],
                                         *GOLDEN)) == [[]]
    assert _counts(det) == (0, 0, 0, 0)


def test_stream_device_faces_match_jax(sample_gray, det):
    """One JAX detect_stream_device call at the CFG of
    tests/test_torch_detector.py (depth 1): the same faces, (row, col,
    scale) exact and q within 1e-6 relative."""
    cfg = dict(min_size=60, max_size=400, shift_factor=0.3, scale_factor=1.3)
    jdet = jax_det.FaceDetector()
    [want] = jdet.detect_stream_device(
        [sample_gray], jax_det.CascadeParams(**cfg), iou_threshold=0.1,
        key=jax.random.PRNGKey(0), depth=1)
    [got] = det.detect_stream_device([sample_gray], CascadeParams(**cfg),
                                     iou_threshold=0.1, perturbs=P, depth=1)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert (g.face.row, g.face.col, g.face.scale) == \
            (w.face.row, w.face.col, w.face.scale)
        assert abs(g.face.q - w.face.q) <= 1e-6 * abs(w.face.q)
        assert len(g.eyes) == len(w.eyes) == 2


def test_stream_device_gathers_jitter_by_rank(sample_gray, det,
                                              face_forest):
    """A face too small for eyes before an eyed one: the port's device
    stream still equals `detect`, because the eyed face takes the jitter
    rows of its rank among the eyed faces. The JAX package's device
    stream takes them by face slot (pigo_tpu/detector.py:190), so its
    second face's left eye differs from its own `detect` here (ROADMAP.md
    queue 3)."""
    small = sample_gray[::6, ::6]
    frame = np.zeros((400, 394), np.uint8)
    frame[:, :320] = sample_gray
    frame[150:150 + small.shape[0], 330:330 + small.shape[1]] = small
    cfg, iou = (40, 400, 0.2, 1.2), 0.1
    [got] = _check_stream(det, [frame], CascadeParams(*cfg), iou, 0.0,
                          seed=0, depth=1)
    assert [(r.face.row, r.face.col, r.face.scale, len(r.eyes))
            for r in got] == [(183, 358, 48, 0), (207, 155, 261, 2)]
    jdet = jax_det.FaceDetector(face=JaxFaceCascade(face_forest,
                                                    backend="reference"))
    params = jax_det.CascadeParams(*cfg)
    key = jax.random.PRNGKey(0)
    [dev] = jdet.detect_stream_device([frame], params, iou_threshold=iou,
                                      key=key, depth=1)
    host = jdet.detect(frame, 400, 394, params, iou_threshold=iou,
                       key=jax.random.fold_in(key, 0))
    assert [r.face for r in dev] == [r.face for r in host]
    left = [(r[1].eyes[0].row, r[1].eyes[0].col,
             np.float32(r[1].eyes[0].scale)) for r in (dev, host)]
    assert left == [(184, 113, np.float32(21.529411)),
                    (184, 113, np.float32(21.304684))]
