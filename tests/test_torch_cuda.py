"""The port on the card: tests that need an NVIDIA Hopper card (sm_90a).

These tests import neither jax nor pigo_tpu, so they run where only
PyTorch and the CUDA toolkit are installed:

    PIGO_TPU_TEST_PLATFORM=gpu python -m pytest tests/test_torch_cuda.py -m cuda

(a PIGO_TPU_TEST_PLATFORM other than cpu keeps tests/conftest.py from
importing jax). Without a card each test skips with its reason;
chip_smoke.py runs the same checks at the main path's full shapes.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceCascade, FaceDetector
from pigo_tpu_torch.cascade.assets import load_facefinder
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.detector import CascadeParams
from pigo_tpu_torch.ops import (face_cuda, face_dense, pupil_cuda,
                                pupil_dense, windows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (sm_90a) and the CUDA toolkit; "
                    "chip_smoke.py runs these checks on one")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def gray():
    return np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                "sample_gray.npy"))


def test_kernel_matches_plain_on_card(cuda_device, gray):
    """The CUDA kernel is bit-equal to the plain version on the card, at
    the headline pyramid, for the full forest and a 32-tree limit."""
    forest = load_facefinder()
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh, cuda_device)
    rng = np.random.default_rng(0)
    frames = np.stack([gray, rng.integers(0, 256, gray.shape,
                                          dtype=np.uint8)])
    plan = windows.build_window_plan(400, 320, **HEADLINE)
    base, scale = face_cuda.device_plan(plan, cuda_device)
    ft_frames = torch.from_numpy(frames).to(cuda_device)
    for t_limit in (ft.num_trees, 32):
        before = face_cuda.face_cascade_launches
        qk = face_cuda.face_cascade(ft_frames, base, scale, ft.codes,
                                    ft.preds, ft.thresh, t_limit)
        assert face_cuda.face_cascade_launches == before + 1
        qp = face_dense.classify_windows(ft_frames, base, scale, ft.codes,
                                         ft.preds, ft.thresh, t_limit)
        torch.cuda.synchronize()
        assert torch.equal(qk, qp)


def _random_forest(seed, depth, trees, device):
    rng = np.random.default_rng(seed)
    leaves = 1 << depth
    codes = rng.integers(-128, 128, (trees, leaves, 4)).astype(np.int8)
    codes[:, 0] = 0
    preds = rng.uniform(-1.0, 1.0, (trees, leaves)).astype(np.float32)
    return face_forest_from_numpy(depth, codes, preds,
                                  np.full(trees, -1.5, np.float32), device)


def test_prefix_rotated_and_finish_match_plain_on_card(cuda_device):
    """On a random depth-6, 80-tree forest: the prefix kernel (upright and
    rotated), the rotated cascade kernel and the finish are bit-equal to
    their plain versions on the card, each one launch for a batch of
    frames; on a tall strided frame the rotated reads go through the
    stride."""
    ft = _random_forest(1, 6, 80, cuda_device)
    rng = np.random.default_rng(1)
    cases = [(np.stack([rng.integers(0, 256, (200, 240), dtype=np.uint8)
                        for _ in range(3)]), 240),
             (rng.integers(0, 256, (1, 150, 97), dtype=np.uint8), 80)]
    tables = (ft.codes, ft.preds, ft.thresh)
    for frames, cols in cases:
        rows = frames.shape[1]
        plan = windows.build_window_plan(rows, cols, 10, 120, 0.1, 1.2)
        base, scale = face_cuda.device_plan(plan, cuda_device)
        f = torch.from_numpy(frames).to(cuda_device)
        for a in (0, 2, 4):
            if a == 0 and cols != frames.shape[2]:
                continue
            kw = dict(angle_idx=a, cols=cols)
            for fn, counter, t_limit in (
                    (face_cuda.face_prefix, "face_prefix_launches", 32),
                    (face_cuda.face_cascade, "face_cascade_launches", 80)):
                before = getattr(face_cuda, counter)
                got = fn(f, base, scale, *tables, t_limit, **kw)
                assert getattr(face_cuda, counter) == before + 1
                want = face_dense.classify_windows(f, base, scale, *tables,
                                                   t_limit, **kw)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                if t_limit == 32:
                    marks = got
            assert (marks == face_dense.PREFIX_MARK).any()
            before = face_cuda.face_finish_launches
            got = face_cuda.face_finish(f, base, scale, *tables,
                                        marks.clone(), **kw)
            assert face_cuda.face_finish_launches == before + 1
            want = face_dense.finish_marked(f, base, scale, *tables,
                                            marks.clone(), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("forest_kind", ["never_fail", "facefinder",
                                         "random_d6_t80"])
def test_cascade_schedule_edges_on_card(cuda_device, gray, forest_kind):
    """The two-phase schedule of face_cascade and face_finish
    (csrc/face_cascade.cu) at its edges, bit-equal to the plain versions on
    the headline pyramid, upright and rotated: thresholds that never fail
    (every window of every block goes to phase 2's worklist), tree limits
    that are not multiples of 32 (36, 100), and a random depth-6, 80-tree
    forest (phase 2 ends in a partial chunk); each capped cascade's marks
    finished by face_finish."""
    if forest_kind == "random_d6_t80":
        ft = _random_forest(3, 6, 80, cuda_device)
        limits = (80, 36)
    else:
        forest = load_facefinder()
        thresh = forest.thresh
        if forest_kind == "never_fail":
            thresh = np.full_like(thresh, -1e4)
        ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                    thresh, cuda_device)
        limits = (36, 100) + ((ft.num_trees,) if forest_kind == "never_fail"
                              else ())
    tables = (ft.codes, ft.preds, ft.thresh)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(np.stack([
        gray, rng.integers(0, 256, gray.shape, dtype=np.uint8)])).to(
            cuda_device)
    plan = windows.build_window_plan(400, 320, **HEADLINE)
    base, scale = face_cuda.device_plan(plan, cuda_device)
    for a in (0, 2):
        for t_limit in limits:
            before = (face_cuda.face_cascade_launches,
                      face_cuda.face_finish_launches)
            got = face_cuda.face_cascade(frames, base, scale, *tables,
                                         t_limit, angle_idx=a)
            want = face_dense.classify_windows(frames, base, scale, *tables,
                                               t_limit, angle_idx=a)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (a, t_limit)
            if forest_kind == "never_fail":
                assert bool((got != -1.0).all())
            if t_limit == ft.num_trees:
                assert face_cuda.face_cascade_launches == before[0] + 1
                continue
            assert (got == face_dense.PREFIX_MARK).any()
            fin = face_cuda.face_finish(frames, base, scale, *tables,
                                        got.clone(), angle_idx=a)
            want = face_dense.finish_marked(frames, base, scale, *tables,
                                            got.clone(), angle_idx=a)
            torch.cuda.synchronize()
            assert torch.equal(fin, want), (a, t_limit)
            assert (face_cuda.face_cascade_launches,
                    face_cuda.face_finish_launches) == (before[0] + 1,
                                                        before[1] + 1)


@pytest.mark.parametrize("forest_kind", ["never_fail", "random_d6_t80",
                                         "random_d8_t40"])
def test_prefix_schedule_edges_on_card(cuda_device, gray, forest_kind):
    """Kernel B's two-phase schedule (csrc/face_prefix.cu) at its edges,
    bit-equal to the plain version over the headline's tail scales,
    upright and rotated: tree limits 1 (phase 1 alone), 32 (one round), 33
    and 64 (a second round), on the facefinder with thresholds that never
    fail (every window of every block on the worklist) and on a random
    depth-6 forest; a random depth-8 forest (256 swizzled slots a tree) at
    1 and 23 trees, the most whose tables fit PREFIX_SMEM_BYTES."""
    if forest_kind == "never_fail":
        forest = load_facefinder()
        ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                    np.full_like(forest.thresh, -1e4),
                                    cuda_device)
        limits = (1, 32, 33, 64)
    elif forest_kind == "random_d6_t80":
        ft = _random_forest(4, 6, 80, cuda_device)
        limits = (1, 32, 33, 64)
    else:
        ft = _random_forest(5, 8, 40, cuda_device)
        limits = (1, 23)
        assert (face_cuda.prefix_smem_bytes(24, 256)
                > face_cuda.PREFIX_SMEM_BYTES
                >= face_cuda.prefix_smem_bytes(23, 256))
    tables = (ft.codes, ft.preds, ft.thresh)
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(np.stack([
        gray, rng.integers(0, 256, gray.shape, dtype=np.uint8)])).to(
            cuda_device)
    plan = windows.build_window_plan(400, 320, **HEADLINE)
    routed = face_cuda.route_plan(plan, ft.num_trees, prefix=True)
    [seg] = [sg for sg in routed.segments if sg.prefix]
    base, scale = face_cuda.device_plan(plan, cuda_device)
    pb, ps = base[seg.lo:seg.hi], scale[seg.lo:seg.hi]
    for a in (0, 2):
        for t_limit in limits:
            before = face_cuda.face_prefix_launches
            got = face_cuda.face_prefix(frames, pb, ps, *tables, t_limit,
                                        angle_idx=a)
            assert face_cuda.face_prefix_launches == before + 1
            want = face_dense.classify_windows(frames, pb, ps, *tables,
                                               t_limit, angle_idx=a)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (a, t_limit)
            if forest_kind == "never_fail":
                assert bool((got == face_dense.PREFIX_MARK).all())
            elif t_limit > 1:
                assert (got == -1.0).any() and (got != -1.0).any()


def test_prefix_shared_memory_limit_raises_on_card(cuda_device):
    """The prefix kernel refuses tables above the shared memory it asks
    for (32 trees of depth 8: 65,664 B) before any launch."""
    ft = _random_forest(2, 8, 40, cuda_device)
    frames = torch.zeros((1, 600, 600), dtype=torch.uint8,
                         device=cuda_device)
    base = torch.full((4,), 300 * 600 + 300, dtype=torch.int32,
                      device=cuda_device)
    scale = torch.full((4,), 100, dtype=torch.int32, device=cuda_device)
    before = face_cuda.face_prefix_launches
    with pytest.raises(ValueError, match="shared memory"):
        face_cuda.face_prefix(frames, base, scale, ft.codes, ft.preds,
                              ft.thresh, 32)
    assert face_cuda.face_prefix_launches == before
    face_cuda.face_prefix(frames, base, scale, ft.codes, ft.preds, ft.thresh,
                          16)
    torch.cuda.synchronize()
    assert face_cuda.face_prefix_launches == before + 1


def test_face_cascade_modes_on_card(cuda_device, gray):
    """FaceCascade(prefix=True) and FaceCascade(tree_cap=32) on the card
    reproduce the headline golden detections, upright and at angle 0.07;
    a batch of 4 frames is one launch of each kernel of the mode."""
    with open(os.path.join(ROOT, "tests", "golden",
                           "sample_dense.json")) as fh:
        golden = json.load(fh)
    frames = np.stack([np.roll(gray, i, axis=1) for i in range(4)])
    want = FaceCascade().sparse_hits_batch(frames, **HEADLINE)
    for kw, per_batch in ((dict(prefix=True), (1, 1, 1)),
                          (dict(tree_cap=32), (1, 0, 1))):
        fc = FaceCascade(**kw)
        for angle, dets in ((0.0, golden["detections"]),
                            (0.07, golden["rotations"][0]["detections"])):
            assert np.array_equal(
                fc.run_cascade(gray, 400, 320, angle=angle, **HEADLINE),
                np.asarray(dets, np.float64).reshape(-1, 4))
        before = (face_cuda.face_cascade_launches,
                  face_cuda.face_prefix_launches,
                  face_cuda.face_finish_launches)
        got = fc.sparse_hits_batch(frames, **HEADLINE)
        after = (face_cuda.face_cascade_launches,
                 face_cuda.face_prefix_launches,
                 face_cuda.face_finish_launches)
        assert tuple(x - y for x, y in zip(after, before)) == per_batch
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_face_cascade_on_card_matches_golden(cuda_device, gray):
    """FaceCascade() on the card: the headline detections and clusters
    equal the frozen corpus, stream_hits and sparse_hits_batch equal
    run_cascade, and every frame is one kernel launch."""
    with open(os.path.join(ROOT, "tests", "golden",
                           "sample_dense.json")) as fh:
        golden = json.load(fh)
    fc = FaceCascade()
    assert fc.device.type == "cuda"
    before = face_cuda.face_cascade_launches
    dets = fc.run_cascade(gray, 400, 320, **HEADLINE)
    assert np.array_equal(dets, np.asarray(golden["detections"], np.float64))
    clusters = fc.detect(gray, 400, 320, iou_threshold=golden["config"]["iou"],
                         **HEADLINE)
    assert np.array_equal(clusters,
                          np.asarray(golden["clusters"], np.float64))
    frames = [np.roll(gray, i, axis=1) for i in range(4)]
    want = [fc.run_cascade(f, 400, 320, **HEADLINE) for f in frames]
    streamed = list(fc.stream_hits(frames, depth=2, **HEADLINE))
    batch = fc.sparse_hits_batch(np.stack(frames), **HEADLINE)
    assert all(np.array_equal(s, w) for s, w in zip(streamed, want))
    assert all(np.array_equal(b, w) for b, w in zip(batch, want))
    assert face_cuda.face_cascade_launches - before == 2 + 4 + 4 + 1


def test_pupil_walk_matches_plain_on_card(cuda_device, gray):
    """The walk kernel is bit-equal to the plain walk on the card on
    (r, c, s): eyes, rotated eyes and the nine landmark cascades with
    flips, from seeded starts over the sample frame."""
    det = FaceDetector(device=cuda_device)
    pix = torch.from_numpy(gray.reshape(-1)).to(cuda_device)
    rng = np.random.default_rng(0)
    n = 630
    for tensors, angle_idx in ((det.pupil.tensors, 0),
                               (det.pupil.tensors, 8),
                               (det.landmarks.tensors, 0)):
        starts = [torch.from_numpy(a).to(cuda_device) for a in (
            rng.integers(0, tensors.codes.shape[0], n).astype(np.int32),
            rng.uniform(0, 400, n).astype(np.float32),
            rng.uniform(0, 320, n).astype(np.float32),
            rng.uniform(8, 300, n).astype(np.float32),
            np.where(rng.random(n) < 0.5, -1, 1).astype(np.int32))]
        kw = dict(nrows=400, ncols=320, dim=320,
                  scale_mult=tensors.scale_mult, rotated=angle_idx > 0,
                  angle_idx=angle_idx)
        before = pupil_cuda.pupil_walk_launches
        got = pupil_cuda.pupil_walk(tensors.codes, tensors.preds, *starts,
                                    pix, **kw)
        assert pupil_cuda.pupil_walk_launches == before + 1
        want = pupil_dense.walk(tensors.codes, tensors.preds, *starts, pix,
                                **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("trees", [1, 20, 32])
@pytest.mark.parametrize("depth", [1, 10])
def test_pupil_walk_edges_on_card(cuda_device, gray, trees, depth):
    """The walk kernel on seeded random forests at its edges: one tree, 20
    and a full warp's 32 trees a stage, depth 1 (the root is the last
    level: one leaf pair, no children pair) and 10, upright and rotated,
    with flipped walkers and a walker count that is no multiple of a
    block's walkers: bit-equal to the plain walk on (r, c, s)."""
    from pigo_tpu_torch.convert import pupil_forest_from_numpy

    rng = np.random.default_rng(100 * trees + depth)
    nc, stages, leaves = 3, 4, 1 << depth
    t = pupil_forest_from_numpy(
        rng.integers(-128, 128, (nc, stages, trees, leaves, 4),
                     dtype=np.int8),
        rng.uniform(-0.3, 0.3, (nc, stages, trees, leaves, 2)).astype(
            np.float32),
        stages=stages, trees=trees, depth=depth, scale_mult=0.9,
        device=cuda_device)
    warps = pupil_cuda.schedule()
    n = 7 * warps * 4 + 3
    assert n % warps
    pix = torch.from_numpy(gray.reshape(-1)).to(cuda_device)
    starts = [torch.from_numpy(a).to(cuda_device) for a in (
        rng.integers(0, nc, n).astype(np.int32),
        rng.uniform(0, 400, n).astype(np.float32),
        rng.uniform(0, 320, n).astype(np.float32),
        rng.uniform(8, 200, n).astype(np.float32),
        np.where(rng.random(n) < 0.5, -1, 1).astype(np.int32))]
    for a in (0, 8):
        kw = dict(nrows=400, ncols=320, dim=320, scale_mult=0.9,
                  rotated=a > 0, angle_idx=a)
        before = pupil_cuda.pupil_walk_launches
        got = pupil_cuda.pupil_walk(t.codes, t.preds, *starts, pix, **kw)
        assert pupil_cuda.pupil_walk_launches == before + 1
        want = pupil_dense.walk(t.codes, t.preds, *starts, pix, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want)), a


def test_pupil_walk_refuses_codes_off_the_card_layout(cuda_device):
    """Codes uploaded without convert.card_codes (an 8-byte aligned
    buffer) are refused before any launch: the kernel reads children
    pairs from the word before them."""
    from pigo_tpu_torch.models.pupil import PupilLocalizer

    t = PupilLocalizer(device=cuda_device).tensors
    plain = t.codes.clone()
    assert plain.data_ptr() % 8 == 0 and t.codes.data_ptr() % 8 == 4
    one = torch.ones(1, device=cuda_device)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    pix = torch.zeros(400 * 320, dtype=torch.uint8, device=cuda_device)
    before = pupil_cuda.pupil_walk_launches
    with pytest.raises(ValueError, match="card_codes"):
        pupil_cuda.pupil_walk(plain, t.preds, ids, one, one, one, ids + 1,
                              pix, nrows=400, ncols=320, dim=320,
                              scale_mult=t.scale_mult)
    assert pupil_cuda.pupil_walk_launches == before


@pytest.mark.parametrize("casc_id,runs", [(8, True), (-1, False),
                                          (9, False)])
def test_pupil_walk_faults_on_cascade_id_outside_forest(cuda_device, casc_id,
                                                        runs):
    """On the card a cascade id outside [0, NC) (NC = 9 landmark cascades)
    faults the walk's launch before any table read, so the next
    synchronisation raises; a valid id runs. In a child process, since the
    fault ends that process's CUDA context."""
    code = textwrap.dedent(f"""
        import torch
        from pigo_tpu_torch.models.landmark import LandmarkLocalizer
        from pigo_tpu_torch.ops import pupil_cuda

        t = LandmarkLocalizer().tensors
        ids = torch.zeros(64, dtype=torch.int32, device="cuda")
        ids[32] = {casc_id}
        start = torch.full((64,), 100.0, device="cuda")
        pix = torch.zeros(400 * 320, dtype=torch.uint8, device="cuda")
        pupil_cuda.pupil_walk(t.codes, t.preds, ids, start, start, start / 4,
                              torch.ones_like(ids), pix, nrows=400,
                              ncols=320, dim=320, scale_mult=t.scale_mult)
        torch.cuda.synchronize()
        print("synchronised", flush=True)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if runs:
        assert proc.returncode == 0, proc.stderr
        assert "synchronised" in proc.stdout
    else:
        assert proc.returncode != 0
        assert "synchronised" not in proc.stdout
        assert "error" in proc.stderr.lower(), proc.stderr


def test_face_detector_on_card_matches_golden(cuda_device, gray):
    """FaceDetector() on the card at the golden sample's configuration and
    frozen uniforms: the face, eyes and 15 points equal
    tests/golden/sample.json (eye scales within 1e-5 relative, as
    tests/test_golden.py allows), in one face_cascade launch and two
    pupil_walk launches."""
    import zlib

    with open(os.path.join(ROOT, "tests", "golden", "sample.json")) as fh:
        golden = json.load(fh)

    def uniforms(tag, k):
        rng = np.random.default_rng(zlib.crc32(tag.encode()))
        return rng.random((k, 63, 3), dtype=np.float32)

    c = golden["config"]
    det = FaceDetector()
    assert det.device.type == "cuda"
    before = (face_cuda.face_cascade_launches,
              pupil_cuda.pupil_walk_launches)
    res = det.detect(gray, 400, 320,
                     CascadeParams(c["min_size"], c["max_size"],
                                   c["shift_factor"], c["scale_factor"]),
                     iou_threshold=c["iou"],
                     uniforms=(uniforms("sample:face0:eyes", 2),
                               uniforms("sample:face0:lmk", 15)))
    assert (face_cuda.face_cascade_launches - before[0],
            pupil_cuda.pupil_walk_launches - before[1]) == (1, 2)
    [want] = golden["faces"]
    [got] = res
    assert [got.face.row, got.face.col, got.face.scale] == want["face"][:3]
    for e, w in zip(got.eyes, want["eyes"]):
        assert [e.row, e.col] == w[:2]
        assert abs(e.scale - w[2]) <= 1e-5 * e.scale
    assert [[p.row, p.col] for p in got.landmarks] == [
        w[2:4] for w in want["landmarks"]]


def test_cluster_device_matches_plain_on_card(cuda_device):
    """The cluster kernel is bit-equal to its plain version and to the
    host clustering at the detector's capacity, one launch a call: the
    smoke's random sets and the edge sets of tools/cluster_sets.py (every
    threshold from -0.1 to 1.0, scale-0 entries, fractional coordinates,
    holes in the valid mask and a count below the rows, the bit-word edges
    1 to 4096, identical entries, equal q, the pairs at the threshold);
    the edge sets that fit in 64 slots, and full random sets at 4608 slots
    (the host-tail device stream's) and at MAX_CAPACITY."""
    from pigo_tpu_torch.ops import cluster_device as cd
    from pigo_tpu_torch.ops.cluster import cluster_detections
    from pigo_tpu_torch.tools import cluster_sets

    cap = FaceCascade.HIT_CAPACITY
    runs = [(cs, cap) for cs in cluster_sets.random_sets(cap)
            + cluster_sets.edge_sets(cap)]
    # the smallest grid; the device stream's capacity with the host tail
    # (dense and tail slots), where the kernel asks for the most shared
    # memory; the largest rows
    runs += [(cs, 64) for cs in cluster_sets.edge_sets(64)]
    for slots in (4096 + 512, cd.MAX_CAPACITY):
        runs.append((cluster_sets.random_sets(slots)[-1], slots))
    for cs, cap in runs:
        args = (*cluster_sets.buffers(cs, cap, cuda_device), cs.iou)
        before = cd.cluster_device_launches
        got, gvalid = cd.cluster_device(*args, capacity=cap)
        assert cd.cluster_device_launches == before + 1, cs.name
        want, wvalid = cd.cluster_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(gvalid, wvalid), cs.name
        assert torch.equal(got.view(torch.int32),
                           want.view(torch.int32)), cs.name
        with np.errstate(invalid="ignore"):  # 0 / 0 of two scale-0 boxes
            host = cluster_detections(cs.entries(), cs.iou)
        assert np.array_equal(got[gvalid].cpu().numpy().view(np.int32),
                              host.astype(np.float32).view(np.int32)), \
            cs.name
        assert not cs.name.startswith("at_threshold") or \
            int(gvalid.sum()) == 2


def test_detect_stream_device_matches_detect_on_card(cuda_device, gray):
    """detect_stream_device on the card equals per-frame detect bit for
    bit on a few sample frames, with one face_cascade, one cluster_device
    and two pupil_walk launches and one host wait a frame."""
    from pigo_tpu_torch import detector as port_det
    from pigo_tpu_torch.ops import cluster_device as cd

    with open(os.path.join(ROOT, "tests", "golden", "sample.json")) as fh:
        c = json.load(fh)["config"]
    params = CascadeParams(c["min_size"], c["max_size"], c["shift_factor"],
                           c["scale_factor"])
    det = FaceDetector()
    frames = [np.roll(gray, i, axis=1) for i in range(4)]
    before = (face_cuda.face_cascade_launches, cd.cluster_device_launches,
              pupil_cuda.pupil_walk_launches, port_det.device_frame_waits)
    got = list(det.detect_stream_device(frames, params,
                                        iou_threshold=c["iou"], seed=7,
                                        depth=2))
    after = (face_cuda.face_cascade_launches, cd.cluster_device_launches,
             pupil_cuda.pupil_walk_launches, port_det.device_frame_waits)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 4, 8, 4)
    for i, (frame, res) in enumerate(zip(frames, got)):
        want = det.detect(frame, 400, 320, params, iou_threshold=c["iou"],
                          generator=torch.Generator().manual_seed(7 + i))
        assert [r.to_json_dict() for r in res] == \
            [r.to_json_dict() for r in want]
        assert [[p.scale for p in r.eyes + r.landmarks] + [r.face.q]
                for r in res] == [[p.scale for p in r.eyes + r.landmarks]
                                  + [r.face.q] for r in want]
        assert len(res) == 1 and len(res[0].landmarks) == 15


def test_host_tail_on_card_equals_all_card(cuda_device, gray):
    """FaceCascade(host_tail=True) on the card equals the all-card
    cascade on sample frames (stream, batch, upright and at 0.07) with one
    face_cascade launch a frame, and a host-tail detector's
    detect_stream_device equals its detect."""
    frames = [np.roll(gray, i, axis=1) for i in range(3)]
    ht = FaceCascade(host_tail=True)
    fc = FaceCascade()
    for angle in (0.0, 0.07):
        before = face_cuda.face_cascade_launches
        got = list(ht.stream_hits(frames, angle=angle, depth=2, **HEADLINE))
        assert face_cuda.face_cascade_launches == before + len(frames)
        want = list(fc.stream_hits(frames, angle=angle, depth=2, **HEADLINE))
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    for a, b in zip(ht.sparse_hits_batch(np.stack(frames), **HEADLINE),
                    fc.sparse_hits_batch(np.stack(frames), **HEADLINE)):
        assert np.array_equal(a, b)
    det = FaceDetector(host_tail=True)
    params = CascadeParams(20, 1000, 0.2, 1.1)
    got = list(det.detect_stream_device(frames, params, iou_threshold=0.1,
                                        seed=3, depth=2))
    for i, (frame, res) in enumerate(zip(frames, got)):
        want = det.detect(frame, 400, 320, params, iou_threshold=0.1,
                          generator=torch.Generator().manual_seed(3 + i))
        assert [r.to_json_dict() for r in res] == \
            [r.to_json_dict() for r in want]
        assert len(res) == 1


def test_sharded_bands_match_single_card_on_card(cuda_device, gray):
    """Every band of a 2- and a 4-rank mesh, run on the card in this
    process and merged, equals single-card sparse_hits bit for bit at the
    headline pyramid, upright and at 0.07, in the default and prefix
    routings, and through the re-read at hit capacity 1; each band makes
    one face_cascade launch."""
    from pigo_tpu_torch.parallel import ShardedFaceCascade, make_mesh

    for kw in ({}, {"prefix": True}):
        fc = FaceCascade(**kw)
        sh = ShardedFaceCascade(make_mesh(1), fc)
        tiny = ShardedFaceCascade(make_mesh(1), fc, hit_capacity=1)
        for angle in (0.0, 0.07):
            want = fc.sparse_hits(gray, 400, 320, angle=angle, **HEADLINE)
            assert want.shape[0] >= 2
            for n in (2, 4):
                before = face_cuda.face_cascade_launches
                got = sh.window_bands_hits(gray, 400, 320, n, angle=angle,
                                           **HEADLINE)
                assert face_cuda.face_cascade_launches == before + n
                assert np.array_equal(got, want)
                assert np.array_equal(tiny.window_bands_hits(
                    gray, 400, 320, n, angle=angle, **HEADLINE), want)


def test_stream_engine_on_card_equals_detect(cuda_device, gray):
    """web.engines.CudaStreamEngine on the card at 3 caller threads: the
    answers, as a multiset, equal detect(frame, seed + i) for every request
    index i, at the web server's defaults on a 480x640 frame."""
    from pigo_tpu_torch.web import bench_client, engines

    cfg = dict(min_size=100, max_size=600, shift=0.1, scale=1.1, iou=0.2)
    tiled = np.tile(gray, (2, 2))[:480, :640]
    bgr = np.repeat(tiled[:, :, None], 3, axis=2)
    det = FaceDetector()
    want = [engines.result_dicts(det.detect(
        tiled, 480, 640, CascadeParams(100, 600, 0.1, 1.1),
        iou_threshold=0.2, generator=torch.Generator().manual_seed(3 + i)))
        for i in range(12)]
    engine = engines.CudaStreamEngine(seed=3, depth=4, **cfg)
    try:
        got, _ = bench_client.run_engine(engine, [[("on", bgr)] * 4] * 3,
                                         300, **cfg)
    finally:
        engine.close()
    assert len(got) == 12 and bench_client.match_once(got, {"on": want})
    assert all(len(r) == 2 and len(r[0]["landmarks"]) == 15 for r in want)
