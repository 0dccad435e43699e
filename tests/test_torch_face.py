"""The port's upright face-detection path against the JAX package.

pigo_tpu_torch.models.face.FaceCascade on CPU tensors (the kernel wrapper
then runs the plain PyTorch version) against the frozen golden corpus and
against pigo_tpu's own FaceCascade, plus the serving entry points
(stream_hits, sparse_hits_batch, the hit-capacity overflow re-read) and the
package's rules: no jax and nothing of pigo_tpu imported, no silent CPU
fallback, no silent upright run of a rotated request. Inputs come from the
repository's assets or from numpy with fixed seeds and cross as numpy
arrays. Exact equality is the tolerance throughout.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceCascade, cluster_detections
from pigo_tpu_torch.models import face as port_face
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
HEADLINE = dict(min_size=20, max_size=1000, shift_factor=0.1,
                scale_factor=1.1)


def _golden(tag):
    with open(os.path.join(GOLDEN_DIR, tag + ".json")) as fh:
        return json.load(fh)


def _cfg(golden):
    c = golden["config"]
    return dict(min_size=c["min_size"], max_size=c["max_size"],
                shift_factor=c["shift_factor"], scale_factor=c["scale_factor"])


@pytest.fixture(scope="module")
def fc():
    return FaceCascade(device="cpu")


def test_unpack_face_cascade_matches_jax():
    from pigo_tpu.cascade.format import unpack_face_cascade as jax_unpack
    from pigo_tpu_torch.cascade.assets import asset_path, load_facefinder
    from pigo_tpu_torch.cascade.format import unpack_face_cascade

    with open(asset_path("cascade", "facefinder"), "rb") as fh:
        raw = fh.read()
    want = jax_unpack(raw)
    for got in (unpack_face_cascade(raw), load_facefinder()):
        assert got.depth == want.depth == 6
        assert got.num_trees == want.num_trees == 468
        for name in ("codes", "preds", "thresh"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    with pytest.raises(ValueError):
        unpack_face_cascade(raw[:100])


def test_sample_gray_npy_is_the_decoded_frame(sample_gray):
    """The committed frame (read where Pillow is missing) is the JAX
    package's decode of sample.jpg, and the port's decoder agrees."""
    from pigo_tpu.io.image import get_image as jax_get_image
    from pigo_tpu.io.image import rgb_to_grayscale as jax_gray
    from pigo_tpu_torch.cascade.assets import asset_path
    from pigo_tpu_torch.io.image import get_image, rgb_to_grayscale

    path = asset_path("testdata", "sample.jpg")
    want = jax_gray(jax_get_image(path)).reshape(400, 320)
    npy = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                               "sample_gray.npy"))
    assert npy.dtype == np.uint8 and npy.shape == (400, 320)
    assert np.array_equal(npy, want) and np.array_equal(npy, sample_gray)
    assert np.array_equal(rgb_to_grayscale(get_image(path)).reshape(400, 320),
                          want)


@pytest.mark.parametrize(
    "tag", ["sample", "test", "sample_dense", "wide", "strided", "alpha"])
def test_golden_upright(tag, fc):
    """Detections and clusters equal the frozen corpus (strided runs the
    exact de-stride of a row stride dim > cols)."""
    from pigo_tpu.tools.make_golden import fixture_frame

    golden = _golden(tag)
    gray, rows, cols, dim = fixture_frame(golden["image"])
    cfg = _cfg(golden)
    dets = fc.run_cascade(gray, rows, cols, dim, **cfg)
    want = np.asarray(golden["detections"], np.float64).reshape(-1, 4)
    assert dets.dtype == np.float64 and dets.shape == want.shape
    assert np.array_equal(dets, want)
    clusters = fc.detect(gray, rows, cols, dim,
                         iou_threshold=golden["config"]["iou"], **cfg)
    want_cl = np.asarray(golden["clusters"], np.float64).reshape(-1, 4)
    assert np.array_equal(clusters, want_cl)


def test_matches_jax_face_cascade_on_crop(fc, face_forest, sample_gray):
    """The port against pigo_tpu.models.face.FaceCascade on the sample at
    half size, with the JAX package's forest carried across
    (FaceCascade.from_forest)."""
    from pigo_tpu.models.face import FaceCascade as JaxFaceCascade

    crop = np.ascontiguousarray(sample_gray[::2, ::2])
    rows, cols = crop.shape
    cfg = dict(min_size=60, max_size=160, shift_factor=0.1, scale_factor=1.1)
    want = JaxFaceCascade().run_cascade(crop, rows, cols, **cfg)
    port = FaceCascade.from_forest(face_forest, device="cpu")
    got = port.run_cascade(crop, rows, cols, **cfg)
    assert want.shape[0] > 0
    assert np.array_equal(got, want)
    assert np.array_equal(fc.run_cascade(crop, rows, cols, **cfg), want)


def test_window_scores_matches_jax_reference(fc, sample_gray):
    from pigo_tpu.models.face import FaceCascade as JaxFaceCascade

    crop = np.ascontiguousarray(sample_gray[::2, ::2])
    rows, cols = crop.shape
    args = (rows, cols, cols, 80, 160, 0.1, 1.2)
    want_c, want_q = JaxFaceCascade(backend="reference").window_scores(
        crop, *args)
    got_c, got_q = fc.window_scores(crop, *args)
    assert np.array_equal(got_c, want_c)
    assert got_q.dtype == np.float32 and np.array_equal(got_q, want_q)
    assert (got_q > 0).any() and (got_q == -1.0).any()


def _stream_frames(sample_gray, n):
    return [np.roll(sample_gray, i % 4, axis=1) for i in range(n)]


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_hits_order_and_parity(fc, sample_gray, depth):
    frames = _stream_frames(sample_gray, 6)
    # frames 1..3 shift the face; a blank frame has no hits
    frames[4] = np.full_like(sample_gray, 128)
    want = [fc.run_cascade(f, 400, 320, **HEADLINE) for f in frames]
    got = list(fc.stream_hits(iter(frames), depth=depth, **HEADLINE))
    assert len(got) == len(frames)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[4].shape == (0, 4) and got[0].shape[0] == 22
    assert not np.array_equal(got[0], got[1])  # order is input order


def test_sparse_hits_batch(fc, sample_gray):
    frames = np.stack(_stream_frames(sample_gray, 4))
    want = [fc.sparse_hits(f, 400, 320, **HEADLINE) for f in frames]
    got = fc.sparse_hits_batch(frames, **HEADLINE)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    got_t = fc.sparse_hits_batch(torch.from_numpy(frames), **HEADLINE)
    assert all(np.array_equal(g, w) for g, w in zip(got_t, want))
    with pytest.raises(ValueError):
        fc.sparse_hits_batch(frames[0], **HEADLINE)


def test_hit_capacity_overflow_reread(sample_gray, monkeypatch):
    """More hits than HIT_CAPACITY: the dense re-read gives the same
    detections as an ample capacity."""
    fc_big = FaceCascade(device="cpu")
    want = fc_big.run_cascade(sample_gray, 400, 320, **HEADLINE)
    assert want.shape[0] == 22
    monkeypatch.setattr(FaceCascade, "HIT_CAPACITY", 5)
    fc_tiny = FaceCascade(device="cpu")
    assert np.array_equal(
        fc_tiny.run_cascade(sample_gray, 400, 320, **HEADLINE), want)
    frames = np.stack([sample_gray, np.full_like(sample_gray, 9)])
    batch = fc_tiny.sparse_hits_batch(frames, **HEADLINE)
    assert np.array_equal(batch[0], want) and batch[1].shape == (0, 4)


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_compact_hits_packs_scan_order(cap):
    rng = np.random.default_rng(cap)
    q = rng.uniform(-1.0, 1.0, (3, 40)).astype(np.float32)
    q[q < 0] = -1.0
    q[2] = -1.0  # a frame without hits
    packed = port_face.compact_hits(torch.from_numpy(q), cap).numpy()
    assert packed.shape == (3, 1 + 2 * cap) and packed.dtype == np.float32
    for i in range(3):
        idx = np.nonzero(q[i] > 0)[0]
        assert packed[i, 0] == idx.size
        n = min(idx.size, cap)
        assert np.array_equal(packed[i, 1:1 + n], idx[:n])
        assert np.all(packed[i, 1 + n:1 + cap] == -1.0)
        assert np.array_equal(packed[i, 1 + cap:1 + cap + n], q[i, idx[:n]])


def test_frame_smaller_than_min_face(fc):
    frame = np.zeros((12, 15), np.uint8)
    assert fc.run_cascade(frame, 12, 15).shape == (0, 4)
    assert [h.shape for h in fc.sparse_hits_batch(frame[None])] == [(0, 4)]
    coords, q = fc.window_scores(frame, 12, 15, 15, 20, 100, 0.1, 1.1)
    assert coords.shape == (0, 3) and q.shape == (0,)


def test_rotated_request_raises(fc, face_forest, sample_gray):
    """A rotated request runs the rotated cascade in every entry point,
    never upright: each gives the NumPy oracle's rotated hits (which differ
    from the upright ones), and it raises where an upright request does
    (a row stride below cols)."""
    from pigo_tpu.oracle.face import oracle_run_cascade

    crop = np.ascontiguousarray(sample_gray[::2, ::2])
    rows, cols = crop.shape
    cfg = dict(min_size=40, max_size=160, shift_factor=0.1, scale_factor=1.1)
    want = oracle_run_cascade(face_forest, crop.ravel(), rows, cols, cols,
                              *cfg.values(), angle=0.1)
    upright = fc.run_cascade(crop, rows, cols, **cfg)
    assert want.shape[0] > 0 and not np.array_equal(want, upright)
    frames = np.stack([crop])
    got = [
        fc.run_cascade(crop, rows, cols, angle=0.1, **cfg),
        fc.sparse_hits(crop, rows, cols, angle=0.1, **cfg),
        fc.sparse_hits_batch(frames, angle=0.1, **cfg)[0],
        list(fc.stream_hits(frames, angle=0.1, **cfg))[0],
    ]
    for dets in got:
        assert np.array_equal(dets, want)
    assert np.array_equal(fc.detect(crop, rows, cols, angle=0.1, **cfg),
                          cluster_detections(want, 0.2))
    coords, q = fc.window_scores(crop, rows, cols, cols, *cfg.values(),
                                 angle=0.1)
    assert np.array_equal(coords[q > 0], want[:, :3].astype(np.int32))
    with pytest.raises(ValueError, match="dim"):
        fc.run_cascade(crop, rows, cols, cols - 1, angle=0.1, **cfg)


def test_default_device_needs_a_card():
    """device=None means the CUDA card: without one, construction raises
    instead of carrying on on the CPU."""
    from pigo_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert FaceCascade().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceCascade()
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceCascade(device="cuda")
    with pytest.raises(ValueError):
        resolve_device("mps")
    assert resolve_device("cpu") == torch.device("cpu")


def test_loaders_and_cluster_export(face_forest):
    from pigo_tpu.ops.cluster import cluster_detections as jax_cluster
    from pigo_tpu_torch.cascade.assets import asset_path

    path = asset_path("cascade", "facefinder")
    with open(path, "rb") as fh:
        raw = fh.read()
    for port in (FaceCascade.from_file(path, device="cpu"),
                 FaceCascade.from_bytes(raw, device="cpu")):
        assert np.array_equal(port.tensors.codes.numpy(), face_forest.codes)
        assert np.array_equal(port.tensors.thresh.numpy(), face_forest.thresh)
    dets = np.asarray(_golden("wide")["detections"], np.float64)
    for iou in (0.1, 0.3):
        assert np.array_equal(cluster_detections(dets, iou),
                              jax_cluster(dets, iou))


def test_package_imports_without_jax_pigo_tpu_or_pillow():
    """`import pigo_tpu_torch` and every module of it (walked with
    pkgutil.walk_packages: the host engine, the CLI, the drawing, the
    tools and the web server among them) load no jax, no pigo_tpu module,
    nothing of examples/, no Pillow and no OpenCV. Run in a fresh
    interpreter: this one has imported jax already."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["PIL"] = None  # importing Pillow would fail
sys.modules["cv2"] = None  # and OpenCV
import pigo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pigo_tpu_torch.__path__,
                                               "pigo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("MODULES", len(names), sorted(names))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "pigo_tpu" or m.startswith("pigo_tpu.")
             or m in ("common", "examples") or m.startswith("examples."))
print("BAD", bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout
    for name in ("native", "cli", "io.draw", "utils.spinner", "detector",
                 "tools.face_sweep", "ops.cluster_device", "web.engines",
                 "web.main", "web.bench_client"):
        assert f"'pigo_tpu_torch.{name}'" in proc.stdout, name
