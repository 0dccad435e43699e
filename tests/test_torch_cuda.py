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

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceCascade
from pigo_tpu_torch.cascade.assets import load_facefinder
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.ops import face_cuda, face_dense, windows

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
