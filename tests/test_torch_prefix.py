"""The port's tree-prefix mode, dense tree cap and exact finish against the
JAX package.

pigo_tpu_torch.ops.face_cuda's routing (`route_plan`) against
pigo_tpu.ops.face_pallas.build_dense_plan; the prefix kernel's module
(`face_prefix` on CPU tensors, which runs its plain version) against the
TPU kernel `_multi_kernel_body` through `prefix_group_scores` in Pallas
interpret mode; the finish (`face_finish`) against a full-forest walk; and
`FaceCascade(prefix=True)` / `FaceCascade(tree_cap=K)` on the CPU against
the frozen golden corpus and the JAX package's NumPy oracle. The JAX
FaceCascade in prefix mode is not run here: in interpret mode it compiles
one Pallas kernel per scale and group. Inputs come from the repository's
assets or from numpy with fixed seeds and cross as numpy arrays. Exact
equality is the tolerance throughout.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigo_tpu.ops import face_pallas as fp
from pigo_tpu_torch import FaceCascade, cluster_detections
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.ops import face_cuda, face_dense, windows
from test_torch_face_kernel import (  # noqa: F401 (autouse fixture)
    one_torch_thread, random_forest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

GEOMETRIES = {
    # name: (rows, cols, (min, max, shift, scale))
    "headline": (400, 320, (20, 1000, 0.1, 1.1)),
    "hd1080": (1080, 1920, (40, 1080, 0.1, 1.1)),
    # test_face_kernels.py::test_tail_cutoff_boundary_routing: exactly
    # TAIL_MIN_WINDOWS windows (dense), and one column fewer (prefix)
    "cutoff_at": (212, 148, (20, 20, 0.1, 1.1)),
    "cutoff_below": (212, 146, (20, 20, 0.1, 1.1)),
}


def _golden(tag):
    with open(os.path.join(GOLDEN_DIR, tag + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_routing_matches_jax_plan(geometry, face_forest):
    """Per scale, the port's route (prefix or dense) and tree limit equal
    build_dense_plan's prefix_trees / tree_cap wherever the JAX package
    keeps the scale on the device; a scale it hands to its host engine
    runs on the card here: as a prefix scale in prefix mode (the 1080p
    tail, which the TPU's PREFIX_VMEM_BUDGET sends to the host), dense
    otherwise."""
    rows, cols, cfg = GEOMETRIES[geometry]
    plan = windows.build_window_plan(rows, cols, *cfg)
    t = face_forest.num_trees
    for prefix in (True, False):
        for cap in (0, 9):
            for angle_idx in (0, 2):
                jplan = fp.build_dense_plan(face_forest, rows, cols, *cfg,
                                            angle_idx=angle_idx,
                                            prefix=prefix, tree_cap=cap)
                routed = face_cuda.route_plan(plan, t, prefix=prefix,
                                              tree_cap=cap)
                assert [sp.scale for sp in jplan.scales] == list(plan.scales)
                for k, sp in enumerate(jplan.scales):
                    got = (bool(routed.prefix[k]), int(routed.t_limits[k]))
                    if sp.fallback:
                        tail = sp.nr_full * sp.nc_full < fp.TAIL_MIN_WINDOWS
                        assert got == ((True, fp.PREFIX_TREES)
                                       if prefix and tail
                                       else (False, 12 if cap else t))
                    else:
                        assert got == (bool(sp.prefix_trees),
                                       sp.prefix_trees or sp.tree_cap or t)
    counts = np.bincount(plan.scale_idx)
    routed = face_cuda.route_plan(plan, t, prefix=True)
    n_prefix = int(counts[routed.prefix].sum())
    want = {"headline": (22, 26411), "hd1080": (19, 22834),
            "cutoff_at": (0, 0), "cutoff_below": (1, 6048)}[geometry]
    assert (int(routed.prefix.sum()), n_prefix) == want
    # the prefix windows are the scan order's suffix, and one launch
    assert [s.prefix for s in routed.segments] == (
        [False] * (n_prefix < plan.num_windows) + [True] * (n_prefix > 0))


def test_cap_rounding_matches_jax(face_forest):
    from pigo_tpu.models.face import FaceCascade as JaxFaceCascade

    jfc = JaxFaceCascade(face_forest, backend="pallas", prefix=True)
    for cap in (0, 1, 8, 9, 32, 466, 467, 468, 500):
        want = jfc._resolved_cap(cap)
        assert face_cuda.resolved_cap(cap, face_forest.num_trees) == want
        assert FaceCascade(device="cpu", tree_cap=cap).tree_cap == want
    assert face_cuda.resolved_cap(9, 468) == 12
    assert face_cuda.resolved_cap(0, 468) == 0


def test_prefix_kernel_matches_pallas_interpret(monkeypatch):
    """face_prefix (plain version on the CPU) against the TPU kernel
    _multi_kernel_body run by prefix_group_scores in interpret mode (one
    compile): a random depth-3, 40-tree forest on a small frame whose
    three tail scales form one fused group; the per-scale blocks, flattened
    in scan order, equal the port's scores over the prefix range, and
    both outcomes occur."""
    monkeypatch.setattr(fp, "TAIL_MIN_WINDOWS", 200)
    monkeypatch.setattr(face_cuda, "TAIL_MIN_WINDOWS", 200)
    forest = random_forest(9, depth=3, trees=40, thresh=-1.0)
    frame = np.random.default_rng(9).integers(0, 256, (48, 56),
                                              dtype=np.uint8)
    rows, cols = frame.shape
    cfg = (12, 40, 0.1, 1.2)
    jplan = fp.build_dense_plan(forest, rows, cols, *cfg, prefix=True)
    [group] = fp.prefix_groups(jplan)
    assert len(group) == 3
    tables = jnp.concatenate([
        jnp.asarray(sp.tables[:sp.prefix_trees].reshape(-1))
        for sp in group])
    blocks = fp.prefix_group_scores(
        jnp.asarray(frame, jnp.float32), group, forest, tables,
        jnp.asarray(forest.preds.reshape(-1)), jnp.asarray(forest.thresh),
        interpret=True)
    want = np.concatenate([np.asarray(b).reshape(-1) for b in blocks])

    plan = windows.build_window_plan(rows, cols, *cfg)
    routed = face_cuda.route_plan(plan, forest.num_trees, prefix=True)
    [seg] = [s for s in routed.segments if s.prefix]
    assert seg.hi == plan.num_windows and seg.t_limit == 32
    assert list(plan.scales[routed.prefix]) == [sp.scale for sp in group]
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    base, scale = face_cuda.device_plan(plan, torch.device("cpu"))
    got = face_cuda.face_prefix(
        torch.from_numpy(frame[None]), base[seg.lo:seg.hi],
        scale[seg.lo:seg.hi], ft.codes, ft.preds, ft.thresh, seg.t_limit)
    assert got.shape == (1, seg.hi - seg.lo)
    assert np.array_equal(got[0].numpy(), want)
    assert (want == -1.0).any() and (want == face_dense.PREFIX_MARK).any()


@pytest.mark.parametrize("angle_idx", [0, 4])
def test_finish_matches_full_forest(angle_idx):
    """face_cascade capped at 12 trees, then face_finish over a column
    range of the scores, equals the full-forest walk: marked windows get
    their exact score in place, every other score and the columns outside
    the range stay."""
    forest = random_forest(12, depth=3, trees=40, thresh=-1.0)
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    frames = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (2, 50, 60), dtype=np.uint8))
    plan = windows.build_window_plan(50, 60, 10, 40, 0.1, 1.2)
    base, scale = face_cuda.device_plan(plan, torch.device("cpu"))
    args = (frames, base, scale, ft.codes, ft.preds, ft.thresh)
    kw = dict(angle_idx=angle_idx)
    full = face_cuda.face_cascade(*args, ft.num_trees, **kw)
    q = face_cuda.face_cascade(*args, 12, **kw)
    marked = q == face_dense.PREFIX_MARK
    assert marked.any() and (full[marked] == -1.0).any()
    assert (full[marked] > 0).any()
    lo, hi = 5, plan.num_windows
    before = q.clone()
    face_cuda.face_finish(frames, base[lo:hi], scale[lo:hi], ft.codes,
                          ft.preds, ft.thresh, q[:, lo:], **kw)
    assert torch.equal(q[:, lo:], full[:, lo:])
    assert torch.equal(q[:, :lo], before[:, :lo])


def test_prefix_wrapper_limits():
    """face_prefix refuses a tree limit whose staged tables exceed the
    shared memory it asks for (on either device, before any launch), and a
    tree limit that is not below the forest size."""
    forest = random_forest(13, depth=8, trees=40)
    ft = face_forest_from_numpy(forest.depth, forest.codes, forest.preds,
                                forest.thresh)
    frames = torch.zeros((1, 600, 600), dtype=torch.uint8)
    base = torch.full((2,), 300 * 600 + 300, dtype=torch.int32)
    scale = torch.full((2,), 100, dtype=torch.int32)
    args = (frames, base, scale, ft.codes, ft.preds, ft.thresh)
    assert face_cuda.prefix_smem_bytes(32, 64) == 16512
    assert face_cuda.prefix_smem_bytes(32, 256) > face_cuda.PREFIX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        face_cuda.face_prefix(*args, 32)
    assert face_cuda.face_prefix(*args, 16).shape == (1, 2)
    for t_limit in (0, 40):
        with pytest.raises(ValueError):
            face_cuda.face_prefix(*args, t_limit)


@pytest.mark.parametrize("mode", ["prefix", "cap8"])
@pytest.mark.parametrize("tag", ["sample_dense", "strided", "wide"])
def test_modes_match_golden(tag, mode):
    """FaceCascade(prefix=True) and FaceCascade(tree_cap=8) on the CPU
    reproduce the frozen upright detections and their clusters, and the
    detections at angle 0.07 (strided: the tall frame whose rotated pass
    reads through its stride)."""
    from pigo_tpu.tools.make_golden import fixture_frame

    golden = _golden(tag)
    gray, rows, cols, dim = fixture_frame(golden["image"])
    c = golden["config"]
    cfg = dict(min_size=c["min_size"], max_size=c["max_size"],
               shift_factor=c["shift_factor"], scale_factor=c["scale_factor"])
    kw = dict(prefix=True) if mode == "prefix" else dict(tree_cap=8)
    fc = FaceCascade(device="cpu", **kw)
    for angle, want in [(0.0, golden["detections"])] + [
            (r["angle"], r["detections"]) for r in golden["rotations"][:1]]:
        dets = fc.run_cascade(gray, rows, cols, dim, angle=angle, **cfg)
        want = np.asarray(want, np.float64).reshape(-1, 4)
        assert np.array_equal(dets, want)
        if angle == 0.0:
            assert np.array_equal(cluster_detections(dets, c["iou"]),
                                  np.asarray(golden["clusters"], np.float64))


@pytest.mark.parametrize("angle", [0.0, 0.07])
@pytest.mark.parametrize("mode", ["prefix", "cap8"])
def test_prefix_and_cap_oracle_exact(mode, angle, sample_gray, face_forest,
                                     monkeypatch):
    """The 96x88 face frame of test_face_kernels.py's
    test_prefix_mode_oracle_exact with TAIL_MIN_WINDOWS at 512: three
    prefix scales with real survivors. FaceCascade(prefix=True) and
    FaceCascade(tree_cap=8) equal the NumPy oracle, upright and rotated;
    marks were made and finished (a detection on a marked scale, or marks
    in the prefix pass), and window_scores carries no mark."""
    from PIL import Image

    from pigo_tpu.oracle.face import oracle_run_cascade

    monkeypatch.setattr(face_cuda, "TAIL_MIN_WINDOWS", 512)
    face = np.asarray(Image.fromarray(sample_gray).resize((30, 37)), np.uint8)
    frame = np.full((96, 88), 190, np.uint8)
    frame[30:67, 28:58] = face
    rows, cols = frame.shape
    cfg = dict(min_size=20, max_size=60, shift_factor=0.1, scale_factor=1.3)
    kw = dict(prefix=True) if mode == "prefix" else dict(tree_cap=8)
    fc = FaceCascade.from_forest(face_forest, device="cpu", **kw)
    want = oracle_run_cascade(face_forest, frame.ravel(), rows, cols, cols,
                              *cfg.values(), angle=angle)
    dets = fc.run_cascade(frame, rows, cols, angle=angle, **cfg)
    assert dets.shape == want.shape and dets.shape[0] >= 1
    assert np.array_equal(dets, want)

    a = int(32 * angle)
    routed, base, scale = fc._plan(rows, cols, *cfg.values(), angle_idx=a)
    marked_scales = set(routed.windows.scales[
        routed.t_limits < face_forest.num_trees].tolist())
    if mode == "prefix":
        assert sorted(marked_scales) == [33, 42, 54]
        [seg] = [s for s in routed.segments if s.prefix]
        f = fc.tensors
        marks = face_cuda.face_prefix(
            torch.from_numpy(frame[None]), base[seg.lo:seg.hi],
            scale[seg.lo:seg.hi], f.codes, f.preds, f.thresh, seg.t_limit,
            angle_idx=a)
        assert (marks == face_dense.PREFIX_MARK).any()
    if mode == "cap8" or angle == 0.0:
        assert any(int(s) in marked_scales for s in dets[:, 2])
    coords, q = fc.window_scores(frame, rows, cols, cols, *cfg.values(),
                                 angle=angle)
    assert not (q >= face_dense.PREFIX_MARK / 2).any()
    assert np.array_equal(coords[q > 0], want[:, :3].astype(coords.dtype))
    assert np.array_equal(q[q > 0], want[:, 3].astype(np.float32))


def test_launches_per_mode(sample_gray, monkeypatch):
    """The launches each mode enqueues per frame (or batch), counted by
    wrapping the three wrappers on the CPU: default 1 (cascade); prefix 3
    (cascade, prefix, finish); tree cap 2 (cascade, finish); both 3. Each
    mode's stream_hits equals the default mode's, frame by frame (one dense
    scale of 1,102 windows under a monkeypatched TAIL_MIN_WINDOWS, the
    other ten scales prefix)."""
    calls = []
    for name in ("face_cascade", "face_prefix", "face_finish"):
        fn = getattr(face_cuda, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(face_cuda, name, counted)
    monkeypatch.setattr(face_cuda, "TAIL_MIN_WINDOWS", 1000)
    frames = [sample_gray, np.roll(sample_gray, 3, axis=1)]
    cfg = dict(min_size=60, max_size=400, shift_factor=0.15,
               scale_factor=1.2)
    want = list(FaceCascade(device="cpu").stream_hits(frames, **cfg))
    assert calls == ["face_cascade"] * 2 and want[0].shape[0] > 0
    for kw, per_frame in (
            (dict(prefix=True),
             ["face_cascade", "face_prefix", "face_finish"]),
            (dict(tree_cap=32), ["face_cascade", "face_finish"]),
            (dict(prefix=True, tree_cap=32),
             ["face_cascade", "face_prefix", "face_finish"])):
        calls.clear()
        got = list(FaceCascade(device="cpu", **kw).stream_hits(frames, **cfg))
        assert calls == per_frame * 2, kw
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    calls.clear()
    batch = FaceCascade(device="cpu", prefix=True).sparse_hits_batch(
        np.stack(frames), **cfg)
    assert calls == ["face_cascade", "face_prefix", "face_finish"]
    assert all(np.array_equal(g, w) for g, w in zip(batch, want))
