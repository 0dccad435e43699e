"""The port's pupil/landmark path against the JAX package.

pigo_tpu_torch: the cascade parser and weight carrier, the plain PyTorch
walk (ops/pupil_dense), the kernel wrapper (ops/pupil_cuda, which runs the
plain version on CPU tensors) and the two localizers. Inputs are the
repository's assets, the golden corpus, or numpy arrays from fixed seeds,
and cross as numpy arrays.

The tolerance is exact equality throughout, with one exception that is a
fault of the reference on XLA:CPU, not of the port (ROADMAP.md, queue 3):
inside `jax.jit`, XLA folds the per-stage `s * scale_mult` chain into one
product with a pre-multiplied constant, so the jitted JAX walk's scale (and
the positions that use it) can differ from the reference's f32 arithmetic
by an ulp per stage. The port follows the reference, as the NumPy oracle
does; it is held bit for bit against the oracle and against the JAX
functions run op by op (un-jitted, or under `jax.disable_jit()`), and
against the jitted ones within the 1e-5 relative scale tolerance that
tests/test_golden.py allows the JAX package.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigo_tpu.cascade import assets as jax_assets
from pigo_tpu.cascade import format as jax_format
from pigo_tpu.models.landmark import LandmarkLocalizer as JaxLandmarks
from pigo_tpu.models.pupil import PupilLocalizer as JaxPupil
from pigo_tpu.models.pupil import Puploc as JaxPuploc
from pigo_tpu.ops import pupil_dense as jax_dense
from pigo_tpu.ops import pupil_patch
from pigo_tpu.oracle import pupil as oracle
from pigo_tpu_torch import LandmarkLocalizer, PupilLocalizer, Puploc
from pigo_tpu_torch.cascade import assets, format as port_format
from pigo_tpu_torch.convert import pupil_forest_from_numpy
from pigo_tpu_torch.ops import pupil_cuda, pupil_dense
from pigo_tpu_torch.utils.build import LAUNCHES
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TAGS = ["sample", "sample_dense", "wide", "alpha"]


@pytest.fixture(scope="module")
def jax_plc():
    return JaxPupil()


@pytest.fixture(scope="module")
def jax_flp():
    return JaxLandmarks()


@pytest.fixture(scope="module")
def plc():
    return PupilLocalizer(device="cpu")


@pytest.fixture(scope="module")
def flp():
    return LandmarkLocalizer(device="cpu")


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).reshape(-1).view(np.int32)


def _starts(rng, n, rows, cols, smin, smax, n_casc=1):
    """Seeded walker inputs: casc_id, r0, c0, s0, col_sign (numpy)."""
    return (rng.integers(0, n_casc, n).astype(np.int32),
            rng.uniform(10, rows - 10, n).astype(np.float32),
            rng.uniform(10, cols - 10, n).astype(np.float32),
            rng.uniform(smin, smax, n).astype(np.float32),
            np.where(rng.random(n) < 0.5, -1, 1).astype(np.int32))


def _port_walk(tensors, starts, gray, rotated=False, angle_idx=0,
               walk=pupil_dense.walk):
    rows, cols = gray.shape
    return walk(tensors.codes, tensors.preds,
                *(torch.from_numpy(np.array(a)) for a in starts),
                torch.from_numpy(gray.reshape(-1)), nrows=rows, ncols=cols,
                dim=cols, scale_mult=tensors.scale_mult, rotated=rotated,
                angle_idx=angle_idx)


def test_unpack_pupil_cascades_match_jax():
    files = [("puploc", assets.asset_path("cascade", "puploc"))] + [
        (n, assets.asset_path("cascade", "lps", n))
        for n in sorted(os.listdir(assets.asset_path("cascade", "lps")))]
    port_lps = assets.load_landmark_dir()
    assert sorted(port_lps) == sorted(jax_assets.load_landmark_dir())
    for name, path in files:
        with open(path, "rb") as fh:
            raw = fh.read()
        want = jax_format.unpack_pupil_cascade(raw)
        loaded = (assets.load_puploc() if name == "puploc"
                  else port_lps[name])
        for got in (port_format.unpack_pupil_cascade(raw), loaded):
            assert (got.stages, got.trees, got.depth, got.scale_mult) == (
                want.stages, want.trees, want.depth, want.scale_mult)
            for field in ("codes", "preds"):
                a, b = getattr(got, field), getattr(want, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (assets.EYE_CASCADES, assets.MOUTH_CASCADES,
            assets.NOSE_CASCADE) == (jax_assets.EYE_CASCADES,
                                     jax_assets.MOUTH_CASCADES,
                                     jax_assets.NOSE_CASCADE)
    with pytest.raises(ValueError):
        port_format.unpack_pupil_cascade(raw[:100])


def test_pupil_forest_from_numpy_both_layouts(jax_plc, jax_flp):
    """The JAX package's packed int32 device layout and the int8 arrays
    give identical tensors: the shipped puploc, the nine stacked landmark
    cascades, and a random forest packed by pigo_tpu's pack_codes."""
    f = jax_plc.forest
    geom = dict(stages=f.stages, trees=f.trees, depth=f.depth,
                scale_mult=f.scale_mult)
    a = pupil_forest_from_numpy(f.codes, f.preds, **geom)
    b = pupil_forest_from_numpy(np.asarray(jax_plc.codes),
                                np.asarray(jax_plc.preds), **geom)
    assert a.codes.shape == (1, 5, 20, 1024, 4)
    assert a.preds.shape == (1, 5, 20, 1024, 2)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.preds, b.preds)
    assert a.scale_mult == b.scale_mult == float(np.float32(0.8))

    g = jax_flp.geometry
    lgeom = dict(stages=g.stages, trees=g.trees, depth=g.depth,
                 scale_mult=g.scale_mult)
    names = jax_flp.names
    a = pupil_forest_from_numpy(
        np.stack([jax_flp.cascades[n].codes for n in names]),
        np.stack([jax_flp.cascades[n].preds for n in names]), **lgeom)
    b = pupil_forest_from_numpy(np.asarray(jax_flp.codes),
                                np.asarray(jax_flp.preds), **lgeom)
    assert a.codes.shape == (9, 6, 20, 512, 4)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.preds, b.preds)

    rng = np.random.default_rng(7)
    codes = rng.integers(-128, 128, (2, 3, 8, 4)).astype(np.int8)
    preds = rng.standard_normal((2, 3, 8, 2)).astype(np.float32)
    rand = jax_format.PupilForest(stages=2, scale_mult=0.75, trees=3,
                                  depth=3, codes=codes, preds=preds)
    rgeom = dict(stages=2, trees=3, depth=3, scale_mult=0.75)
    a = pupil_forest_from_numpy(codes, preds, **rgeom)
    b = pupil_forest_from_numpy(jax_dense.pack_codes(rand).reshape(-1),
                                preds.reshape(-1), **rgeom)
    assert torch.equal(a.codes, b.codes) and torch.equal(a.preds, b.preds)
    assert np.array_equal(a.codes[0].numpy(), codes)
    for bad in ((codes.astype(np.int16), preds), (codes, preds[..., :1]),
                (codes[:1], preds.astype(np.float64))):
        with pytest.raises(ValueError):
            pupil_forest_from_numpy(*bad, **rgeom)


CASES = [
    # (name, cascades, rotated angle_idx)
    ("eyes", "puploc", 0),
    ("eyes_rotated", "puploc", 8),
    ("landmarks", "lps", 0),
]


@pytest.mark.parametrize("name,which,angle_idx", CASES)
def test_plain_walk_matches_oracle_and_jax(name, which, angle_idx,
                                           sample_gray, plc, flp, jax_plc,
                                           jax_flp):
    """Bit for bit against the Go-faithful oracle and the JAX walk run op
    by op; the jitted JAX walk within 1e-5 relative (see the module
    docstring). Mixed flips, and several landmark cascades in one walk."""
    rows, cols = sample_gray.shape
    rotated = angle_idx > 0
    tensors, jax_loc = ((plc.tensors, jax_plc) if which == "puploc"
                        else (flp.tensors, jax_flp))
    n_casc = tensors.codes.shape[0]
    rng = np.random.default_rng(11 + angle_idx)
    starts = _starts(rng, 48, rows, cols, 10, 150, n_casc)
    got = [v.numpy() for v in _port_walk(tensors, starts, sample_gray,
                                         rotated, angle_idx)]

    # the oracle runs one cascade and one flip at a time
    forests = ([jax_plc.forest] if which == "puploc"
               else [jax_flp.cascades[n] for n in jax_flp.names])
    cid, r0, c0, s0, sign = starts
    for k in range(n_casc):
        for flip in (False, True):
            sel = (cid == k) & ((sign < 0) == flip)
            if not sel.any():
                continue
            if rotated:
                want = oracle.oracle_pupil_rotated_walk(
                    forests[k], r0[sel], c0[sel], s0[sel], angle_idx / 32.0,
                    rows, cols, sample_gray.ravel(), cols, flip)
            else:
                want = oracle.oracle_pupil_walk(
                    forests[k], r0[sel], c0[sel], s0[sel], rows, cols,
                    sample_gray.ravel(), cols, flip)
            for a, b in zip(got, want):
                assert np.array_equal(_bits(a[sel]), _bits(b)), (name, k)

    f = forests[0]
    kw = dict(stages=f.stages, trees=f.trees, depth=f.depth, nrows=rows,
              ncols=cols, dim=cols, scale_mult=float(f.scale_mult),
              rotated=rotated, angle_idx=angle_idx)
    args = (jax_loc.codes, jax_loc.preds,
            *(jnp.asarray(a) for a in (cid, r0, c0, s0, sign)),
            jnp.asarray(sample_gray.reshape(-1)))
    eager = jax_dense._walk_impl(*args, **kw)
    for a, b in zip(got, eager):
        assert np.array_equal(_bits(a), _bits(b)), name
    jitted = jax_dense.walk(*args, **kw)
    for a, b in zip(got, jitted):
        b = np.asarray(b)
        assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b)), name


def test_ensemble_matches_jax(sample_gray, plc, flp, jax_plc, jax_flp):
    """jitter -> walk -> median, bit for bit against the JAX ensemble run
    op by op, for eyes (upright and rotated) and landmarks."""
    rows, cols = sample_gray.shape
    rng = np.random.default_rng(5)
    for tensors, jax_loc, geom, n_casc, angle_idx in (
            (plc.tensors, jax_plc, jax_plc.forest, 1, 0),
            (plc.tensors, jax_plc, jax_plc.forest, 1, 8),
            (flp.tensors, jax_flp, jax_flp.geometry, 9, 0)):
        g, p = 5, 15
        cid = rng.integers(0, n_casc, g).astype(np.int32)
        rows0 = rng.uniform(100, 300, g).astype(np.float32)
        cols0 = rng.uniform(80, 240, g).astype(np.float32)
        scales0 = rng.uniform(20, 120, g).astype(np.float32)
        flips = rng.random(g) < 0.5
        u = rng.random((g, p, 3), dtype=np.float32)
        got = pupil_dense.ensemble(
            tensors.codes, tensors.preds,
            *(torch.from_numpy(a) for a in (cid, rows0, cols0, scales0,
                                           flips, u, sample_gray.ravel())),
            nrows=rows, ncols=cols, dim=cols, scale_mult=tensors.scale_mult,
            rotated=angle_idx > 0, angle_idx=angle_idx)
        want = jax_dense._ensemble_impl(
            jax_loc.codes, jax_loc.preds,
            *(jnp.asarray(a) for a in (cid, rows0, cols0, scales0, flips, u,
                                       sample_gray.ravel())),
            stages=geom.stages, trees=geom.trees, depth=geom.depth,
            nrows=rows, ncols=cols, dim=cols,
            scale_mult=float(geom.scale_mult), rotated=angle_idx > 0,
            angle_idx=angle_idx)
        assert got.shape == (3, g)
        assert np.array_equal(_bits(got.numpy()), _bits(want))


def test_make_perturbations_and_median_match_jax():
    rng = np.random.default_rng(3)
    u = rng.random((4, 63, 3), dtype=np.float32)
    row = rng.uniform(0, 500, (4, 1)).astype(np.float32)
    col = rng.uniform(0, 500, (4, 1)).astype(np.float32)
    scale = rng.uniform(5, 400, (4, 1)).astype(np.float32)
    got = pupil_dense.make_perturbations(
        *(torch.from_numpy(a) for a in (row, col, scale, u)))
    want = jax_dense.make_perturbations(
        *(jnp.asarray(a) for a in (row, col, scale, u)))
    for a, b in zip(got, want):
        assert np.array_equal(_bits(a.numpy()), _bits(b))
    for p in (1, 2, 15, 63):
        v = rng.standard_normal((3, 4, p)).astype(np.float32)
        got = pupil_dense.median_vote(*torch.from_numpy(v), p)
        want = jax_dense.median_vote(*jnp.asarray(v), p)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, 7.0],
                 np.float32)
    assert np.array_equal(pupil_dense.round_away(torch.from_numpy(x)).numpy(),
                          np.asarray(jax_dense.round_away(jnp.asarray(x))))
    assert pupil_dense.QCOS_TABLE == tuple(
        int(v) for v in np.asarray(jax_dense.QCOS_TABLE))
    assert pupil_dense.QSIN_TABLE == tuple(
        int(v) for v in np.asarray(jax_dense.QSIN_TABLE))


def test_kernel_wrapper_on_cpu_matches_pallas(sample_gray, flp, jax_flp):
    """pupil_cuda.pupil_walk on CPU tensors against the TPU kernel
    (pupil_pallas._stage_kernel, interpret mode, through
    pupil_patch._walk_pallas_impl run op by op) on groups whose probes all
    stay inside their patches (overflow flag false), bit for bit: three
    landmark groups of three cascades, two of them flipped, at scales that
    keep every stage's patch at 128 (one interpret compile; eyes differ
    only in the geometry, which the tests above cover)."""
    rows, cols = sample_gray.shape
    geom = jax_flp.geometry
    p = 15
    cid = np.array([0, 4, 8], np.int32)
    anchors = np.array([(200.0, 160.0, 60.0), (150.0, 140.0, 45.0),
                        (260.0, 200.0, 55.0)], np.float32)
    sign = np.array([1, -1, -1], np.int32)
    u = np.random.default_rng(9).random((3, p, 3), dtype=np.float32)
    r0, c0, s0 = jax_dense.make_perturbations(
        jnp.asarray(anchors[:, :1]), jnp.asarray(anchors[:, 1:2]),
        jnp.asarray(anchors[:, 2:]), jnp.asarray(u))
    sizes = pupil_patch.stage_patch_sizes(
        60.0, stages=geom.stages, scale_mult=float(geom.scale_mult),
        nrows=rows, ncols=cols)
    assert set(sizes) == {128}
    want_r, want_c, want_s, overflow = pupil_patch._walk_pallas_impl(
        jax_flp.codes, jax_flp.preds, jnp.asarray(cid), r0, c0, s0,
        jnp.asarray(sign), jnp.asarray(sample_gray), stages=geom.stages,
        trees=geom.trees, depth=geom.depth, nrows=rows, ncols=cols,
        scale_mult=float(geom.scale_mult), patch_sizes=tuple(sizes),
        interpret=True)
    assert not np.asarray(overflow).any()
    starts = (np.repeat(cid, p), np.array(r0).reshape(-1),
              np.array(c0).reshape(-1), np.array(s0).reshape(-1),
              np.repeat(sign, p))
    before = LAUNCHES["pupil_walk"]
    got = _port_walk(flp.tensors, starts, sample_gray,
                     walk=pupil_cuda.pupil_walk)
    assert LAUNCHES["pupil_walk"] == before  # CPU: no launch
    for x, y in zip(got, (want_r, want_c, want_s)):
        assert np.array_equal(_bits(x.numpy()), _bits(y))


def test_kernel_wrapper_rejects_bad_input(plc, flp, sample_gray):
    t = plc.tensors
    n = 4
    ok = dict(casc_id=torch.zeros(n, dtype=torch.int32),
              r0=torch.full((n,), 100.0), c0=torch.full((n,), 100.0),
              s0=torch.full((n,), 40.0),
              col_sign=torch.ones(n, dtype=torch.int32),
              pixels=torch.from_numpy(sample_gray.reshape(-1)))
    kw = dict(nrows=400, ncols=320, dim=320, scale_mult=t.scale_mult)

    def call(codes=t.codes, preds=t.preds, **over):
        a = dict(ok, **{k: v for k, v in over.items() if k in ok})
        k2 = dict(kw, **{k: v for k, v in over.items() if k not in ok})
        return pupil_cuda.pupil_walk(codes, preds, a["casc_id"], a["r0"],
                                     a["c0"], a["s0"], a["col_sign"],
                                     a["pixels"], **k2)

    r, c, s = call()
    assert r.shape == c.shape == s.shape == (n,)
    wide = torch.zeros((1, 1, 33, 4, 4), dtype=torch.int8)
    for bad in (dict(codes=t.codes.to(torch.int32)),
                dict(preds=t.preds[..., :1]),
                dict(codes=wide, preds=torch.zeros((1, 1, 33, 4, 2))),
                dict(casc_id=ok["casc_id"].long()),
                dict(r0=ok["r0"].double()), dict(s0=torch.ones(n + 1)),
                dict(pixels=ok["pixels"][:1000]), dict(dim=300),
                dict(angle_idx=33), dict(r0=ok["r0"].expand(2, n)[:, 0])):
        with pytest.raises(ValueError):
            call(**bad)


def test_ensemble_wrapper_checks_before_the_card(flp, sample_gray):
    """pupil_ensemble (kernel C's ensemble mode, on the card only) checks
    its arguments first: each malformed one raises its ValueError, and
    well-formed CPU tensors raise that the mode runs on cuda, with no
    launch counted."""
    t = flp.tensors
    g, p = 6, 15
    ok = dict(out=torch.zeros((3, 4 + g)), u=torch.rand((g, p, 3)),
              pixels=torch.from_numpy(sample_gray.reshape(-1)), col0=4,
              anchors=None, npts=3,
              casc_id=torch.zeros(g, dtype=torch.int32),
              flips=torch.zeros(g, dtype=torch.bool), u_rows=None)
    kw = dict(nrows=400, ncols=320, dim=320, scale_mult=t.scale_mult)

    def call(**over):
        a = dict(ok, **over)
        return pupil_cuda.pupil_ensemble(
            t.codes, t.preds, a.pop("out"), a.pop("u"), a.pop("pixels"),
            **a, **kw)

    before = LAUNCHES["pupil_walk"]
    with pytest.raises(ValueError, match="runs on cuda"):
        call()
    with pytest.raises(ValueError, match="runs on cuda"):
        call(anchors=(torch.ones(g), torch.ones(g), torch.ones(g)),
             u_rows=torch.zeros(g, dtype=torch.int64), u=torch.rand(1, p, 3))
    for bad, match in (
            (dict(u=torch.rand((g, p, 2))), "u must be"),
            (dict(u=torch.rand((g, 4097, 3))), "u must be"),
            (dict(u=torch.rand((g - 1, p, 3))), "u must be"),
            (dict(npts=4), "eye medians"), (dict(col0=3), "eye medians"),
            (dict(out=torch.zeros((3, 3 + g))), "out must be"),
            (dict(out=torch.zeros((2, 4 + g))), "out must be"),
            (dict(flips=torch.zeros(g, dtype=torch.int32)), "flips"),
            (dict(casc_id=torch.zeros(g + 1, dtype=torch.int32)), "flips"),
            (dict(u_rows=torch.zeros(g, dtype=torch.int32)), "u_rows"),
            (dict(anchors=(torch.ones(g), torch.ones(g),
                           torch.ones(g).double())), "scales0"),
            (dict(pixels=ok["pixels"][:1000]), "pixels")):
        with pytest.raises(ValueError, match=match):
            call(**bad)
    assert LAUNCHES["pupil_walk"] == before


@pytest.mark.parametrize("bad_id", [-1, 9])
def test_kernel_wrapper_rejects_cascade_ids_outside_forest(bad_id, flp,
                                                           sample_gray):
    """A host cascade id outside [0, NC) raises, through the wrapper and
    through run_batch (on the card the kernel traps instead:
    tests/test_torch_cuda.py)."""
    rows, cols = sample_gray.shape
    starts = list(_starts(np.random.default_rng(5), 8, rows, cols, 10, 100,
                          9))
    starts[0][3] = bad_id
    with pytest.raises(ValueError, match="cascade ids"):
        _port_walk(flp.tensors, starts, sample_gray,
                   walk=pupil_cuda.pupil_walk)
    with pytest.raises(ValueError, match="cascade ids"):
        flp.run_batch(starts[0], starts[1:4], starts[4] < 0, sample_gray,
                      rows, cols)


class _Reads(torch.Tensor):
    """A tensor that logs the int64 index of every gather made from it or
    from what is computed from it: (dtype, row shape, indices)."""

    log: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if (func is torch.Tensor.__getitem__
                and isinstance(args[1], torch.Tensor)
                and args[1].dtype == torch.int64):
            with torch._C.DisableTorchFunctionSubclass():
                cls.log.append((args[0].dtype, tuple(args[0].shape[1:]),
                                args[1].reshape(-1).numpy().copy()))
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("kind,angle_idx", [("eyes", 0), ("eyes", 8),
                                            ("landmarks", 0)])
def test_walk_work_counts_what_the_walk_reads(kind, angle_idx, plc, flp,
                                              sample_gray):
    """walk_with_work's counts (chip_smoke.py's byte bound) are the distinct
    pixels, code words and leaves that the walk gathers, as a tensor that
    logs its gathers sees them, and fewer pixels than the frame; its walk
    is bit-equal to walk."""
    tensors = plc.tensors if kind == "eyes" else flp.tensors
    rows, cols = sample_gray.shape
    starts = _starts(np.random.default_rng(6), 16, rows, cols, 10, 120,
                     tensors.codes.shape[0])
    kw = dict(nrows=rows, ncols=cols, dim=cols, scale_mult=tensors.scale_mult,
              rotated=angle_idx > 0, angle_idx=angle_idx)
    args = [torch.from_numpy(np.array(a)) for a in starts]
    pix = torch.from_numpy(sample_gray.reshape(-1))
    _Reads.log = []
    *got, work = pupil_dense.walk_with_work(
        *(t.as_subclass(_Reads) for t in (tensors.codes, tensors.preds)),
        *args, pix.as_subclass(_Reads), **kw)
    read = {}
    for dtype, row, idx in _Reads.log:
        read.setdefault((dtype, row), set()).update(idx.tolist())
    assert work == {"pixels": len(read[torch.uint8, ()]),
                    "code_words": len(read[torch.int32, (4,)]),
                    "leaves": len(read[torch.float32, (2,)])}
    assert 0 < work["pixels"] < rows * cols
    want = pupil_dense.walk(tensors.codes, tensors.preds, *args, pix, **kw)
    for x, y in zip(got, want):
        assert np.array_equal(_bits(x.as_subclass(torch.Tensor)), _bits(y))


@pytest.mark.parametrize("tag", GOLDEN_TAGS)
def test_localizers_match_golden(tag, plc, flp):
    """PupilLocalizer and LandmarkLocalizer (CPU) reproduce the frozen eye
    and landmark votes at the fixture uniforms, as tests/test_golden.py
    checks the JAX package: row, col and the f32 scale all exact (the
    corpus is the oracle's, which the port follows bit for bit)."""
    from pigo_tpu.tools.make_golden import (_eye_anchors, fixture_frame,
                                            golden_uniforms)

    with open(os.path.join(ROOT, "tests", "golden", tag + ".json")) as fh:
        golden = json.load(fh)
    gray, rows, cols, dim = fixture_frame(golden["image"])
    assert golden["faces"], tag
    for fi, rec in enumerate(golden["faces"]):
        fr, fc, fs, _ = rec["face"]
        u = golden_uniforms(f"{tag}:face{fi}:eyes", 2)
        eyes = [plc.run_detector(Puploc(row=r, col=c, scale=s), gray, rows,
                                 cols, dim, uniforms=u[k])
                for k, (r, c, s) in enumerate(_eye_anchors(fr, fc, fs))]
        assert [[e.row, e.col, e.scale] for e in eyes] == rec["eyes"], tag
        ul = golden_uniforms(f"{tag}:face{fi}:lmk", len(rec["landmarks"]))
        for j, (name, flip, prow, pcol, pscale) in enumerate(
                rec["landmarks"]):
            p = flp.get_landmark_point(name, eyes[0], eyes[1], gray, rows,
                                       cols, dim, flip_v=flip,
                                       uniforms=ul[j])
            assert [p.row, p.col, p.scale] == [prow, pcol, pscale], (
                tag, fi, name, flip)


def test_localizers_match_jax(sample_gray, plc, flp, jax_plc, jax_flp):
    """The port's localizers against the JAX package's own, given the same
    uniforms: bit for bit with the JAX ones run op by op
    (jax.disable_jit), and row and col exact jitted."""
    rows, cols = sample_gray.shape
    rng = np.random.default_rng(21)
    u = rng.random((63, 3), dtype=np.float32)
    cases = [dict(angle=0.0, flip_v=False), dict(angle=0.25, flip_v=True)]
    port_eyes = []
    for kw in cases:
        got = plc.run_detector(Puploc(184, 113, 60.0), sample_gray, rows,
                               cols, uniforms=u, **kw)
        with jax.disable_jit():
            want = jax_plc.run_detector(JaxPuploc(184, 113, 60.0),
                                        sample_gray, rows, cols, uniforms=u,
                                        **kw)
        jitted = jax_plc.run_detector(JaxPuploc(184, 113, 60.0), sample_gray,
                                      rows, cols, uniforms=u, **kw)
        assert (got.row, got.col, got.scale) == (want.row, want.col,
                                                 want.scale)
        assert (got.row, got.col) == (jitted.row, jitted.col)
        assert abs(got.scale - jitted.scale) <= 1e-5 * got.scale
        port_eyes.append(got)
    left, right = Puploc(184, 113, 21.0), Puploc(182, 204, 21.0)
    got = flp.get_landmark_point("lp84", left, right, sample_gray, rows,
                                 cols, flip_v=True, uniforms=u)
    with jax.disable_jit():
        want = jax_flp.get_landmark_point(
            "lp84", JaxPuploc(184, 113, 21.0), JaxPuploc(182, 204, 21.0),
            sample_gray, rows, cols, flip_v=True, uniforms=u)
    assert (got.row, got.col, got.scale) == (want.row, want.col, want.scale)


def test_multi_entry_points_match_single(sample_gray, plc, flp):
    """run_detector_multi and detect_points_multi draw [G, P, 3] uniforms
    from the generator in one go: group i gets the i-th block, so they
    equal the single-anchor calls fed those blocks. run_batch refines raw
    starts with the same walk."""
    rows, cols = sample_gray.shape
    pls = [Puploc(184, 113, 60.0, 15), Puploc(182, 204, 60.0, 15),
           Puploc(250, 160, 80.0, 15)]
    flips = [False, True, False]
    multi = plc.run_detector_multi(pls, sample_gray, rows, cols, flips=flips,
                                   generator=torch.Generator().manual_seed(4))
    u = torch.rand((3, 15, 3), generator=torch.Generator().manual_seed(4))
    single = [plc.run_detector(pl, sample_gray, rows, cols, flip_v=fl,
                               uniforms=u[i].numpy())
              for i, (pl, fl) in enumerate(zip(pls, flips))]
    assert multi == single
    assert plc.run_detector_multi([], sample_gray, rows, cols) == []

    pairs = [(Puploc(184, 113, 21.0), Puploc(182, 204, 21.0)),
             (Puploc(180, 110, 20.0), Puploc(181, 200, 20.0))]
    multi = flp.detect_points_multi(pairs, sample_gray, rows, cols,
                                    perturbs=15,
                                    generator=torch.Generator().manual_seed(8))
    npts = len(flp.point_schedule)
    assert npts == 15 and [len(m) for m in multi] == [15, 15]
    u = torch.rand((2 * npts, 15, 3),
                   generator=torch.Generator().manual_seed(8))
    for i, (le, re) in enumerate(pairs):
        for j, (name, flip) in enumerate(flp.point_schedule):
            want = flp.get_landmark_point(name, le, re, sample_gray, rows,
                                          cols, perturbs=15, flip_v=flip,
                                          uniforms=u[i * npts + j].numpy())
            assert multi[i][j] == want, (i, name, flip)
    one = flp.detect_points(*pairs[0], sample_gray, rows, cols, perturbs=15,
                            generator=torch.Generator().manual_seed(8))
    assert one == multi[0]

    rng = np.random.default_rng(2)
    starts = _starts(rng, 20, rows, cols, 10, 100, 9)
    r, c, s = flp.run_batch(starts[0], starts[1:4], starts[4] < 0,
                            sample_gray, rows, cols)
    want = _port_walk(flp.tensors, starts, sample_gray)
    assert all(torch.equal(a, b) for a, b in zip((r, c, s), want))
    with pytest.raises(ValueError):
        flp.run_batch(starts[0] + 9, starts[1:4], starts[4] < 0,
                      sample_gray, rows, cols)
    r, c, s = plc.run_batch(starts[1:4], starts[4] < 0, sample_gray, rows,
                            cols, angle=0.25)
    want = _port_walk(plc.tensors, (np.zeros(20, np.int32),) + starts[1:],
                      sample_gray, rotated=True, angle_idx=8)
    assert all(torch.equal(a, b) for a, b in zip((r, c, s), want))


def test_loaders_and_strided_frame(sample_gray):
    """from_file / from_bytes load the shipped cascades, and a row stride
    (dim > cols) gives the same votes as the contiguous frame."""
    path = assets.asset_path("cascade", "puploc")
    with open(path, "rb") as fh:
        raw = fh.read()
    a = PupilLocalizer.from_file(path, device="cpu")
    b = PupilLocalizer.from_bytes(raw, device="cpu")
    assert torch.equal(a.tensors.codes, b.tensors.codes)
    rows, cols = sample_gray.shape
    pad = np.random.default_rng(0).integers(0, 256, (rows, 37),
                                            dtype=np.uint8)
    strided = np.concatenate([sample_gray, pad], axis=1).reshape(-1)
    u = np.random.default_rng(1).random((63, 3), dtype=np.float32)
    anchor = Puploc(184, 113, 60.0)
    assert (a.run_detector(anchor, strided, rows, cols, cols + 37, uniforms=u)
            == a.run_detector(anchor, sample_gray, rows, cols, uniforms=u))
