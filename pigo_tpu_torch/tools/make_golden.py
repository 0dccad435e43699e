"""Generate frozen golden detection fixtures (the tests/golden/*.json corpus).

The port's copy of pigo_tpu/tools/make_golden.py, on the port's oracle
(pigo_tpu_torch/oracle), loaders and image decoding, so the corpus can be
rebuilt and checked where the JAX package is not installed. Pillow is
imported only to decode the fixture images.

The oracle-relative parity tests prove every engine agrees with the NumPy
oracle, but a bug introduced simultaneously into the oracle AND the kernels
(e.g. in constants duplicated across engines, like the quantized sin/cos
tables) would slip through. These fixtures freeze the oracle's output at the
reference's own test configuration (core/pigo_test.go:44-50: MinSize 20,
MaxSize 1000, Shift 0.2, Scale 1.1, IoU 0.1) so any future correlated drift
fails tests/test_golden.py.

Uniforms for the pupil/landmark ensembles come from a seeded NumPy
Generator (stable across platforms), keyed per fixture tag, so the frozen
eye/landmark votes are reproducible by every engine.

Write every fixture into a directory (the committed corpus only when that
directory is tests/golden, after an intended change of semantics):
    python -m pigo_tpu_torch.tools.make_golden OUT_DIR
"""

from __future__ import annotations

import argparse
import json
import os
import zlib

import numpy as np

from pigo_tpu_torch.cascade.assets import asset_path, load_facefinder, load_puploc
from pigo_tpu_torch.cascade.assets import load_landmark_dir
from pigo_tpu_torch.io.image import get_image, rgb_to_grayscale
from pigo_tpu_torch.oracle.cluster import oracle_cluster_detections
from pigo_tpu_torch.oracle.face import oracle_run_cascade
from pigo_tpu_torch.oracle.pupil import make_perturbations, oracle_run_detector

# Reference test configuration (core/pigo_test.go:44-50).
REF_CFG = dict(min_size=20, max_size=1000, shift_factor=0.2, scale_factor=1.1)
REF_IOU = 0.1
# Frozen rotated-path fixture angles (fractions of 2*pi; exercise the
# quantized rotation tables and the nrows-clamp quirk, core/pigo.go:150-191).
# The first is the legacy `detections_rotated` angle; every angle is frozen
# in the `rotations` list.
GOLDEN_ANGLE = 0.07
ROT_ANGLES = (GOLDEN_ANGLE, 0.125)
PERTURBS = 63
# (fixture name, image, config): the reference test config for both images
# (test.png freezes the agreed-empty result) plus the headline shift-0.1
# pyramid (218k windows) for a denser fixture, plus synthetic frames
# (`synth:*`, built deterministically by synth_image) covering a wide
# multi-face landscape, a strided-Dim buffer (row stride > cols,
# reference ImageParams.Dim, core/pigo.go:29-34), and an alpha-carrying
# RGBA image (premultiplied grayscale, core/grayscale.go:8-23).
FIXTURES = (
    ("sample", "sample.jpg", REF_CFG),
    ("test", "test.png", REF_CFG),
    ("sample_dense", "sample.jpg",
     dict(min_size=20, max_size=1000, shift_factor=0.1, scale_factor=1.1)),
    ("wide", "synth:wide",
     dict(min_size=60, max_size=200, shift_factor=0.1, scale_factor=1.1)),
    ("strided", "synth:strided", REF_CFG),
    ("alpha", "synth:alpha", REF_CFG),
)

STRIDE_PAD = 37  # synth:strided row stride = cols + STRIDE_PAD


def synth_image(name: str) -> tuple[np.ndarray, int | None]:
    """Deterministic synthetic fixture frames derived from sample.jpg.

    Returns (image, dim): `image` feeds rgb_to_grayscale (RGB/RGBA [H, W, C]
    or raw grayscale [H, W]); `dim` is the grayscale row stride when it
    differs from the frame width (reference ImageParams.Dim), else None.
    Construction uses only integer striding / tiling + a seeded Generator so
    the frames are reproducible on any platform.
    """
    img = get_image(asset_path("testdata", "sample.jpg"))
    if name == "synth:wide":
        # 200x640 landscape with 4 faces: 2x-subsampled portrait (face scale
        # ~119) tiled horizontally.
        return np.tile(img[::2, ::2], (1, 4, 1)), None
    if name == "synth:strided":
        # Grayscale buffer whose row stride exceeds the frame width; the pad
        # columns hold noise every engine must ignore (windows never read
        # past cols — models/face.py destride docstring).
        gray2d = rgb_to_grayscale(img).reshape(img.shape[0], img.shape[1])
        rng = np.random.default_rng(zlib.crc32(b"synth:strided"))
        pad = rng.integers(0, 256, (img.shape[0], STRIDE_PAD), dtype=np.uint8)
        return np.concatenate([gray2d, pad], axis=1), img.shape[1] + STRIDE_PAD
    if name == "synth:alpha":
        # RGBA with a non-trivial alpha gradient (160..255 top to bottom):
        # exercises the premultiplied 16-bit grayscale path.
        h, w = img.shape[0], img.shape[1]
        alpha = np.repeat(
            np.linspace(160, 255, h).astype(np.uint8)[:, None], w, axis=1)
        return np.dstack([img[..., :3], alpha]), None
    raise ValueError(f"unknown synthetic image {name!r}")


def fixture_frame(image_name: str) -> tuple[np.ndarray, int, int, int]:
    """Resolve a fixture's `image` field -> (flat gray, rows, cols, dim)."""
    if image_name.startswith("synth:"):
        img, dim = synth_image(image_name)
    else:
        img, dim = get_image(asset_path("testdata", image_name)), None
    rows = img.shape[0]
    cols = img.shape[1] if dim is None else img.shape[1] - STRIDE_PAD
    return rgb_to_grayscale(img), rows, cols, (dim or cols)



def golden_uniforms(tag: str, n: int, perturbs: int = PERTURBS) -> np.ndarray:
    """Deterministic jitter uniforms [n, perturbs, 3] f32 for fixture `tag`."""
    rng = np.random.default_rng(zlib.crc32(tag.encode()))
    return rng.random((n, perturbs, 3), dtype=np.float32)


def _eye_anchors(face_row: int, face_col: int, face_scale: int):
    """Reference CLI eye anchors (cmd/pigo/main.go:416-458), f32 truncation
    (see pigo_tpu_torch.detector._eye_anchor_offsets)."""
    f = np.float32
    o_row = int(f(0.075) * f(face_scale))
    o_l = int(f(0.175) * f(face_scale))
    o_r = int(f(0.185) * f(face_scale))
    s = float(face_scale) * 0.25
    return (
        (face_row - o_row, face_col - o_l, s),
        (face_row - o_row, face_col + o_r, s),
    )


def _landmark_anchor(le, re):
    """core/flploc.go:37-43 (f64, like the Go reference)."""
    import math

    dist = math.sqrt((le[0] - re[0]) ** 2 + (le[1] - re[1]) ** 2)
    row = (le[0] + re[0]) / 2.0 + 0.25 * dist
    col = (le[1] + re[1]) / 2.0 + 0.15 * dist
    return int(row), int(col), 3.0 * dist


def landmark_schedule(names: list[str]) -> list[tuple[str, bool]]:
    """The reference CLI 15-point schedule (cmd/pigo/main.go:493-564)."""
    eyes = ["lp46", "lp44", "lp42", "lp38", "lp312"]
    mouth = ["lp93", "lp84", "lp82", "lp81"]
    missing = [n for n in eyes + mouth if n not in names]
    if missing:
        raise ValueError(f"landmark cascades missing: {missing}")
    return ([(n, False) for n in eyes] + [(n, True) for n in eyes]
            + [(n, False) for n in mouth] + [("lp84", True)])


def build_golden(tag: str, image_name: str, cfg: dict) -> dict:
    forest = load_facefinder()
    puploc = load_puploc()
    lps = load_landmark_dir()
    gray, rows, cols, dim = fixture_frame(image_name)

    dets = oracle_run_cascade(
        forest, gray, rows, cols, dim, cfg["min_size"],
        cfg["max_size"], cfg["shift_factor"], cfg["scale_factor"],
    )
    clusters = oracle_cluster_detections(dets, REF_IOU)
    rotations = [
        oracle_run_cascade(
            forest, gray, rows, cols, dim, cfg["min_size"],
            cfg["max_size"], cfg["shift_factor"], cfg["scale_factor"],
            angle=a,
        )
        for a in ROT_ANGLES
    ]

    out = {
        "image": image_name,
        "rows": rows,
        "cols": cols,
        "dim": dim,
        "config": dict(cfg, iou=REF_IOU, angle=GOLDEN_ANGLE,
                       perturbs=PERTURBS),
        "detections": dets.tolist(),
        "clusters": clusters.tolist(),
        "detections_rotated": rotations[0].tolist(),
        "rotations": [
            {"angle": a, "detections": r.tolist()}
            for a, r in zip(ROT_ANGLES, rotations)
        ],
        "faces": [],
    }

    # Eyes + landmarks for qualifying faces (reference CLI gates,
    # cmd/pigo/main.go:360,404).
    for fi, (r, c, s, q) in enumerate(clusters):
        if q <= 5.0 or s <= 50:
            continue
        fr, fc, fs = int(r), int(c), int(s)
        (lr, lc, ls), (rr_, rc, rs) = _eye_anchors(fr, fc, fs)
        u = golden_uniforms(f"{tag}:face{fi}:eyes", 2)
        left = oracle_run_detector(
            puploc, make_perturbations(lr, lc, ls, u[0]), rows, cols, gray,
            dim)
        right = oracle_run_detector(
            puploc, make_perturbations(rr_, rc, rs, u[1]), rows, cols, gray,
            dim)
        face_rec = {
            "face": [fr, fc, fs, float(q)],
            "eyes": [list(left[:2]) + [float(left[2])],
                     list(right[:2]) + [float(right[2])]],
            "landmarks": [],
        }
        if left[0] > 0 and left[1] > 0 and right[0] > 0 and right[1] > 0:
            ar, ac, asc = _landmark_anchor(left, right)
            sched = landmark_schedule(sorted(lps))
            ul = golden_uniforms(f"{tag}:face{fi}:lmk", len(sched))
            for j, (name, flip) in enumerate(sched):
                p = oracle_run_detector(
                    lps[name], make_perturbations(ar, ac, asc, ul[j]),
                    rows, cols, gray, dim, flip_v=flip)
                face_rec["landmarks"].append(
                    [name, bool(flip), p[0], p[1], float(p[2])])
        out["faces"].append(face_rec)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", help="directory to write <tag>.json into")
    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    for tag, name, cfg in FIXTURES:
        golden = build_golden(tag, name, cfg)
        path = os.path.join(args.out_dir, tag + ".json")
        with open(path, "w") as fh:
            json.dump(golden, fh, indent=1)
        print(f"{path}: {len(golden['detections'])} raw dets, "
              f"{len(golden['clusters'])} clusters, "
              f"{len(golden['detections_rotated'])} rotated, "
              f"{len(golden['faces'])} faces with eyes/landmarks")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
