"""Bundled frozen model assets.

The binary cascades are the MIT-licensed pre-trained models shipped by the
reference project (esimov/pigo, cascade/), kept in the repository's
`assets/` directory. They are data, not code; the port loads them read-only.
"""

from __future__ import annotations

import os

from pigo_tpu_torch.cascade.format import (
    FaceForest,
    PupilForest,
    unpack_face_cascade,
    unpack_pupil_cascade,
)

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
ASSET_DIR = os.path.join(_REPO_ROOT, "assets")

# Landmark cascade roles (reference: cmd/pigo/main.go:68-71; lp84 doubles
# as the nose cascade via vertical flip, main.go:549).
EYE_CASCADES = ("lp46", "lp44", "lp42", "lp38", "lp312")
MOUTH_CASCADES = ("lp93", "lp84", "lp82", "lp81")
NOSE_CASCADE = "lp84"


def asset_path(*parts: str) -> str:
    return os.path.join(ASSET_DIR, *parts)


def load_facefinder(path: str | None = None) -> FaceForest:
    path = path or asset_path("cascade", "facefinder")
    with open(path, "rb") as fh:
        return unpack_face_cascade(fh.read())


def load_puploc(path: str | None = None) -> PupilForest:
    path = path or asset_path("cascade", "puploc")
    with open(path, "rb") as fh:
        return unpack_pupil_cascade(fh.read())


def load_landmark_dir(path: str | None = None) -> dict[str, PupilForest]:
    """Load every landmark cascade in a directory, keyed by file name.

    Equivalent of the reference's ReadCascadeDir (core/flploc.go:60-81).
    """
    path = path or asset_path("cascade", "lps")
    names = sorted(os.listdir(path))
    if not names:
        raise ValueError("the provided directory is empty")
    out: dict[str, PupilForest] = {}
    for name in names:
        fp = os.path.join(path, name)
        if not os.path.isfile(fp):
            continue
        with open(fp, "rb") as fh:
            out[name] = unpack_pupil_cascade(fh.read())
    return out
