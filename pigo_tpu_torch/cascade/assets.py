"""Bundled frozen model assets.

The binary cascades are the MIT-licensed pre-trained models shipped by the
reference project (esimov/pigo, cascade/), kept in the repository's
`assets/` directory. They are data, not code; the port loads them read-only.
"""

from __future__ import annotations

import os

from pigo_tpu_torch.cascade.format import FaceForest, unpack_face_cascade

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
ASSET_DIR = os.path.join(_REPO_ROOT, "assets")


def asset_path(*parts: str) -> str:
    return os.path.join(ASSET_DIR, *parts)


def load_facefinder(path: str | None = None) -> FaceForest:
    path = path or asset_path("cascade", "facefinder")
    with open(path, "rb") as fh:
        return unpack_face_cascade(fh.read())
