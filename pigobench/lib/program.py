"""The system under test, built from the cascades the harness loaded.

The harness reads each cascade file once (checking it against the
configuration's sha256) and hands the same bytes to the program and to the
reference. Only here, and in the drivers, is `pigo_tpu_torch` imported.
"""

from __future__ import annotations

import hashlib
import os


def load_cascades(root: str, config: dict) -> dict:
    """{"face": bytes, "pupil": bytes, "landmarks": {name: bytes}} from the
    configuration's `cascades`, each checked against its sha256."""
    out: dict = {}
    for role, entry in config["cascades"].items():
        files = {None: entry} if "path" in entry else entry
        got = {}
        for name, spec in files.items():
            with open(os.path.join(root, spec["path"]), "rb") as fh:
                data = fh.read()
            if hashlib.sha256(data).hexdigest() != spec["sha256"]:
                raise ValueError(f"{spec['path']} is not the cascade the "
                                 "configuration names (sha256 differs)")
            got[name] = data
        out[role] = got[None] if None in got else got
    return out


def detector(ctx):
    """A FaceDetector on ctx.device with the configuration's cascades, or,
    in a run of the control (`--control`), the reference in its place
    (lib/control.py)."""
    if ctx.control:
        from pigobench.lib import control

        return control.Detector(ctx, ctx.control)
    from pigo_tpu_torch.cascade.format import unpack_pupil_cascade
    from pigo_tpu_torch.detector import FaceDetector
    from pigo_tpu_torch.models.face import FaceCascade
    from pigo_tpu_torch.models.landmark import LandmarkLocalizer
    from pigo_tpu_torch.models.pupil import PupilLocalizer

    dev, c = ctx.device, ctx.cascades
    return FaceDetector(
        face=FaceCascade.from_bytes(c["face"], device=dev),
        pupil=PupilLocalizer.from_bytes(c["pupil"], device=dev),
        landmarks=LandmarkLocalizer(
            {n: unpack_pupil_cascade(b) for n, b in c["landmarks"].items()},
            device=dev),
        device=dev)


def params(ctx):
    """(CascadeParams, IoU threshold) of the configuration."""
    from pigo_tpu_torch.detector import CascadeParams

    p = ctx.config["params"]
    return (CascadeParams(p["min_size"], p["max_size"], p["shift_factor"],
                          p["scale_factor"]), p["iou_threshold"])
