from pigo_tpu_torch.cascade.format import (
    FaceForest,
    PupilForest,
    unpack_face_cascade,
    unpack_pupil_cascade,
)
from pigo_tpu_torch.cascade.assets import (
    EYE_CASCADES,
    MOUTH_CASCADES,
    NOSE_CASCADE,
    asset_path,
    load_facefinder,
    load_landmark_dir,
    load_puploc,
)

__all__ = [
    "FaceForest",
    "PupilForest",
    "unpack_face_cascade",
    "unpack_pupil_cascade",
    "EYE_CASCADES",
    "MOUTH_CASCADES",
    "NOSE_CASCADE",
    "asset_path",
    "load_facefinder",
    "load_landmark_dir",
    "load_puploc",
]
