from pigo_tpu_torch.cascade.format import FaceForest, unpack_face_cascade
from pigo_tpu_torch.cascade.assets import asset_path, load_facefinder

__all__ = ["FaceForest", "unpack_face_cascade", "asset_path", "load_facefinder"]
