"""Weights carried across: a face forest's arrays -> the port's tensors.

The inputs are plain NumPy arrays, such as the fields of the port's own
`FaceForest` or of the JAX package's (`pigo_tpu.models.face.FaceCascade(
...).forest`), which is read duck-typed: nothing of that package is
imported. Both packages then run the same forest, random ones included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ForestTensors:
    """A face forest on one device.

    codes int8 [T, L, 4], preds f32 [T, L], thresh f32 [T]; L = 2^depth."""

    codes: torch.Tensor
    preds: torch.Tensor
    thresh: torch.Tensor

    @property
    def num_trees(self) -> int:
        return self.codes.shape[0]


def face_forest_from_numpy(depth, codes, preds, thresh,
                           device: str | torch.device = "cpu") -> ForestTensors:
    """Validate and upload a face forest (see module docstring)."""
    depth = int(depth)
    leaves = 1 << depth
    codes = np.ascontiguousarray(codes)
    preds = np.ascontiguousarray(preds)
    thresh = np.ascontiguousarray(thresh)
    t = codes.shape[0] if codes.ndim == 3 else 0
    if (codes.dtype != np.int8 or codes.shape != (t, leaves, 4) or t == 0
            or preds.dtype != np.float32 or preds.shape != (t, leaves)
            or thresh.dtype != np.float32 or thresh.shape != (t,)):
        raise ValueError(
            f"face forest of depth {depth} needs codes int8 [T, {leaves}, 4], "
            f"preds f32 [T, {leaves}], thresh f32 [T]; got codes "
            f"{codes.dtype} {codes.shape}, preds {preds.dtype} {preds.shape},"
            f" thresh {thresh.dtype} {thresh.shape}")
    return ForestTensors(
        codes=torch.from_numpy(codes.copy()).to(device),
        preds=torch.from_numpy(preds.copy()).to(device),
        thresh=torch.from_numpy(thresh.copy()).to(device),
    )
