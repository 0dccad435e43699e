"""Weights carried across: a forest's arrays -> the port's tensors.

The inputs are plain NumPy arrays, such as the fields of the port's own
`FaceForest` / `PupilForest` or of the JAX package's
(`pigo_tpu.models.face.FaceCascade(...).forest`,
`np.asarray(pigo_tpu.models.pupil.PupilLocalizer().codes)`), which are read
duck-typed: nothing of that package is imported. Both packages then run the
same forest, random ones included.
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


@dataclasses.dataclass(frozen=True)
class PupilTensors:
    """Pupil/landmark regression forests of one geometry, stacked on a
    cascade axis, on one device.

    codes int8 [NC, S, T, L, 4] node (r1, c1, r2, c2) offsets (slot L-1 of
    each tree is the zero pad), preds f32 [NC, S, T, L, 2] leaf (dr, dc);
    S stages of T trees of depth log2(L); each stage multiplies the walk's
    scale by scale_mult. On a CUDA device codes is the card copy of
    `card_codes`."""

    codes: torch.Tensor
    preds: torch.Tensor
    scale_mult: float


def pupil_forest_from_numpy(codes, preds, *, stages, trees, depth,
                            scale_mult,
                            device: str | torch.device = "cpu"
                            ) -> PupilTensors:
    """Validate and upload NC stacked regression forests.

    Takes either layout, with identical results:
      - int8 codes [S, T, L, 4] or [NC, S, T, L, 4] and f32 preds of the
        same leading shape with a last axis of 2 (a `PupilForest`'s arrays,
        or several stacked);
      - the JAX package's device layout: int32 codes [NC*S*T*L], each word
        the node's four bytes packed big-endian (`pupil_dense.pack_codes`
        there), and f32 preds [NC*S*T*L*2].
    """
    stages, trees, depth = int(stages), int(trees), int(depth)
    leaves = 1 << depth
    per = stages * trees * leaves
    codes = np.asarray(codes)
    preds = np.asarray(preds)
    geometry = (stages, trees, leaves)
    if codes.dtype == np.int32 and codes.ndim == 1 and codes.size % per == 0:
        # big-endian bytes of each word are (c0, c1, c2, c3)
        codes = codes.astype(">i4").view(np.int8).reshape(-1, *geometry, 4)
    elif (codes.dtype == np.int8 and codes.ndim in (4, 5)
          and codes.shape[-4:] == (*geometry, 4)):
        codes = codes.reshape(-1, *geometry, 4)
    else:
        raise ValueError(
            f"pupil forest codes must be int8 [(NC,) {stages}, {trees}, "
            f"{leaves}, 4] or packed int32 [NC*{per}]; got {codes.dtype} "
            f"{codes.shape}")
    nc = codes.shape[0]
    if preds.dtype != np.float32 or preds.size != nc * per * 2 or (
            preds.ndim > 1 and preds.shape[-4:] != (*geometry, 2)):
        raise ValueError(
            f"pupil forest preds must be f32 with {nc * per * 2} values "
            f"([(NC,) {stages}, {trees}, {leaves}, 2] or flat); got "
            f"{preds.dtype} {preds.shape}")
    preds = preds.reshape(nc, *geometry, 2)
    codes = torch.from_numpy(np.ascontiguousarray(codes).copy())
    if torch.device(device).type == "cuda":
        codes = card_codes(codes, device)
    return PupilTensors(
        codes=codes.to(device),
        preds=torch.from_numpy(np.ascontiguousarray(preds).copy()).to(device),
        scale_mult=float(np.float32(scale_mult)),
    )


def card_codes(codes: torch.Tensor,
               device: str | torch.device) -> torch.Tensor:
    """A copy of pupil codes int8 [..., L, 4] on `device`, stored one code
    word into a buffer that starts 8-byte aligned: the card's layout of the
    walk kernel (csrc/pupil_walk.cu). Read from the word before it, node k
    of each tree sits at 1-based slot k + 1, so the children of 1-based node
    j (2j and 2j + 1) are one aligned 8-byte word. The tensor itself is the
    usual 0-based layout, which the plain walk reads."""
    buf = torch.zeros(codes.numel() + 4, dtype=torch.int8, device=device)
    buf[4:] = codes.reshape(-1)
    return buf[4:].view(codes.shape)
