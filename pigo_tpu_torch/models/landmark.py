"""LandmarkLocalizer on PyTorch: facial landmark points (core/flploc.go).

The 9 shipped landmark cascades share one geometry (6 stages x 20 trees x
depth 9), so they are stacked on a cascade axis (sorted by name) and every
landmark of every face is localized in one kernel walk: the port of the
reference's per-cascade GetLandmarkPoint loop (cmd/pigo/main.go:493-564).

Landmark roles follow the reference CLI: 5 eye cascades run twice (flipV
for the right side), 4 mouth cascades once, and lp84 doubles as the nose
via flipV (main.go:68-71, :549): 15 points per face.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pigo_tpu_torch.cascade.assets import (
    EYE_CASCADES,
    MOUTH_CASCADES,
    NOSE_CASCADE,
    load_landmark_dir,
)
from pigo_tpu_torch.cascade.format import PupilForest
from pigo_tpu_torch.convert import pupil_forest_from_numpy
from pigo_tpu_torch.models.pupil import (
    Puploc,
    device_pixels,
    draw_uniforms,
    ensemble_medians,
    to_device,
)
from pigo_tpu_torch.ops import pupil_cuda
from pigo_tpu_torch.utils.device import resolve_device


def landmark_anchor(left_eye: Puploc,
                    right_eye: Puploc) -> tuple[int, int, float]:
    """Anchor geometry from the two pupils, in f64 like the reference
    (core/flploc.go:37-43)."""
    dx = (left_eye.row - right_eye.row) ** 2
    dy = (left_eye.col - right_eye.col) ** 2
    dist = math.sqrt(dx + dy)
    row = (left_eye.row + right_eye.row) / 2.0 + 0.25 * dist
    col = (left_eye.col + right_eye.col) / 2.0 + 0.15 * dist
    scale = 3.0 * dist
    return int(row), int(col), float(scale)


class LandmarkLocalizer:
    """Stacked landmark regression forests on a device, one kernel walk per
    call. `device=None` means the CUDA card and raises without one."""

    def __init__(self, cascades: dict[str, PupilForest] | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.cascades = (load_landmark_dir() if cascades is None
                         else cascades)
        self.names = sorted(self.cascades)
        ref = self.cascades[self.names[0]]
        for name, f in self.cascades.items():
            if (f.stages, f.trees, f.depth, f.scale_mult) != (
                    ref.stages, ref.trees, ref.depth, ref.scale_mult):
                raise ValueError(f"landmark cascade {name} geometry mismatch")
        self.geometry = ref
        self.tensors = pupil_forest_from_numpy(
            np.stack([self.cascades[n].codes for n in self.names]),
            np.stack([self.cascades[n].preds for n in self.names]),
            stages=ref.stages, trees=ref.trees, depth=ref.depth,
            scale_mult=ref.scale_mult, device=self.device)
        self._name_to_id = {n: i for i, n in enumerate(self.names)}
        # The reference CLI's 15-point schedule: (cascade, flipV) per point.
        self.point_schedule: list[tuple[str, bool]] = (
            [(n, False) for n in EYE_CASCADES]
            + [(n, True) for n in EYE_CASCADES]
            + [(n, False) for n in MOUTH_CASCADES]
            + [(NOSE_CASCADE, True)]
        )

    def schedule_arrays(self, faces: int) -> tuple[np.ndarray, np.ndarray]:
        """The point schedule tiled over `faces` faces: cascade ids int32
        and flips bool, [faces * 15] each."""
        cid = np.array([self._name_to_id[n] for n, _ in self.point_schedule],
                       np.int32)
        flips = np.array([fl for _, fl in self.point_schedule], bool)
        return np.tile(cid, faces), np.tile(flips, faces)

    def run_batch(self, casc_ids, starts, flips, pixels, rows: int,
                  cols: int, dim: int | None = None):
        """Refine B starts, each with its own cascade id, in one walk.
        Returns (r, c, s) f32 [B] tensors on the device."""
        dev = self.device
        ids = (casc_ids if isinstance(casc_ids, torch.Tensor)
               else torch.from_numpy(np.asarray(casc_ids)))
        # host ids raise here, before the upload; ids on the card fault
        # the kernel's launch (ops/pupil_cuda.pupil_walk)
        pupil_cuda.check_cascade_ids(ids, len(self.names))
        casc_ids = to_device(ids, dev, torch.int32).reshape(-1)
        r0, c0, s0 = (to_device(v, dev, torch.float32).reshape(-1)
                      for v in starts)
        col_sign = torch.where(to_device(flips, dev, torch.bool).reshape(-1),
                               -1, 1).to(torch.int32)
        t = self.tensors
        return pupil_cuda.pupil_walk(
            t.codes, t.preds, casc_ids, r0, c0, s0, col_sign,
            device_pixels(pixels, dev), nrows=rows, ncols=cols,
            dim=cols if dim is None else dim, scale_mult=t.scale_mult)

    def get_landmark_point(self, name: str, left_eye: Puploc,
                           right_eye: Puploc, pixels, rows: int, cols: int,
                           dim: int | None = None, perturbs: int = 63,
                           flip_v: bool = False,
                           generator: torch.Generator | None = None,
                           uniforms: np.ndarray | None = None) -> Puploc:
        """One landmark point from one cascade (core/flploc.go:36-57)."""
        row, col, scale = landmark_anchor(left_eye, right_eye)
        u = (draw_uniforms((perturbs, 3), generator) if uniforms is None
             else torch.tensor(np.asarray(uniforms, np.float32)))
        med = self._ensemble(
            np.array([self._name_to_id[name]], np.int32),
            np.array([row], np.float32), np.array([col], np.float32),
            np.array([scale], np.float32), np.array([flip_v]), u[None],
            pixels, rows, cols, dim)
        return Puploc(row=int(med[0, 0]), col=int(med[1, 0]),
                      scale=float(med[2, 0]), perturbs=perturbs)

    def _ensemble(self, casc_id, rows0, cols0, scales0, flips, u, pixels,
                  rows, cols, dim) -> np.ndarray:
        """One kernel walk for all groups -> host medians [3, G]."""
        return ensemble_medians(
            self.tensors, casc_id, rows0, cols0, scales0, flips, u,
            device_pixels(pixels, self.device), rows, cols,
            dim).cpu().numpy()

    def detect_points(self, left_eye: Puploc, right_eye: Puploc, pixels,
                      rows: int, cols: int, dim: int | None = None,
                      perturbs: int = 63,
                      generator: torch.Generator | None = None
                      ) -> list[Puploc]:
        """All 15 landmark points of one face in a single kernel walk."""
        return self.detect_points_multi(
            [(left_eye, right_eye)], pixels, rows, cols, dim,
            perturbs=perturbs, generator=generator)[0]

    def detect_points_multi(self, eye_pairs: list[tuple[Puploc, Puploc]],
                            pixels, rows: int, cols: int,
                            dim: int | None = None, perturbs: int = 63,
                            generator: torch.Generator | None = None
                            ) -> list[list[Puploc]]:
        """The full 15-point schedule for F faces in one kernel walk and
        one download (the multi-face entry point)."""
        f = len(eye_pairs)
        if f == 0:
            return []
        npts = len(self.point_schedule)
        anchors = np.array([landmark_anchor(le, re) for le, re in eye_pairs],
                           np.float32)  # [F, 3]
        cid, flips = self.schedule_arrays(f)
        med = self._ensemble(
            cid, np.repeat(anchors[:, 0], npts),
            np.repeat(anchors[:, 1], npts), np.repeat(anchors[:, 2], npts),
            flips, draw_uniforms((f * npts, perturbs, 3), generator), pixels,
            rows, cols, dim).reshape(3, f, npts)
        return [
            [Puploc(row=int(med[0, i, j]), col=int(med[1, i, j]),
                    scale=float(med[2, i, j]), perturbs=perturbs)
             for j in range(npts)]
            for i in range(f)
        ]
