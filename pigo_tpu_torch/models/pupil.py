"""PupilLocalizer on PyTorch: pupil/eye localization (core/puploc.go).

Public surface mirrors pigo_tpu.models.pupil and the reference:
    NewPuplocCascade().UnpackCascade(bytes) -> PupilLocalizer.from_bytes
    (*PuplocCascade).RunDetector(...)       -> PupilLocalizer.run_detector

Determinism: the reference jitters its perturbations with the global
math/rand. Here the jitter comes from an explicit `torch.Generator` (seed 0
when none is given) or from caller-provided uniforms, so runs are
reproducible; given identical uniforms the refined positions are
bit-identical to the reference's f32 arithmetic. The uniforms are drawn on
the host, so a generator gives the same walk on the card and on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pigo_tpu_torch.cascade.assets import load_puploc
from pigo_tpu_torch.cascade.format import PupilForest, unpack_pupil_cascade
from pigo_tpu_torch.convert import PupilTensors, pupil_forest_from_numpy
from pigo_tpu_torch.ops import pupil_cuda, pupil_dense
from pigo_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Puploc:
    """Pupil localization anchor/result (reference core/puploc.go:14-19)."""

    row: int
    col: int
    scale: float
    perturbs: int = 63


def draw_uniforms(shape, generator: torch.Generator | None) -> torch.Tensor:
    """Jitter uniforms f32 in [0, 1) on the host; seed 0 without a
    generator (as the JAX package defaults to PRNGKey(0))."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand(shape, generator=generator, dtype=torch.float32)


def to_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host data -> a contiguous tensor on `device`. Host tensors cross
    through pinned memory without blocking the host, so a dispatch that
    uploads does not wait for work already queued on the card."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    t = x.to(dtype)
    if t.device == device:
        return t.contiguous()
    if t.device.type == "cpu" and device.type == "cuda":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device).contiguous()


def device_pixels(pixels, device: torch.device) -> torch.Tensor:
    """A grayscale frame (flat or [rows, dim], numpy or tensor) as a flat
    uint8 tensor on `device`."""
    return to_device(pixels, device, torch.uint8).reshape(-1)


def ensemble_medians(tensors: PupilTensors, casc_id, rows0, cols0, scales0,
                     flips, u, pixels: torch.Tensor, rows: int, cols: int,
                     dim: int | None, angle: float = 0.0) -> torch.Tensor:
    """Jitter -> kernel walk -> median for G groups of P walkers; the
    per-group inputs are host arrays or tensors, u is [G, P, 3]. Returns
    the medians [3, G] f32 on the forest's device."""
    dev = tensors.codes.device
    return pupil_dense.ensemble(
        tensors.codes, tensors.preds, to_device(casc_id, dev, torch.int32),
        to_device(rows0, dev, torch.float32),
        to_device(cols0, dev, torch.float32),
        to_device(scales0, dev, torch.float32),
        to_device(flips, dev, torch.bool), to_device(u, dev, torch.float32),
        pixels, nrows=rows, ncols=cols, dim=cols if dim is None else dim,
        scale_mult=tensors.scale_mult, rotated=angle > 0.0,
        angle_idx=pupil_dense.angle_index(angle), walk=pupil_cuda.pupil_walk)


class PupilLocalizer:
    """Regression forest resident on a device, batched perturbation
    ensemble. `device=None` means the CUDA card and raises without one;
    `device="cpu"` runs the plain PyTorch version (tests)."""

    def __init__(self, forest: PupilForest | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.forest = load_puploc() if forest is None else forest
        f = self.forest
        self.tensors = pupil_forest_from_numpy(
            f.codes, f.preds, stages=f.stages, trees=f.trees, depth=f.depth,
            scale_mult=f.scale_mult, device=self.device)

    @classmethod
    def from_bytes(cls, packet: bytes, device=None) -> "PupilLocalizer":
        return cls(unpack_pupil_cascade(packet), device)

    @classmethod
    def from_file(cls, path: str, device=None) -> "PupilLocalizer":
        with open(path, "rb") as fh:
            return cls.from_bytes(fh.read(), device)

    def run_batch(self, starts, flips, pixels, rows: int, cols: int,
                  dim: int | None = None, angle: float = 0.0):
        """Refine B (row, col, scale) starts in one walk. starts: three
        f32 [B] arrays; flips: bool [B]. Returns (r, c, s) f32 [B] tensors
        on the device."""
        dev = self.device
        r0, c0, s0 = (to_device(v, dev, torch.float32).reshape(-1)
                      for v in starts)
        flips = to_device(flips, dev, torch.bool).reshape(-1)
        col_sign = torch.where(flips, -1, 1).to(torch.int32)
        t = self.tensors
        return pupil_cuda.pupil_walk(
            t.codes, t.preds, torch.zeros_like(col_sign), r0, c0, s0,
            col_sign, device_pixels(pixels, dev), nrows=rows, ncols=cols,
            dim=cols if dim is None else dim, scale_mult=t.scale_mult,
            rotated=angle > 0.0, angle_idx=pupil_dense.angle_index(angle))

    def run_detector(self, pl: Puploc, pixels, rows: int, cols: int,
                     dim: int | None = None, angle: float = 0.0,
                     flip_v: bool = False,
                     generator: torch.Generator | None = None,
                     uniforms: np.ndarray | None = None) -> Puploc:
        """Perturbation ensemble + median vote (core/puploc.go:239-277).

        `uniforms` [P, 3] overrides the generator (parity tests)."""
        p = pl.perturbs
        u = (draw_uniforms((p, 3), generator) if uniforms is None
             else torch.tensor(np.asarray(uniforms, np.float32)))
        med = self._ensemble(
            np.zeros(1, np.int32), np.array([pl.row], np.float32),
            np.array([pl.col], np.float32), np.array([pl.scale], np.float32),
            np.array([flip_v]), u[None], pixels, rows, cols, dim, angle)
        return Puploc(row=int(med[0, 0]), col=int(med[1, 0]),
                      scale=float(med[2, 0]), perturbs=p)

    def _ensemble(self, casc_id, rows0, cols0, scales0, flips, u, pixels,
                  rows, cols, dim, angle) -> np.ndarray:
        """One kernel walk for all groups -> host medians [3, G]."""
        return ensemble_medians(
            self.tensors, casc_id, rows0, cols0, scales0, flips, u,
            device_pixels(pixels, self.device), rows, cols, dim,
            angle).cpu().numpy()

    def run_detector_multi(self, pls: list[Puploc], pixels, rows: int,
                           cols: int, dim: int | None = None,
                           angle: float = 0.0,
                           flips: list[bool] | None = None,
                           generator: torch.Generator | None = None
                           ) -> list[Puploc]:
        """All G anchors' ensembles in one kernel walk and one download
        (a frame's 2F eye anchors refined together)."""
        g = len(pls)
        if g == 0:
            return []
        p = pls[0].perturbs
        if any(pl.perturbs != p for pl in pls):
            raise ValueError("run_detector_multi requires uniform perturbs")
        med = self._ensemble(
            np.zeros(g, np.int32),
            np.array([pl.row for pl in pls], np.float32),
            np.array([pl.col for pl in pls], np.float32),
            np.array([pl.scale for pl in pls], np.float32),
            np.zeros(g, bool) if flips is None else np.asarray(flips, bool),
            draw_uniforms((g, p, 3), generator), pixels, rows, cols, dim,
            angle)
        return [Puploc(row=int(med[0, i]), col=int(med[1, i]),
                       scale=float(med[2, i]), perturbs=p) for i in range(g)]
