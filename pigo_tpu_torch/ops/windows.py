"""Window-grid planner: the upright pyramid flattened to one window axis.

The reference serializes the pyramid in nested loops (core/pigo.go:226-255):
scale-major, then row, then col. The plan enumerates every (scale, row, col)
window in that order as flat host tables, which the cascade kernel reads
once per window.

Exactness note: for s >= 0 and any code in [-128, 127],
    ((r*256 + code*s) >> 8) == r + ((code*s) >> 8)
because r*256 is a multiple of 256 and >> is an arithmetic (floor) shift.
Hence per-scale node pixel offsets are window-independent: the cascade
kernel reads `pixels[base_w + ((code_r*s) >> 8)*cols + ((code_c*s) >> 8)]`,
computing the offset from the int8 codes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Flat upright pyramid-window table (host numpy, no padding).

    Shapes: W = window count, S = #scales.
        rows_w / cols_w / base / scale_idx / scale_w: int32 [W]
        scales: int32 [S] pyramid scale per scale_idx
    `base` is r*cols + c of the window centre in a contiguous frame.
    """

    rows: int
    cols: int
    rows_w: np.ndarray
    cols_w: np.ndarray
    base: np.ndarray
    scale_idx: np.ndarray
    scale_w: np.ndarray
    scales: np.ndarray

    @property
    def num_windows(self) -> int:
        return self.base.shape[0]


def pyramid_scales(min_size: int, max_size: int, scale_factor: float) -> list[int]:
    """Reference scale progression (core/pigo.go:226,255)."""
    scales = []
    scale = int(min_size)
    while scale <= max_size:
        scales.append(scale)
        scale = int(scale + max(2.0, scale * scale_factor - scale))
    return scales


def build_window_plan(
    rows: int,
    cols: int,
    min_size: int,
    max_size: int,
    shift_factor: float,
    scale_factor: float,
) -> WindowPlan:
    """Enumerate the upright pyramid exactly as RunCascade does.

    Per scale s: step = max(int(shift*s), 1), offset = s//2 + 1, window
    centres r, c in [offset, n - offset] at that step."""
    rws, cws, sids, kept = [], [], [], []
    for s in pyramid_scales(min_size, max_size, scale_factor):
        step = int(max(shift_factor * s, 1.0))
        offset = s // 2 + 1
        rr = np.arange(offset, rows - offset + 1, step, dtype=np.int32)
        cc = np.arange(offset, cols - offset + 1, step, dtype=np.int32)
        if rr.size == 0 or cc.size == 0:
            continue
        rws.append(np.repeat(rr, cc.size))
        cws.append(np.tile(cc, rr.size))
        sids.append(np.full(rr.size * cc.size, len(kept), dtype=np.int32))
        kept.append(s)
    empty = np.zeros(0, np.int32)
    rows_w = np.concatenate(rws) if rws else empty
    cols_w = np.concatenate(cws) if cws else empty
    scale_idx = np.concatenate(sids) if sids else empty
    scales = np.asarray(kept, np.int32)
    base = rows_w.astype(np.int64) * cols + cols_w
    return WindowPlan(
        rows=rows, cols=cols, rows_w=rows_w, cols_w=cols_w,
        base=base.astype(np.int32), scale_idx=scale_idx,
        scale_w=scales[scale_idx] if scale_idx.size else empty,
        scales=scales,
    )

