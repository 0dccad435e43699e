"""Face-cascade oracle: exact reference semantics in NumPy.

Replicates core/pigo.go classifyRegion (:113-147),
classifyRotatedRegion (:150-191) and RunCascade (:212-258) including:
  - 8.8 fixed-point window math `((r*256 + code*s) >> 8)` with arithmetic
    (floor) shifts,
  - bintest polarity `px1 <= px2 -> 1`,
  - strict left-to-right float32 accumulation of leaf predictions,
  - soft-cascade early exit `out <= thresh[i] -> -1.0`,
  - final score `out - thresh[-1]`,
  - the rotated path's quantized 33-entry sin/cos tables, 16.16 fixed point,
    and its clamp quirk (columns clamped with nrows-1, not ncols-1).
"""

from __future__ import annotations

import numpy as np

from pigo_tpu_torch.cascade.format import FaceForest

# Quantized 256-scaled cos/sin lookup, indexed by int(32 * angle), angle in
# [0, 1] as a fraction of 2*pi (reference: core/pigo.go:156-157).
QCOS_TABLE = np.array(
    [256, 251, 236, 212, 181, 142, 97, 49, 0, -49, -97, -142, -181, -212,
     -236, -251, -256, -251, -236, -212, -181, -142, -97, -49, 0, 49, 97,
     142, 181, 212, 236, 251, 256],
    dtype=np.int64,
)
QSIN_TABLE = np.array(
    [0, 49, 97, 142, 181, 212, 236, 251, 256, 251, 236, 212, 181, 142, 97,
     49, 0, -49, -97, -142, -181, -212, -236, -251, -256, -251, -236, -212,
     -181, -142, -97, -49, 0],
    dtype=np.int64,
)


def oracle_classify_region(
    forest: FaceForest,
    rows_w: np.ndarray,
    cols_w: np.ndarray,
    scale: int,
    pixels: np.ndarray,
    dim: int,
) -> np.ndarray:
    """Vectorized-over-windows exact classifier at one scale.

    rows_w/cols_w: int window centers, shape [W]. pixels: flat uint8 [rows*cols].
    Returns float32 scores [W] (-1.0 for early-exited windows).
    """
    rows_w = np.asarray(rows_w, dtype=np.int64)
    cols_w = np.asarray(cols_w, dtype=np.int64)
    pix = np.asarray(pixels, dtype=np.uint8).ravel()
    leaves = forest.num_leaves
    codes = forest.codes.astype(np.int64)  # [T, L, 4]
    s = int(scale)

    w = rows_w.shape[0]
    r256 = rows_w * 256
    c256 = cols_w * 256

    out = np.zeros(w, dtype=np.float32)
    result = np.full(w, -1.0, dtype=np.float32)
    active = np.arange(w)

    for t in range(forest.num_trees):
        if active.size == 0:
            break
        idx = np.ones(active.size, dtype=np.int64)
        r_a = r256[active]
        c_a = c256[active]
        for _ in range(forest.depth):
            nc = codes[t, idx]  # [A, 4]
            x1 = ((r_a + nc[:, 0] * s) >> 8) * dim + ((c_a + nc[:, 1] * s) >> 8)
            x2 = ((r_a + nc[:, 2] * s) >> 8) * dim + ((c_a + nc[:, 3] * s) >> 8)
            idx = 2 * idx + (pix[x1] <= pix[x2])
        out_a = out[active] + forest.preds[t, idx - leaves]
        out[active] = out_a
        keep = out_a > forest.thresh[t]
        active = active[keep]

    result[active] = out[active] - forest.thresh[forest.num_trees - 1]
    return result


def oracle_classify_rotated_region(
    forest: FaceForest,
    rows_w: np.ndarray,
    cols_w: np.ndarray,
    scale: int,
    angle: float,
    nrows: int,
    ncols: int,
    pixels: np.ndarray,
    dim: int,
) -> np.ndarray:
    """Rotated-window classifier (reference core/pigo.go:150-191).

    Preserves the reference quirks: columns are clamped with nrows-1 (not
    ncols-1), `max(0, .)` is applied before the >>16 shift, and abs() after.
    """
    rows_w = np.asarray(rows_w, dtype=np.int64)
    cols_w = np.asarray(cols_w, dtype=np.int64)
    pix = np.asarray(pixels, dtype=np.uint8).ravel()
    leaves = forest.num_leaves
    codes = forest.codes.astype(np.int64)
    s = int(scale)

    qsin = s * int(QSIN_TABLE[int(32.0 * angle)])
    qcos = s * int(QCOS_TABLE[int(32.0 * angle)])

    w = rows_w.shape[0]
    r65536 = rows_w * 65536
    c65536 = cols_w * 65536

    out = np.zeros(w, dtype=np.float32)
    result = np.full(w, -1.0, dtype=np.float32)
    active = np.arange(w)
    hi = nrows - 1  # reference clamps both axes with nrows-1

    def rot_index(base_r, base_c, code_r, code_c):
        r = np.abs(
            np.minimum(hi, np.maximum(0, base_r + qcos * code_r - qsin * code_c) >> 16)
        )
        c = np.abs(
            np.minimum(hi, np.maximum(0, base_c + qsin * code_r + qcos * code_c) >> 16)
        )
        return r * dim + c

    for t in range(forest.num_trees):
        if active.size == 0:
            break
        idx = np.ones(active.size, dtype=np.int64)
        r_a = r65536[active]
        c_a = c65536[active]
        for _ in range(forest.depth):
            nc = codes[t, idx]
            x1 = rot_index(r_a, c_a, nc[:, 0], nc[:, 1])
            x2 = rot_index(r_a, c_a, nc[:, 2], nc[:, 3])
            idx = 2 * idx + (pix[x1] <= pix[x2])
        out_a = out[active] + forest.preds[t, idx - leaves]
        out[active] = out_a
        keep = out_a > forest.thresh[t]
        active = active[keep]

    result[active] = out[active] - forest.thresh[forest.num_trees - 1]
    return result


def pyramid_scales(min_size: int, max_size: int, scale_factor: float) -> list[int]:
    """Scale progression of RunCascade (reference core/pigo.go:226,255)."""
    scales = []
    scale = int(min_size)
    while scale <= max_size:
        scales.append(scale)
        scale = int(scale + max(2.0, scale * scale_factor - scale))
    return scales


def scale_grid(
    scale: int, rows: int, cols: int, shift_factor: float
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Window-center grid for one scale (reference core/pigo.go:227-231)."""
    step = int(max(shift_factor * scale, 1.0))
    offset = scale // 2 + 1
    rr = np.arange(offset, rows - offset + 1, step, dtype=np.int64)
    cc = np.arange(offset, cols - offset + 1, step, dtype=np.int64)
    return rr, cc, step, offset


def oracle_run_cascade(
    forest: FaceForest,
    pixels: np.ndarray,
    rows: int,
    cols: int,
    dim: int,
    min_size: int,
    max_size: int,
    shift_factor: float,
    scale_factor: float,
    angle: float = 0.0,
) -> np.ndarray:
    """Full multi-scale sliding-window pass (reference core/pigo.go:212-258).

    Returns detections as int/float records [N, 4] = (row, col, scale, q),
    q > 0 only, in the reference's scan order (scale-major, row, col).
    """
    dets: list[tuple[int, int, int, float]] = []
    if angle > 1.0:
        angle = 1.0
    for scale in pyramid_scales(min_size, max_size, scale_factor):
        rr, cc, _, _ = scale_grid(scale, rows, cols, shift_factor)
        if rr.size == 0 or cc.size == 0:
            continue
        rw = np.repeat(rr, cc.size)
        cw = np.tile(cc, rr.size)
        if angle > 0.0:
            q = oracle_classify_rotated_region(
                forest, rw, cw, scale, angle, rows, cols, pixels, dim
            )
        else:
            q = oracle_classify_region(forest, rw, cw, scale, pixels, dim)
        hit = q > 0.0
        for r, c, qq in zip(rw[hit], cw[hit], q[hit]):
            dets.append((int(r), int(c), scale, float(qq)))
    return np.array(dets, dtype=np.float64).reshape(-1, 4)


def oracle_run_cascade_scalar(
    forest: FaceForest,
    pixels: np.ndarray,
    rows: int,
    cols: int,
    dim: int,
    r: int,
    c: int,
    scale: int,
) -> float:
    """Pure-scalar transliteration of classifyRegion, for spot-checking the
    vectorized oracle (reference core/pigo.go:113-147)."""
    pix = np.asarray(pixels, dtype=np.uint8).ravel()
    leaves = forest.num_leaves
    rr = r * 256
    cc = c * 256
    out = np.float32(0.0)
    for t in range(forest.num_trees):
        idx = 1
        for _ in range(forest.depth):
            n0, n1, n2, n3 = (int(v) for v in forest.codes[t, idx])
            x1 = ((rr + n0 * scale) >> 8) * dim + ((cc + n1 * scale) >> 8)
            x2 = ((rr + n2 * scale) >> 8) * dim + ((cc + n3 * scale) >> 8)
            idx = 2 * idx + (1 if pix[x1] <= pix[x2] else 0)
        out = np.float32(out + forest.preds[t, idx - leaves])
        if out <= forest.thresh[t]:
            return -1.0
    return float(np.float32(out - forest.thresh[forest.num_trees - 1]))
