"""Pupil/landmark oracle: exact reference semantics in NumPy.

Replicates core/puploc.go classifyRegion (:106-154),
classifyRotatedRegion (:157-217) and RunDetector (:239-277) including:
  - per-stage regression: r += dr*s, c += dc*s, s *= scale_mult in float32,
  - int() truncation of the float32 center and ties-away rounding of scale,
  - bintest polarity `p1 > p2 -> 1` in the upright walk but `px1 <= px2 -> 1`
    in the rotated walk (an internal inconsistency in the reference,
    preserved as-is for parity),
  - per-axis clamps (rows by nrows-1, cols by ncols-1),
  - flipV negation of column codes and dc (mirror trick for right-side
    landmarks),
  - per-axis median over the perturbation ensemble at index round(P/2).

RNG note: the reference jitters perturbations with the global math/rand
(nondeterministic seed); deterministic parity is therefore only defined when
oracle and kernel consume the SAME perturbation triples, which both APIs here
accept explicitly.
"""

from __future__ import annotations

import numpy as np

from pigo_tpu_torch.cascade.format import PupilForest

QCOS_TABLE_F32 = np.array(
    [256, 251, 236, 212, 181, 142, 97, 49, 0, -49, -97, -142, -181, -212,
     -236, -251, -256, -251, -236, -212, -181, -142, -97, -49, 0, 49, 97,
     142, 181, 212, 236, 251, 256],
    dtype=np.float32,
)
QSIN_TABLE_F32 = np.array(
    [0, 49, 97, 142, 181, 212, 236, 251, 256, 251, 236, 212, 181, 142, 97,
     49, 0, -49, -97, -142, -181, -212, -236, -251, -256, -251, -236, -212,
     -181, -142, -97, -49, 0],
    dtype=np.float32,
)


def round_away(x: np.ndarray | float) -> np.ndarray:
    """math.Round semantics: round half away from zero (Go math.Round)."""
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def oracle_pupil_walk(
    forest: PupilForest,
    r: np.ndarray,
    c: np.ndarray,
    s: np.ndarray,
    nrows: int,
    ncols: int,
    pixels: np.ndarray,
    dim: int,
    flip_v: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized upright regression walk over a batch of start triples.

    r/c/s: float32 [P]. Returns refined (r, c, s) float32 [P].
    Reference: core/puploc.go:106-154.
    """
    pix = np.asarray(pixels, dtype=np.uint8).ravel()
    r = np.asarray(r, dtype=np.float32).copy()
    c = np.asarray(c, dtype=np.float32).copy()
    s = np.asarray(s, dtype=np.float32).copy()
    leaves = forest.num_leaves
    codes = forest.codes.astype(np.int64)  # [S, T, L, 4]
    col_sign = -1 if flip_v else 1

    for i in range(forest.stages):
        # int(r): Go float->int truncation toward zero; int(round(s)): ties away.
        ri = 256 * r.astype(np.int64)
        ci = 256 * c.astype(np.int64)
        si = round_away(s).astype(np.int64)
        dr = np.zeros_like(r)
        dc = np.zeros_like(c)
        for j in range(forest.trees):
            idx = np.zeros(r.shape[0], dtype=np.int64)
            for _ in range(forest.depth):
                nc = codes[i, j, idx]  # [P, 4]
                r1 = np.minimum(nrows - 1, np.maximum(0, (ri + nc[:, 0] * si) >> 8))
                r2 = np.minimum(nrows - 1, np.maximum(0, (ri + nc[:, 2] * si) >> 8))
                c1 = np.minimum(
                    ncols - 1, np.maximum(0, (ci + col_sign * nc[:, 1] * si) >> 8)
                )
                c2 = np.minimum(
                    ncols - 1, np.maximum(0, (ci + col_sign * nc[:, 3] * si) >> 8)
                )
                b = pix[r1 * dim + c1] > pix[r2 * dim + c2]
                idx = 2 * idx + 1 + b
            leaf = idx - (leaves - 1)
            dr = dr + forest.preds[i, j, leaf, 0]
            dc = dc + np.float32(col_sign) * forest.preds[i, j, leaf, 1]
        r = r + dr * s
        c = c + dc * s
        s = s * np.float32(forest.scale_mult)
    return r, c, s


def oracle_pupil_rotated_walk(
    forest: PupilForest,
    r: np.ndarray,
    c: np.ndarray,
    s: np.ndarray,
    angle: float,
    nrows: int,
    ncols: int,
    pixels: np.ndarray,
    dim: int,
    flip_v: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rotated regression walk (reference core/puploc.go:157-217).

    Note the bintest polarity here is `px1 <= px2 -> 1`, unlike the upright
    pupil walk — preserved for parity.
    """
    pix = np.asarray(pixels, dtype=np.uint8).ravel()
    r = np.asarray(r, dtype=np.float32).copy()
    c = np.asarray(c, dtype=np.float32).copy()
    s = np.asarray(s, dtype=np.float32).copy()
    leaves = forest.num_leaves
    codes = forest.codes.astype(np.int64)
    col_sign = -1 if flip_v else 1
    tbl = int(32.0 * angle)

    for i in range(forest.stages):
        qsin = (s * QSIN_TABLE_F32[tbl]).astype(np.int64)  # int(f32) truncation
        qcos = (s * QCOS_TABLE_F32[tbl]).astype(np.int64)
        ri = 65536 * r.astype(np.int64)
        ci = 65536 * c.astype(np.int64)
        dr = np.zeros_like(r)
        dc = np.zeros_like(c)
        for j in range(forest.trees):
            idx = np.zeros(r.shape[0], dtype=np.int64)
            for _ in range(forest.depth):
                nc = codes[i, j, idx]
                row1, row2 = nc[:, 0], nc[:, 2]
                col1 = col_sign * nc[:, 1]
                col2 = col_sign * nc[:, 3]
                r1 = np.minimum(
                    nrows - 1, np.maximum(0, ri + qcos * row1 - qsin * col1) >> 16
                )
                c1 = np.minimum(
                    ncols - 1, np.maximum(0, ci + qsin * row1 + qcos * col1) >> 16
                )
                r2_ = np.minimum(
                    nrows - 1, np.maximum(0, ri + qcos * row2 - qsin * col2) >> 16
                )
                c2_ = np.minimum(
                    ncols - 1, np.maximum(0, ci + qsin * row2 + qcos * col2) >> 16
                )
                b = pix[r1 * dim + c1] <= pix[r2_ * dim + c2_]
                idx = 2 * idx + 1 + b
            leaf = idx - (leaves - 1)
            dr = dr + forest.preds[i, j, leaf, 0]
            dc = dc + np.float32(col_sign) * forest.preds[i, j, leaf, 1]
        r = r + dr * s
        c = c + dc * s
        s = s * np.float32(forest.scale_mult)
    return r, c, s


def make_perturbations(
    row: float, col: float, scale: float, u: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Jittered start triples from uniforms u [P, 3] in [0, 1).

    Reference jitter (core/puploc.go:248-250):
        row' = row + scale*0.15*(0.5 - u1)
        col' = col + scale*0.15*(0.5 - u2)
        s'   = scale*(0.925 + 0.15*u3)
    """
    u = np.asarray(u, dtype=np.float32)
    row = np.float32(row)
    col = np.float32(col)
    scale = np.float32(scale)
    rows = row + scale * np.float32(0.15) * (np.float32(0.5) - u[:, 0])
    cols = col + scale * np.float32(0.15) * (np.float32(0.5) - u[:, 1])
    scales = scale * (np.float32(0.925) + np.float32(0.15) * u[:, 2])
    return rows, cols, scales


def oracle_run_detector(
    forest: PupilForest,
    starts: tuple[np.ndarray, np.ndarray, np.ndarray],
    nrows: int,
    ncols: int,
    pixels: np.ndarray,
    dim: int,
    angle: float = 0.0,
    flip_v: bool = False,
) -> tuple[int, int, float]:
    """Perturbation ensemble + per-axis median vote (core/puploc.go:239-277).

    `starts` are the P jittered (row, col, scale) float32 triples. Returns the
    median-voted (row:int, col:int, scale:float32).
    """
    r0, c0, s0 = starts
    if angle > 0.0:
        angle = min(angle, 1.0)
        r, c, s = oracle_pupil_rotated_walk(
            forest, r0, c0, s0, angle, nrows, ncols, pixels, dim, flip_v
        )
    else:
        r, c, s = oracle_pupil_walk(
            forest, r0, c0, s0, nrows, ncols, pixels, dim, flip_v
        )
    p = r0.shape[0]
    # round(P/2) as in the reference; clamped to the valid range (the Go code
    # indexes a fixed 63-slot pool and would read stale slots for tiny P).
    mid = min(int(round_away(p / 2.0)), p - 1)
    r_s = np.sort(r)
    c_s = np.sort(c)
    s_s = np.sort(s)
    return int(r_s[mid]), int(c_s[mid]), float(s_s[mid])
