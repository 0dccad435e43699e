"""Detection clustering (IoU union), reference core/pigo.go:262-308.

Host-side numpy implementation — detection counts are tiny (tens), so this
runs after the device hit list reaches the host.
"""

from __future__ import annotations

import numpy as np


def iou_matrix(dets: np.ndarray) -> np.ndarray:
    """Pairwise square-box IoU with the reference's s^2-union denominator."""
    r, c, s = dets[:, 0], dets[:, 1], dets[:, 2]
    half = s / 2.0
    over_row = np.maximum(
        0.0,
        np.minimum(r[:, None] + half[:, None], r[None, :] + half[None, :])
        - np.maximum(r[:, None] - half[:, None], r[None, :] - half[None, :]),
    )
    over_col = np.maximum(
        0.0,
        np.minimum(c[:, None] + half[:, None], c[None, :] + half[None, :])
        - np.maximum(c[:, None] - half[:, None], c[None, :] - half[None, :]),
    )
    inter = over_row * over_col
    return inter / (s[:, None] ** 2 + s[None, :] ** 2 - inter)


def cluster_detections(dets: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Union-cluster detections [N, 4] = (row, col, scale, q) -> [M, 4].

    Reference semantics: ascending-q stable sort; each unvisited seed unions
    every detection with IoU > threshold (including already-clustered ones);
    cluster = integer-mean (row, col, scale) and a sequential f32 q-sum.
    """
    dets = np.asarray(dets, dtype=np.float64).reshape(-1, 4)
    n = dets.shape[0]
    if n == 0:
        return dets.copy()

    d = dets[np.argsort(dets[:, 3], kind="stable")]
    iou = iou_matrix(d)
    assigned = np.zeros(n, dtype=bool)
    clusters = []
    ri = d[:, 0].astype(np.int64)
    ci = d[:, 1].astype(np.int64)
    si = d[:, 2].astype(np.int64)
    qf = d[:, 3].astype(np.float32)
    for i in range(n):
        if assigned[i]:
            continue
        member = iou[i] > iou_threshold
        assigned |= member
        nn = int(member.sum())
        if nn > 0:
            q_sum = np.float32(0.0)
            for v in qf[member]:
                q_sum = np.float32(q_sum + v)
            clusters.append(
                (
                    int(ri[member].sum()) // nn,
                    int(ci[member].sum()) // nn,
                    int(si[member].sum()) // nn,
                    float(q_sum),
                )
            )
    return np.array(clusters, dtype=np.float64).reshape(-1, 4)
