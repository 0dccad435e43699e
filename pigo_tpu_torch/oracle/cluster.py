"""IoU clustering oracle (reference core/pigo.go:262-308).

The reference sorts detections ascending by score, then for each unvisited
detection unions EVERY detection (including already-clustered ones) whose IoU
exceeds the threshold into an averaged cluster. IoU treats detections as
square boxes and divides by the union `s1^2 + s2^2 - inter`.
"""

from __future__ import annotations

import numpy as np


def oracle_cluster_detections(dets: np.ndarray, iou_threshold: float) -> np.ndarray:
    """dets: [N, 4] (row, col, scale, q). Returns clusters [M, 4]."""
    dets = np.asarray(dets, dtype=np.float64).reshape(-1, 4)
    n = dets.shape[0]
    if n == 0:
        return dets.copy()

    # Ascending by q. Go's sort.Slice is unstable; stable here — tie order can
    # differ, which only permutes equal-q rows and does not change the unions.
    order = np.argsort(dets[:, 3], kind="stable")
    d = dets[order]

    r, c, s = d[:, 0], d[:, 1], d[:, 2]
    over_row = np.maximum(
        0.0,
        np.minimum(r[:, None] + s[:, None] / 2, r[None, :] + s[None, :] / 2)
        - np.maximum(r[:, None] - s[:, None] / 2, r[None, :] - s[None, :] / 2),
    )
    over_col = np.maximum(
        0.0,
        np.minimum(c[:, None] + s[:, None] / 2, c[None, :] + s[None, :] / 2)
        - np.maximum(c[:, None] - s[:, None] / 2, c[None, :] - s[None, :] / 2),
    )
    inter = over_row * over_col
    iou = inter / (s[:, None] ** 2 + s[None, :] ** 2 - inter)

    assigned = np.zeros(n, dtype=bool)
    clusters = []
    for i in range(n):
        if assigned[i]:
            continue
        member = iou[i] > iou_threshold
        assigned |= member
        nn = int(member.sum())
        if nn > 0:
            # Go accumulates Row/Col/Scale as ints and divides with integer
            # (truncating) division; q is summed in float32.
            rr = int(d[member, 0].astype(np.int64).sum()) // nn
            cc = int(d[member, 1].astype(np.int64).sum()) // nn
            ss = int(d[member, 2].astype(np.int64).sum()) // nn
            qq = np.float32(0.0)
            for v in d[member, 3]:
                qq = np.float32(qq + np.float32(v))
            clusters.append((rr, cc, ss, float(qq)))
    return np.array(clusters, dtype=np.float64).reshape(-1, 4)
