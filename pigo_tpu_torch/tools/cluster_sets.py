"""Seeded detection sets that hold the cluster kernel to the host clustering.

Shared by chip_smoke.py (phase 5), the card tests, the CPU tests and
`tools/cluster_sweep.py`, so that all of them check and time the same
inputs. Each set is a buffer of rows as `merge_tail` or a hit list leaves
them: `dets` f32 [m, 4] (row, col, scale, q), a `valid` mask and a
`count`; the entries are the valid rows among the first `count`
(`entries()`), and `ops/cluster.cluster_detections` of those entries at
`iou` is the answer.

- `random_sets`: the smoke's seeded sets since PR 6 (0, 1, 60, 312 and
  `capacity` boxes over a 1080p frame, scales 40 to 194, six q values, so
  equal-q ties) at IoU 0.2;
- `edge_sets`: the thresholds -0.1, 0.0, 0.1, 0.2, 0.5 and 1.0 on an
  overlapping set with fractional and negative coordinates, scale-0
  entries and ties; scale-0 entries alone with others; a valid mask with
  holes and a count below the populated rows; the bit-word edges 1, 31,
  32, 33, 1024 and 4096 (up to `capacity`); 1024 entries that all join
  (IoU -0.1); identical entries; every q equal; the two pairs whose IoU is
  exactly the threshold in f64.
"""

from __future__ import annotations

import dataclasses

import numpy as np

THRESHOLDS = (-0.1, 0.0, 0.1, 0.2, 0.5, 1.0)
WORD_EDGES = (1, 31, 32, 33, 1024, 4096)
# the pairs whose IoU is exactly the threshold in f64: 12 / 60 and 6 / 12
AT_THRESHOLD = {0.2: [(10, 10, 6, 3.0), (10, 14, 6, 2.0)],
                0.5: [(20, 20, 3, 1.5), (20, 21, 3, 1.5)]}
Q_VALUES = np.float32([0.5, 1.25, 2.0, 3.75, 5.5, 9.0])


@dataclasses.dataclass(frozen=True)
class ClusterSet:
    name: str
    dets: np.ndarray   # f32 [m, 4]
    valid: np.ndarray  # bool [m]
    count: int
    iou: float

    def entries(self) -> np.ndarray:
        """The entries the clustering sees, f64 [k, 4]."""
        c = self.count
        return self.dets[:c][self.valid[:c]].astype(np.float64)


def full(name: str, dets, iou: float) -> ClusterSet:
    dets = np.asarray(dets, np.float32).reshape(-1, 4)
    n = dets.shape[0]
    return ClusterSet(name, dets, np.ones(n, bool), n, iou)


def random_sets(capacity: int) -> list[ClusterSet]:
    """The smoke's seeded random sets (module docstring)."""
    rng = np.random.default_rng(0)
    out = []
    for n in (0, 1, 60, 312, capacity):
        rows = rng.integers(20, 1060, n)
        cols = rng.integers(20, 1900, n)
        scales = rng.choice(np.arange(40, 200, 7), n)
        q = rng.choice(Q_VALUES, n)
        out.append(full(f"random_{n}", np.stack([rows, cols, scales, q], 1),
                        0.2))
    return out


def _boxes(rng, n, extent, scales):
    """n boxes over [0, extent)^2 with quarter-pixel coordinates."""
    rows = rng.integers(0, 4 * extent, n) / 4.0
    cols = rng.integers(0, 4 * extent, n) / 4.0
    return np.stack([rows, cols, rng.choice(scales, n),
                     rng.choice(Q_VALUES, n)], 1)


def edge_sets(capacity: int) -> list[ClusterSet]:
    """The edge cases of the kernel's design (module docstring), each with
    at most `capacity` rows."""
    rng = np.random.default_rng(8)
    out = []
    # overlapping boxes: fractional and negative coordinates, scale 0
    mixed = _boxes(rng, 96, 48, [0.0, 6.0, 10.5, 16.0, 23.25])
    mixed[:, :2] -= 8.0
    for thr in THRESHOLDS:
        out.append(full(f"mixed_{thr}", mixed, thr))
    # scale-0 entries: at one point, on another's edge, inside others
    zero = np.concatenate([
        np.array([[30, 30, 0, 1.25], [30, 30, 0, 2.0], [30, 35, 0, 1.25],
                  [40, 40, 0, 0.5], [25, 25, 0, 9.0], [0, 0, 0, 3.75]]),
        _boxes(rng, 18, 40, [8.0, 12.0, 20.0])])
    for thr in (-0.1, 0.2):
        out.append(full(f"scale0_{thr}", zero, thr))
    # a hit buffer with holes and rows past the count
    held = _boxes(rng, 200, 120, [12.0, 17.0, 24.0, 31.5]).astype(np.float32)
    holes = rng.random(200) < 0.7
    out.append(ClusterSet("holes", held, holes, 150, 0.2))
    for n in WORD_EDGES:
        if n <= capacity:
            extent = int(12 * np.sqrt(n)) + 8
            out.append(full(f"words_{n}", _boxes(
                rng, n, extent, [10.0, 14.0, 19.5, 26.0]), 0.2))
    if capacity >= 1024:
        out.append(full("all_join_1024", _boxes(rng, 1024, 400, [20.0, 33.0]),
                        -0.1))
    out.append(full("identical", np.tile([[50.5, 60.25, 24.0, 2.0]],
                                         (40, 1)), 0.2))
    same_q = _boxes(rng, 100, 60, [12.0, 18.0, 25.0])
    same_q[:, 3] = 2.5
    out.append(full("equal_q", same_q, 0.2))
    for thr, pair in AT_THRESHOLD.items():
        out.append(full(f"at_threshold_{thr}", pair, thr))
    return [s for s in out if s.dets.shape[0] <= capacity]


def buffers(cs: ClusterSet, capacity: int, device):
    """cluster_device's inputs for `cs` at `capacity` slots on `device`:
    (dets f32 [capacity, 4], valid bool [capacity], count int32 [1])."""
    import torch

    m = cs.dets.shape[0]
    dets = np.zeros((capacity, 4), np.float32)
    dets[:m] = cs.dets
    valid = np.zeros(capacity, bool)
    valid[:m] = cs.valid
    return (torch.from_numpy(dets).to(device),
            torch.from_numpy(valid).to(device),
            torch.tensor([cs.count], dtype=torch.int32, device=device))


def seed_count(entries: np.ndarray, iou: float) -> int:
    """The seeds of the host's chain over f64 entries [k, 4]: the sorted
    positions still unassigned when the chain reaches them, a cluster or
    not (a seed that joins nothing makes none). Each needs a row of IoU
    tests, which is the work the kernel's bound counts."""
    from pigo_tpu_torch.ops.cluster import iou_matrix

    d = entries[np.argsort(entries[:, 3], kind="stable")]
    with np.errstate(invalid="ignore"):
        member = iou_matrix(d) > iou
    assigned = np.zeros(d.shape[0], bool)
    seeds = 0
    for i in range(d.shape[0]):
        if not assigned[i]:
            seeds += 1
            assigned |= member[i]
    return seeds
