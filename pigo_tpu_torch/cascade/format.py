"""Binary-exact parsers for the frozen PICO cascade formats.

The model files are opaque little-endian binaries, loaded read-only.

Face cascade layout (reference: core/pigo.go:51-110):
    8-byte header (skipped)
    u32 tree_depth            (facefinder: 6)
    u32 tree_num              (facefinder: 468)
    per tree:
        int8 codes[4 * 2^depth - 4]   node pixel-pair offsets (r1,c1,r2,c2)
        f32  preds[2^depth]           leaf scores
        f32  threshold                per-tree soft-cascade threshold
    The reference prepends 4 zero bytes per tree so node 0 is a zero pad and
    internal node n lives at codes[4*n], n in [1, 2^depth - 1).

Pupil/landmark cascade layout (reference: core/puploc.go:38-103):
    u32 stages                (puploc: 5, lps: 6)
    f32 scale_mult            (puploc: 0.8, lps: 0.7)
    u32 trees_per_stage       (20)
    u32 tree_depth            (puploc: 10, lps: 9)
    per stage, per tree:
        int8 codes[4 * 2^depth - 4]   node offsets; node n at codes[4*n],
                                      n in [0, 2^depth - 1) (no pad)
        f32  preds[2^depth][2]        leaf (dr, dc) regression outputs
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaceForest:
    """SoA storage of a face-detection decision forest (host numpy).

    Shapes (T = tree_num, L = 2^depth leaves, L also = #nodes incl. zero pad):
        codes:  int8 [T, L, 4]   node (r1, c1, r2, c2) offsets; node 0 zeroed
        preds:  f32  [T, L]      leaf scores
        thresh: f32  [T]         per-tree soft-cascade thresholds
    """

    depth: int
    codes: np.ndarray
    preds: np.ndarray
    thresh: np.ndarray

    @property
    def num_trees(self) -> int:
        return self.codes.shape[0]

    @property
    def num_leaves(self) -> int:
        return 1 << self.depth


@dataclasses.dataclass(frozen=True)
class PupilForest:
    """SoA storage of a pupil/landmark regression forest.

    Shapes (S = stages, T = trees/stage, L = 2^depth):
        codes: int8 [S, T, L, 4]   node offsets; only nodes [0, L-1) are real,
                                   slot L-1 is a zero pad for uniform indexing
        preds: f32  [S, T, L, 2]   leaf (dr, dc)
    """

    stages: int
    scale_mult: float
    trees: int
    depth: int
    codes: np.ndarray
    preds: np.ndarray

    @property
    def num_leaves(self) -> int:
        return 1 << self.depth


def unpack_face_cascade(packet: bytes) -> FaceForest:
    """Parse a face cascade binary (e.g. the bundled `facefinder`).

    Byte-for-byte equivalent of the reference deserializer
    (core/pigo.go:51-110).
    """
    buf = memoryview(packet)
    header = np.frombuffer(buf[8:16], dtype="<u4")
    depth = int(header[0])
    num_trees = int(header[1])
    if not (1 <= depth <= 16) or not (1 <= num_trees <= 1_000_000):
        raise ValueError(
            f"invalid face cascade header: depth={depth} trees={num_trees}"
        )

    leaves = 1 << depth
    code_bytes = 4 * leaves - 4
    # Per-tree record: codes + leaf preds (f32) + threshold (f32).
    rec_bytes = code_bytes + 4 * leaves + 4
    expected = 16 + num_trees * rec_bytes
    if len(packet) < expected:
        raise ValueError(
            f"face cascade truncated: need {expected} bytes, got {len(packet)}"
        )

    rec = np.frombuffer(buf[16 : 16 + num_trees * rec_bytes], dtype=np.uint8)
    rec = rec.reshape(num_trees, rec_bytes)

    codes = np.zeros((num_trees, leaves, 4), dtype=np.int8)
    codes[:, 1:, :] = rec[:, :code_bytes].view(np.int8).reshape(
        num_trees, leaves - 1, 4
    )
    tail = rec[:, code_bytes:].copy().view("<f4").reshape(num_trees, leaves + 1)
    preds = np.ascontiguousarray(tail[:, :leaves], dtype=np.float32)
    thresh = np.ascontiguousarray(tail[:, leaves], dtype=np.float32)
    return FaceForest(depth=depth, codes=codes, preds=preds, thresh=thresh)


def unpack_pupil_cascade(packet: bytes) -> PupilForest:
    """Parse a pupil/landmark regression cascade binary.

    Byte-for-byte equivalent of the reference deserializer
    (core/puploc.go:38-103).
    """
    buf = memoryview(packet)
    head_u = np.frombuffer(buf[:16], dtype="<u4")
    head_f = np.frombuffer(buf[:16], dtype="<f4")
    stages = int(head_u[0])
    scale_mult = float(head_f[1])
    trees = int(head_u[2])
    depth = int(head_u[3])
    if not (1 <= stages <= 64) or not (1 <= trees <= 4096) or not (1 <= depth <= 16):
        raise ValueError(
            f"invalid pupil cascade header: stages={stages} trees={trees} depth={depth}"
        )

    leaves = 1 << depth
    code_bytes = 4 * leaves - 4
    rec_bytes = code_bytes + 8 * leaves
    total = stages * trees
    expected = 16 + total * rec_bytes
    if len(packet) < expected:
        raise ValueError(
            f"pupil cascade truncated: need {expected} bytes, got {len(packet)}"
        )

    rec = np.frombuffer(buf[16 : 16 + total * rec_bytes], dtype=np.uint8)
    rec = rec.reshape(total, rec_bytes)

    codes = np.zeros((total, leaves, 4), dtype=np.int8)
    # Nodes [0, leaves-1) are real; the last slot stays zero (uniform indexing pad).
    codes[:, : leaves - 1, :] = rec[:, :code_bytes].view(np.int8).reshape(
        total, leaves - 1, 4
    )
    preds = (
        rec[:, code_bytes:]
        .copy()
        .view("<f4")
        .reshape(total, leaves, 2)
        .astype(np.float32)
    )
    return PupilForest(
        stages=stages,
        scale_mult=scale_mult,
        trees=trees,
        depth=depth,
        codes=codes.reshape(stages, trees, leaves, 4),
        preds=preds.reshape(stages, trees, leaves, 2),
    )
