"""Scalar-semantics oracle (NumPy) — the golden reference for parity tests.

The port's copy of pigo_tpu/oracle/, arithmetic unchanged, on the port's
cascade types (cascade/format.py), so that the parity tools
(tools/paritydiff.py, tools/make_golden.py) run where the JAX package is
not installed. These implementations replicate the reference's
arithmetic exactly (integer fixed-point shifts, f32 accumulation order,
bintest polarities, clamp quirks) but are NOT the serving path; the
port's kernels and their plain versions are held against them.
"""

from pigo_tpu_torch.oracle.face import (
    oracle_classify_region,
    oracle_classify_rotated_region,
    oracle_run_cascade,
    oracle_run_cascade_scalar,
)
from pigo_tpu_torch.oracle.pupil import (
    oracle_pupil_walk,
    oracle_pupil_rotated_walk,
    oracle_run_detector,
)
from pigo_tpu_torch.oracle.cluster import oracle_cluster_detections

__all__ = [
    "oracle_classify_region",
    "oracle_classify_rotated_region",
    "oracle_run_cascade",
    "oracle_run_cascade_scalar",
    "oracle_pupil_walk",
    "oracle_pupil_rotated_walk",
    "oracle_run_detector",
    "oracle_cluster_detections",
]
