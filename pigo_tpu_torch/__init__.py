"""pigo_tpu_torch — the PICO face cascade on PyTorch and CUDA (NVIDIA H100).

A port of `pigo_tpu` (JAX/Pallas on a TPU), which stays the reference it is
held against, bit for bit. The port imports torch and numpy only, never jax
and nothing of `pigo_tpu`. Its one hand-written kernel, the soft-cascade
classifier (csrc/face_cascade.cu), builds with nvcc at first use.
"""

from __future__ import annotations

from pigo_tpu_torch.cascade.assets import load_facefinder
from pigo_tpu_torch.models.face import FaceCascade
from pigo_tpu_torch.ops.cluster import cluster_detections

__version__ = "0.1.0"

__all__ = ["FaceCascade", "cluster_detections", "load_facefinder"]
