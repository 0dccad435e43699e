"""pigo_tpu_torch — the PICO family on PyTorch and CUDA (NVIDIA H100).

A port of `pigo_tpu` (JAX/Pallas on a TPU), which stays the reference it is
held against, bit for bit. The port imports torch and numpy only, never jax
and nothing of `pigo_tpu`. Its hand-written kernels build with nvcc at
first use from four sources: the soft-cascade face classifier and the exact
finish (csrc/face_cascade.cu), the tree-prefix pass over the tail scales
(csrc/face_prefix.cu), both on the schedule of csrc/face_walk.cuh; the
pupil/landmark regression walk (csrc/pupil_walk.cu); and the on-card IoU
clustering (csrc/cluster_device.cu). Its host C++ engine
(native/pigo_native.cpp: the opt-in host tail of the face stage,
`native_cluster`) builds with g++ at first use. The command line is
`python -m pigo_tpu_torch.cli` (`pigo-tpu-torch`).

Subpackages beside the serving path: `parallel` (multi-GPU detection over
torch.distributed: window-band sharding and frame data parallelism,
`ShardedFaceCascade`, `make_mesh`, `init_distributed`), `oracle` (the
NumPy oracle, a copy of the JAX package's), `tools` (`paritydiff`,
`make_golden`, and the kernels' timing sweeps), `web` (the serving
surface: the detection engines, the web server `python -m
pigo_tpu_torch.web.main` and its load client) and `demos` (the seven
realtime demos, `python -m pigo_tpu_torch.demos.<name>`).
"""

from __future__ import annotations

from pigo_tpu_torch.cascade.assets import load_facefinder
from pigo_tpu_torch.detector import FaceDetector
from pigo_tpu_torch.models.face import FaceCascade
from pigo_tpu_torch.models.landmark import LandmarkLocalizer
from pigo_tpu_torch.models.pupil import PupilLocalizer, Puploc
from pigo_tpu_torch.ops.cluster import cluster_detections

__version__ = "0.1.0"

__all__ = [
    "FaceCascade",
    "FaceDetector",
    "LandmarkLocalizer",
    "PupilLocalizer",
    "Puploc",
    "cluster_detections",
    "load_facefinder",
]
