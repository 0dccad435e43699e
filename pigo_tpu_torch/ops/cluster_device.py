"""On-device IoU clustering (fixed capacity): wrapper and plain version.

The counterpart of pigo_tpu/ops/cluster_device.py. The semantics are the
host clustering's (ops/cluster.py; reference core/pigo.go:262-308), and
here they hold bit for bit, where the JAX function is only within
tolerance (its f32 IoU test and XLA-ordered q sum):
  - the entries are the first min(count, capacity) rows whose valid flag
    is set; `count` is a tensor, read where it lives (on the card, by the
    kernel), so no host synchronisation is needed;
  - ascending-q stable order; each unassigned seed unions every entry with
    IoU > threshold, assigned or not; the IoU in f64, as the host's;
  - cluster = the integer means (sum // n of the truncated coordinates)
    of (row, col, scale) and the sequential f32 sum of q in sorted order.
The slot layout is the JAX function's: the cluster of the seed at
position i of the sorted order goes to slot i, so compacting the valid
slots gives the host function's output in its order.

On a CPU tensor `cluster_device` runs the plain version; on a CUDA tensor
it launches csrc/cluster_device.cu (one cooperative launch over the card,
with a scratch buffer from the caching allocator) through build.launch,
which counts it, or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pigo_tpu_torch.utils import build
from pigo_tpu_torch.utils.device import resolve_device

# Slots one call takes: a row of the kernel's membership matrix holds at
# most 256 words (csrc/cluster_device.cu kClusterMaxWords), and no capacity
# up to this one asks for more shared memory than the H100's 227 KB a
# block (a static_assert there); the scratch buffer is 9.0 MB here.
MAX_CAPACITY = 8192


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pigo_cluster_device.restype = i
    lib.pigo_cluster_device.argtypes = [vp, vp, vp, i, ctypes.c_double, vp,
                                        vp, vp, vp]
    lib.pigo_cluster_scratch_bytes.restype = ctypes.c_longlong
    lib.pigo_cluster_scratch_bytes.argtypes = [i]


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    return build.load("cluster_device", _bind)


def _check(dets, valid, count, capacity):
    if not 0 <= capacity <= MAX_CAPACITY:
        raise ValueError(f"capacity {capacity} outside [0, {MAX_CAPACITY}]")
    if (dets.dtype != torch.float32
            or tuple(dets.shape) != (capacity, 4)):
        raise ValueError(f"dets must be f32 [{capacity}, 4], got "
                         f"{dets.dtype} {tuple(dets.shape)}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (capacity,):
        raise ValueError(f"valid must be bool [{capacity}], got "
                         f"{valid.dtype} {tuple(valid.shape)}")
    if count.dtype != torch.int32 or count.numel() != 1:
        raise ValueError(f"count must be one int32, got {count.dtype} "
                         f"{tuple(count.shape)}")
    devs = {t.device for t in (dets, valid, count)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if not (dets.is_contiguous() and valid.is_contiguous()):
        raise ValueError("cluster_device needs contiguous dets and valid")


def cluster_plain(dets, valid, count, iou_threshold: float):
    """The plain version: (clusters f32 [CC, 4], cluster_valid bool [CC])
    on dets' device. The order and the IoU are computed there; the seed
    loop runs on the host, as ops/cluster.py's does."""
    cc = dets.shape[0]
    dev = dets.device
    out = torch.zeros((cc, 4), dtype=torch.float32)
    out_valid = torch.zeros(cc, dtype=torch.bool)
    n = min(max(int(count.reshape(-1)[0]), 0), cc)
    d = dets[:n][valid[:n]]
    d = d[torch.sort(d[:, 3], stable=True).indices]
    x = d.to(torch.float64)
    r, c, s = x[:, 0], x[:, 1], x[:, 2]
    half = s / 2.0

    def overlap(p):
        lo = torch.maximum((p - half)[:, None], (p - half)[None, :])
        hi = torch.minimum((p + half)[:, None], (p + half)[None, :])
        return (hi - lo).clamp(min=0.0)

    inter = overlap(r) * overlap(c)
    union = (s * s)[:, None] + (s * s)[None, :] - inter
    member = (inter / union > float(iou_threshold)).cpu()
    coords = d[:, :3].to(torch.int64).cpu()
    q = d[:, 3].cpu()
    assigned = torch.zeros(d.shape[0], dtype=torch.bool)
    for i in range(d.shape[0]):
        if assigned[i]:
            continue
        m = member[i]
        assigned |= m
        nn = int(m.sum())
        if nn == 0:
            continue
        q_sum = torch.zeros((), dtype=torch.float32)
        for v in q[m]:
            q_sum = q_sum + v
        out[i, :3] = (coords[m].sum(0) // nn).to(torch.float32)
        out[i, 3] = q_sum
        out_valid[i] = True
    return out.to(dev), out_valid.to(dev)


def cluster_device(dets: torch.Tensor, valid: torch.Tensor,
                   count: torch.Tensor, iou_threshold: float, *,
                   capacity: int):
    """(clusters f32 [CC, 4], cluster_valid bool [CC]) of dets f32 [CC, 4]
    (row, col, scale, q), valid bool [CC] and count int32 [1] (or []), all
    on one device, with CC = capacity (module docstring)."""
    _check(dets, valid, count, capacity)
    dev = dets.device
    if dev.type == "cpu":
        return cluster_plain(dets, valid, count, iou_threshold)
    if dev.type != "cuda":
        raise ValueError(f"cluster_device runs on cuda or cpu, not {dev}")
    out = torch.empty((capacity, 4), dtype=torch.float32, device=dev)
    out_valid = torch.empty(capacity, dtype=torch.bool, device=dev)
    if capacity == 0:
        return out, out_valid
    lib = load_kernel()
    # contents ignored: the kernel initialises what it reads
    scratch = torch.empty(lib.pigo_cluster_scratch_bytes(capacity),
                          dtype=torch.uint8, device=dev)
    build.launch(lib, "pigo_cluster_device", (
        dets.data_ptr(), valid.data_ptr(), count.data_ptr(), capacity,
        float(iou_threshold), out.data_ptr(), out_valid.data_ptr(),
        scratch.data_ptr()), dev, "cluster_device")
    return out, out_valid


def cluster_device_host(dets: np.ndarray, iou_threshold: float,
                        capacity: int = 256,
                        device: str | torch.device | None = None
                        ) -> np.ndarray:
    """Convenience wrapper: host [N, 4] in -> clustered host [M, 4] f64
    out through `cluster_device` on `device` (the card by default; pads to
    `capacity`; N must be <= capacity)."""
    dets = np.asarray(dets, np.float64).reshape(-1, 4)
    n = dets.shape[0]
    if n > capacity:
        raise ValueError(f"{n} detections exceed device capacity {capacity}")
    dev = resolve_device(device)
    buf = np.zeros((capacity, 4), np.float32)
    buf[:n] = dets
    out, ov = cluster_device(
        torch.from_numpy(buf).to(dev), torch.arange(capacity, device=dev) < n,
        torch.tensor([n], dtype=torch.int32, device=dev), iou_threshold,
        capacity=capacity)
    out, ov = out.cpu().numpy(), ov.cpu().numpy()
    return out[ov].astype(np.float64)
