"""FaceCascade on PyTorch: the upright face-detection serving path.

Public surface mirrors pigo_tpu.models.face.FaceCascade and the reference
library API (core/pigo.go):
    NewPigo().Unpack(bytes)       -> FaceCascade.from_bytes
    (*Pigo).RunCascade(cp, angle) -> FaceCascade.run_cascade(...)
    (*Pigo).ClusterDetections     -> pigo_tpu_torch.ops.cluster.cluster_detections

Per frame the card does one upload from a pinned host buffer, one cascade
launch over every window of the pyramid (ops/face_cuda.py), an on-device
compaction of the hits into one packed f32 buffer, and one download into
pinned memory followed by an event; nothing in a frame synchronises the
host until its hits are collected. Detections are [N, 4] float64
(row, col, scale, q) with q > 0, in reference scan order (scale-major,
then row, then col).

Upright only: angle > 0 raises NotImplementedError (the rotated cascade is
a later part of the port, ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from pigo_tpu_torch.cascade.assets import load_facefinder
from pigo_tpu_torch.cascade.format import FaceForest, unpack_face_cascade
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.ops import face_cuda
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.ops.windows import build_window_plan
from pigo_tpu_torch.utils.device import resolve_device

# Window indices travel as f32 in the packed hit list: exact below 2^24.
MAX_WINDOWS = 1 << 24


def destride(pixels, rows: int, cols: int, dim: int):
    """Flat [rows*dim] buffer with row stride dim -> contiguous
    [rows*cols] (reference ImageParams.Dim, core/pigo.go:29-34). Exact for
    the upright cascade: no window read can reach column >= cols (node
    offsets |(code*s)>>8| < s/2 against the s/2+1 window margin)."""
    if dim < cols:
        raise ValueError(f"dim {dim} < cols {cols}")
    if isinstance(pixels, torch.Tensor):
        return pixels.reshape(rows, dim)[:, :cols].contiguous().reshape(-1)
    return np.ascontiguousarray(
        np.asarray(pixels).reshape(rows, dim)[:, :cols]).reshape(-1)


def compact_hits(q: torch.Tensor, cap: int) -> torch.Tensor:
    """Packed hit list per frame, built where q lives without a host sync
    (no nonzero, no boolean-mask indexing): q f32 [B, W] ->
    f32 [B, 1 + 2*cap] = (count, idx[cap], score[cap]). The first
    min(count, cap) slots hold the hits (q > 0) in scan order; the rest
    hold idx -1. A cumsum gives each hit its slot and, in the same pass,
    the count that detects an overflow; every other window (and every hit
    past cap) is scattered into a dump slot that is cut off. The same code
    runs on both devices, so the CPU tests check the card's path."""
    b, w = q.shape
    hits = q > 0.0
    pos = torch.cumsum(hits, dim=1, dtype=torch.int32)
    slot = torch.where(hits & (pos <= cap), pos - 1, cap).to(torch.int64)
    idx = torch.full((b, cap + 1), -1.0, dtype=torch.float32, device=q.device)
    idx.scatter_(1, slot, torch.arange(w, dtype=torch.float32,
                                       device=q.device).expand(b, w))
    val = torch.zeros((b, cap + 1), dtype=torch.float32, device=q.device)
    val.scatter_(1, slot, q)
    count = pos[:, -1:].to(torch.float32)
    return torch.cat([count, idx[:, :cap], val[:, :cap]], dim=1)


def _check_upright(angle: float) -> None:
    if angle > 0.0:
        raise NotImplementedError(
            "angle > 0: the rotated face cascade is not ported to "
            "pigo_tpu_torch yet (ROADMAP.md, rotated pyramid); this port "
            "runs the upright cascade only")


class _Slot:
    """Host staging for one in-flight dispatch: the frames' upload buffer
    and the packed hit list's download buffer, both pinned on a card. A
    slot is reused only after the dispatch that last used it was
    collected (its event waited on)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.key = None
        self.frames = self.packed = None

    def buffers(self, b: int, rows: int, cols: int, cap: int):
        if self.key != (b, rows, cols, cap):
            pin = self.device.type == "cuda"
            self.frames = torch.empty((b, rows, cols), dtype=torch.uint8,
                                      pin_memory=pin)
            self.packed = torch.empty((b, 1 + 2 * cap), dtype=torch.float32,
                                      pin_memory=pin)
            self.key = (b, rows, cols, cap)
        return self.frames, self.packed


@dataclasses.dataclass
class _Ticket:
    """One dispatched batch: its plan, the device scores (kept for the
    dense re-read on overflow), the packed host buffer and its event."""

    plan: object
    n_frames: int
    cap: int
    q: torch.Tensor | None = None
    packed: torch.Tensor | None = None
    event: object = None


class FaceCascade:
    """Face-detection forest resident on a device, with per-geometry plan
    caching. `device=None` means the CUDA card and raises without one;
    `device="cpu"` runs the plain PyTorch version (tests)."""

    # Fixed capacity of the packed hit list per frame. Real frames yield
    # tens of raw hits; an overflow (count > cap) triggers a dense re-read.
    HIT_CAPACITY = 4096

    def __init__(self, forest: FaceForest | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.forest = load_facefinder() if forest is None else forest
        self.tensors = face_forest_from_numpy(
            self.forest.depth, self.forest.codes, self.forest.preds,
            self.forest.thresh, self.device)
        self._plans: dict[tuple, tuple] = {}
        self._single = _Slot(self.device)
        self._batch = _Slot(self.device)

    @classmethod
    def from_bytes(cls, packet: bytes, device=None) -> "FaceCascade":
        return cls(unpack_face_cascade(packet), device)

    @classmethod
    def from_file(cls, path: str, device=None) -> "FaceCascade":
        with open(path, "rb") as fh:
            return cls.from_bytes(fh.read(), device)

    @classmethod
    def from_forest(cls, forest, device=None) -> "FaceCascade":
        """Any forest with depth/codes/preds/thresh arrays, e.g. the JAX
        package's (read duck-typed, see convert.py)."""
        return cls(FaceForest(
            depth=int(forest.depth), codes=np.asarray(forest.codes),
            preds=np.asarray(forest.preds), thresh=np.asarray(forest.thresh),
        ), device)

    # ------------------------------------------------------------ plan

    def _plan(self, rows, cols, min_size, max_size, shift_factor,
              scale_factor):
        """(host plan, device base, device scale), built and uploaded once
        per geometry."""
        key = (rows, cols, min_size, max_size, shift_factor, scale_factor)
        hit = self._plans.get(key)
        if hit is None:
            plan = build_window_plan(rows, cols, min_size, max_size,
                                     shift_factor, scale_factor)
            if plan.num_windows >= MAX_WINDOWS:
                raise ValueError(f"{plan.num_windows} windows: the packed "
                                 f"hit list holds indices below {MAX_WINDOWS}")
            hit = (plan, *face_cuda.device_plan(plan, self.device))
            self._plans[key] = hit
        return hit

    # ------------------------------------------------- dispatch / collect

    def _upload(self, frames, staging: torch.Tensor) -> torch.Tensor:
        """uint8 [B, rows, cols] frames on the device. Host frames go
        through the (pinned) staging buffer with a non-blocking copy."""
        if isinstance(frames, torch.Tensor):
            if frames.device == self.device:
                return frames.to(torch.uint8).contiguous()
            frames = frames.cpu().numpy()
        if self.device.type == "cpu":
            return torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
        staging.numpy()[...] = frames
        return staging.to(self.device, non_blocking=True)

    def _dispatch(self, frames, slot: _Slot, cfg: dict) -> _Ticket:
        """Async half: upload, one kernel launch for all frames and scales,
        hit compaction and the download of the packed hit lists are all
        enqueued without waiting for the device."""
        b, rows, cols = frames.shape
        plan, base, scale = self._plan(rows, cols, **cfg)
        cap = self.HIT_CAPACITY
        ticket = _Ticket(plan=plan, n_frames=b, cap=cap)
        if plan.num_windows == 0:  # frame smaller than the minimum face
            return ticket
        staging, packed_host = slot.buffers(b, rows, cols, cap)
        f = self.tensors
        ticket.q = face_cuda.face_cascade(
            self._upload(frames, staging), base, scale, f.codes, f.preds,
            f.thresh, f.num_trees)
        packed_host.copy_(compact_hits(ticket.q, cap), non_blocking=True)
        ticket.packed = packed_host
        if self.device.type == "cuda":
            ticket.event = torch.cuda.Event()
            ticket.event.record(torch.cuda.current_stream(self.device))
        return ticket

    def _collect(self, ticket: _Ticket) -> list[np.ndarray]:
        """Blocking half: wait for the packed hit lists, decode per frame.
        The hits are already in scan order (one launch over the plan's
        windows, no host tail to merge), so no sort is needed."""
        if ticket.q is None:
            return [np.zeros((0, 4), np.float64)
                    for _ in range(ticket.n_frames)]
        if ticket.event is not None:
            ticket.event.synchronize()
        plan, cap = ticket.plan, ticket.cap
        packed = ticket.packed.numpy()
        out = []
        for i in range(ticket.n_frames):
            count = int(packed[i, 0])
            if count > cap:  # capacity overflow: dense re-read (rare)
                q = ticket.q[i].cpu().numpy()
                idx = np.nonzero(q > 0.0)[0]
                qv = q[idx]
            else:
                idx = packed[i, 1:1 + count].astype(np.int64)
                qv = packed[i, 1 + cap:1 + cap + count]
            out.append(np.stack([
                plan.rows_w[idx].astype(np.float64),
                plan.cols_w[idx].astype(np.float64),
                plan.scale_w[idx].astype(np.float64),
                qv.astype(np.float64),
            ], axis=1))
        return out

    @staticmethod
    def _as_frames(pixels, rows: int, cols: int):
        """One frame (flat [rows*cols] or [rows, cols]) -> [1, rows, cols]."""
        if isinstance(pixels, torch.Tensor):
            return pixels.reshape(1, rows, cols)
        return np.asarray(pixels).reshape(1, rows, cols)

    # ---------------------------------------------------------- detection

    def window_scores(self, pixels, rows: int, cols: int, dim: int,
                      min_size: int, max_size: int, shift_factor: float,
                      scale_factor: float, angle: float = 0.0):
        """Scores for every pyramid window, reference scan order.

        Returns (host coords int32 [W, 3] = (row, col, scale),
        scores f32 [W]) with -1 for rejected windows."""
        _check_upright(angle)
        if dim != cols:
            pixels = destride(pixels, rows, cols, dim)
        plan, base, scale = self._plan(rows, cols, min_size, max_size,
                                       shift_factor, scale_factor)
        coords = np.stack([plan.rows_w, plan.cols_w, plan.scale_w], axis=1)
        if plan.num_windows == 0:
            return coords, np.zeros(0, np.float32)
        frames = self._as_frames(pixels, rows, cols)
        staging, _ = self._single.buffers(1, rows, cols, self.HIT_CAPACITY)
        f = self.tensors
        q = face_cuda.face_cascade(
            self._upload(frames, staging), base, scale, f.codes, f.preds,
            f.thresh, f.num_trees)
        return coords, q[0].cpu().numpy()

    def sparse_hits(self, pixels, rows: int, cols: int, *,
                    min_size: int = 20, max_size: int = 1000,
                    shift_factor: float = 0.1, scale_factor: float = 1.1,
                    angle: float = 0.0) -> np.ndarray:
        """One frame through the card: returns [N, 4] (row, col, scale, q)
        with q > 0, reference scan order. Only the packed hit list crosses
        back to the host."""
        _check_upright(angle)
        cfg = dict(min_size=min_size, max_size=max_size,
                   shift_factor=shift_factor, scale_factor=scale_factor)
        return self._collect(self._dispatch(
            self._as_frames(pixels, rows, cols), self._single, cfg))[0]

    def sparse_hits_batch(self, frames, *, min_size: int = 20,
                          max_size: int = 1000, shift_factor: float = 0.1,
                          scale_factor: float = 1.1,
                          angle: float = 0.0) -> list[np.ndarray]:
        """B frames [B, rows, cols] uint8 in one launch over B x W windows
        and one download. Returns per-frame [Ni, 4] hit arrays."""
        _check_upright(angle)
        cfg = dict(min_size=min_size, max_size=max_size,
                   shift_factor=shift_factor, scale_factor=scale_factor)
        if frames.ndim != 3:
            raise ValueError(f"frames must be [B, rows, cols], got "
                             f"{tuple(frames.shape)}")
        return self._collect(self._dispatch(frames, self._batch, cfg))

    def stream_hits(self, frames, *, min_size: int = 20,
                    max_size: int = 1000, shift_factor: float = 0.1,
                    scale_factor: float = 1.1, angle: float = 0.0,
                    depth: int = 8):
        """Streaming pipeline: keeps up to `depth` frames in flight, so
        uploads, kernels and hit-list downloads of later frames overlap the
        host's decode of earlier ones. A ring of `depth` staging slots
        serves the uploads; frame k reuses the slot of frame k - depth,
        which has been collected by then. Yields per-frame [Ni, 4] hit
        arrays in input order."""
        _check_upright(angle)
        cfg = dict(min_size=min_size, max_size=max_size,
                   shift_factor=shift_factor, scale_factor=scale_factor)
        depth = max(1, int(depth))
        ring = [_Slot(self.device) for _ in range(depth)]
        inflight: collections.deque = collections.deque()
        for k, frame in enumerate(frames):
            rows, cols = frame.shape[-2], frame.shape[-1]
            inflight.append(self._dispatch(
                self._as_frames(frame, rows, cols), ring[k % depth], cfg))
            if len(inflight) >= depth:
                yield self._collect(inflight.popleft())[0]
        while inflight:
            yield self._collect(inflight.popleft())[0]

    def run_cascade(self, pixels, rows: int, cols: int,
                    dim: int | None = None, *, min_size: int = 20,
                    max_size: int = 1000, shift_factor: float = 0.1,
                    scale_factor: float = 1.1,
                    angle: float = 0.0) -> np.ndarray:
        """Multi-scale detection pass. Returns [N, 4] (row, col, scale, q>0)
        in the reference's scan order. A row stride `dim` > cols is
        de-strided exactly first."""
        _check_upright(angle)
        if dim is not None and dim != cols:
            pixels = destride(pixels, rows, cols, dim)
        return self.sparse_hits(
            pixels, rows, cols, min_size=min_size, max_size=max_size,
            shift_factor=shift_factor, scale_factor=scale_factor)

    def detect(self, pixels, rows: int, cols: int, dim: int | None = None,
               *, min_size: int = 20, max_size: int = 1000,
               shift_factor: float = 0.1, scale_factor: float = 1.1,
               angle: float = 0.0, iou_threshold: float = 0.2) -> np.ndarray:
        """run_cascade + ClusterDetections in one call -> clusters [M, 4]."""
        dets = self.run_cascade(
            pixels, rows, cols, dim, min_size=min_size, max_size=max_size,
            shift_factor=shift_factor, scale_factor=scale_factor, angle=angle)
        return cluster_detections(dets, iou_threshold)
