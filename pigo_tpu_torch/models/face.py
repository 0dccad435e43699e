"""FaceCascade on PyTorch: the face-detection serving path, upright and
rotated.

Public surface mirrors pigo_tpu.models.face.FaceCascade and the reference
library API (core/pigo.go):
    NewPigo().Unpack(bytes)       -> FaceCascade.from_bytes
    (*Pigo).RunCascade(cp, angle) -> FaceCascade.run_cascade(...)
    (*Pigo).ClusterDetections     -> pigo_tpu_torch.ops.cluster.cluster_detections

Per frame the card does one upload from a pinned host buffer, the cascade
launches over every window of the pyramid (ops/face_cuda.py), an
on-device compaction of the hits into one packed f32 buffer, and one
download into pinned memory followed by an event; nothing in a frame
synchronises the host until its hits are collected. Detections are [N, 4]
float64 (row, col, scale, q) with q > 0, in reference scan order
(scale-major, then row, then col).

The launches per frame (or batch) depend on the mode:
  - default: one `face_cascade` launch over every window;
  - `tree_cap=K`: `face_cascade` stops each window after K trees (rounded
    up to a multiple of 4) and marks the survivors, then `face_finish`
    walks the marked windows through the whole forest;
  - `prefix=True`: the tail scales (fewer than
    face_cuda.TAIL_MIN_WINDOWS windows) go to one `face_prefix` launch for
    the first PREFIX_TREES trees, the other scales to `face_cascade`, then
    `face_finish` finishes the marks.
All write one score vector in scan order, and the finish runs before the
compaction, so no mark reaches a caller. No environment variable changes
any of this.

Host tail (`host_tail=True`, the JAX package's default route when its
engine builds, pigo_tpu/models/face.py:84-94; here opt-in): the sparse
tail scales (face_cuda.route_plan) get no launch and their scores stay -1
on the card; after the card's work of a dispatch is enqueued, the port's
C++ engine (pigo_tpu_torch/native) scans them on the host copy of the
frame, overlapped with the card, and `_collect` merges its hits into
reference scan order with the JAX package's lexsort
(pigo_tpu/models/face.py:721-732). The engine takes the raw angle, as the
JAX package passes it (pigo_tpu/models/face.py:664), so at an angle in
(0, 1/32) its scales read rotated while the card's run upright (ROADMAP.md
queue 3). It excludes `prefix`, combines with `tree_cap`, needs the
cascade's bytes (a cascade built from bytes, a file or the default asset)
and raises NativeUnavailable when the engine cannot be built: it never
carries on all-card. A frame already on the card is downloaded for the
engine (one synchronisation), as the JAX package fetches a device array
(pigo_tpu/models/face.py:762-765).

Rotation: `angle` in (0, 1] turns (a fraction of 2*pi) selects the
reference's rotated reads at angle_idx = int(32 * min(angle, 1)), as the
JAX package's device path does (pigo_tpu/models/face.py:637-638); an angle
whose angle_idx is 0 runs upright there and here.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from pigo_tpu_torch.cascade.assets import asset_path
from pigo_tpu_torch.cascade.format import FaceForest, unpack_face_cascade
from pigo_tpu_torch.convert import face_forest_from_numpy
from pigo_tpu_torch.ops import face_cuda
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.ops.pupil_dense import angle_index
from pigo_tpu_torch.ops.windows import build_window_plan
from pigo_tpu_torch.utils import profiling
from pigo_tpu_torch.utils.device import resolve_device

# Window indices travel as f32 in the packed hit list: exact below 2^24.
MAX_WINDOWS = 1 << 24


def destride(pixels, rows: int, cols: int, dim: int):
    """Flat [rows*dim] buffer with row stride dim -> contiguous
    [rows*cols] (reference ImageParams.Dim, core/pigo.go:29-34). Exact for
    the upright cascade (node offsets |(code*s)>>8| < s/2 against the
    s/2+1 window margin) and for the rotated one when rows <= cols (reads
    clamp columns at nrows-1 <= cols-1): no read reaches column >= cols."""
    if dim < cols:
        raise ValueError(f"dim {dim} < cols {cols}")
    if isinstance(pixels, torch.Tensor):
        return pixels.reshape(rows, dim)[:, :cols].contiguous().reshape(-1)
    return np.ascontiguousarray(
        np.asarray(pixels).reshape(rows, dim)[:, :cols]).reshape(-1)


def keeps_stride(rows: int, cols: int, dim: int, angle_idx: int) -> bool:
    """True when a strided frame must keep its row stride: a rotated
    cascade on a tall frame (rows > cols) clamps columns at nrows-1 >= cols
    and reads the stride's pad bytes there, as the reference does
    (pigo_tpu/models/face.py:867-885). Every other strided frame destrides
    exactly."""
    return dim != cols and angle_idx > 0 and rows > cols


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


def merge_scan_order(card: np.ndarray, tail: np.ndarray) -> np.ndarray:
    """The card's hits and the host tail's, [N, 4] (row, col, scale, q)
    each, in reference scan order (scale-major, then row, then col): the
    JAX package's lexsort (pigo_tpu/models/face.py:721-732). A window's
    coordinates are unique, so the order holds wherever the host scales
    lie in the pyramid."""
    dets = np.concatenate([card, tail])
    return dets[np.lexsort((dets[:, 1], dets[:, 0], dets[:, 2]))]


class _Slot:
    """Host staging for one in-flight dispatch: the frames' upload buffer
    and the packed hit list's download buffer, both pinned on a card. A
    slot is reused only after the dispatch that last used it was
    collected (its event waited on)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.key = None
        self.frames = self.packed = None

    def buffers(self, b: int, rows: int, dim: int, cap: int):
        if self.key != (b, rows, dim, cap):
            pin = self.device.type == "cuda"
            self.frames = torch.empty((b, rows, dim), dtype=torch.uint8,
                                      pin_memory=pin)
            self.packed = torch.empty((b, 1 + 2 * cap), dtype=torch.float32,
                                      pin_memory=pin)
            self.key = (b, rows, dim, cap)
        return self.frames, self.packed


@dataclasses.dataclass
class _Ticket:
    """One dispatched batch: its plan, the frames on the device ([B, rows,
    dim], the post stage of FaceDetector reads them) and their column
    count, the device scores (kept for the dense re-read on overflow), the
    packed host buffer and its event (or, for a dispatch without download,
    the packed device list and the plan's device window coordinates), and
    the host engine's hits of each frame (host tail only)."""

    plan: object
    n_frames: int
    cap: int
    cols: int = 0
    frames: torch.Tensor | None = None
    q: torch.Tensor | None = None
    packed: torch.Tensor | None = None
    event: object = None
    coords: torch.Tensor | None = None
    tail: list[np.ndarray] | None = None


class FaceCascade:
    """Face-detection forest resident on a device, with per-geometry plan
    caching. `device=None` means the CUDA card and raises without one;
    `device="cpu"` runs the plain PyTorch version (tests). `prefix` and
    `tree_cap` (0: off) select the routing, `host_tail` the host engine for
    the tail scales, with `host_threads` for its scan (None: min(cores,
    16); module docstring). `raw` is the cascade's
    bytes, which the host engine parses; the default cascade and the
    from_bytes / from_file constructors keep them."""

    # Fixed capacity of the packed hit list per frame. Real frames yield
    # tens of raw hits; an overflow (count > cap) triggers a dense re-read.
    HIT_CAPACITY = 4096

    def __init__(self, forest: FaceForest | None = None,
                 device: str | torch.device | None = None, *,
                 prefix: bool = False, tree_cap: int = 0,
                 host_tail: bool = False, host_threads: int | None = None,
                 raw: bytes | None = None):
        self.device = resolve_device(device)
        if forest is None:
            with open(asset_path("cascade", "facefinder"), "rb") as fh:
                raw = fh.read()
            forest = unpack_face_cascade(raw)
        self.forest = forest
        self.tensors = face_forest_from_numpy(
            self.forest.depth, self.forest.codes, self.forest.preds,
            self.forest.thresh, self.device)
        self.prefix = bool(prefix)
        self.tree_cap = face_cuda.resolved_cap(tree_cap,
                                               self.forest.num_trees)
        self.host_tail = bool(host_tail)
        self.native = None
        if self.host_tail:
            if self.prefix:
                raise ValueError("host_tail excludes prefix: a tree-prefix "
                                 "plan leaves no scale to the host engine")
            if raw is None:
                raise ValueError("host_tail needs the cascade's bytes: "
                                 "build it from bytes, a file or the "
                                 "default asset, not from a forest")
            from pigo_tpu_torch.native import NativeFaceCascade

            self.native = NativeFaceCascade(raw, threads=host_threads)
        self._plans: dict[tuple, tuple] = {}
        self._single = _Slot(self.device)
        self._batch = _Slot(self.device)

    @classmethod
    def from_bytes(cls, packet: bytes, device=None, **kw) -> "FaceCascade":
        return cls(unpack_face_cascade(packet), device, raw=packet, **kw)

    @classmethod
    def from_file(cls, path: str, device=None, **kw) -> "FaceCascade":
        with open(path, "rb") as fh:
            return cls.from_bytes(fh.read(), device, **kw)

    @classmethod
    def from_forest(cls, forest, device=None, **kw) -> "FaceCascade":
        """Any forest with depth/codes/preds/thresh arrays, e.g. the JAX
        package's (read duck-typed, see convert.py). It has no bytes, so
        host_tail=True raises ValueError."""
        return cls(FaceForest(
            depth=int(forest.depth), codes=np.asarray(forest.codes),
            preds=np.asarray(forest.preds), thresh=np.asarray(forest.thresh),
        ), device, **kw)

    # ------------------------------------------------------------ plan

    def _plan(self, *geometry, angle_idx=0):
        """(routed plan, device base, device scale) of `_plan_entry`."""
        return self._plan_entry(*geometry, angle_idx=angle_idx)[:3]

    def _plan_key(self, rows, cols, min_size, max_size, shift_factor,
                  scale_factor, angle_idx=0) -> tuple:
        """The plan cache's key: geometry, angle and routing."""
        return (rows, cols, min_size, max_size, shift_factor, scale_factor,
                angle_idx, self.prefix, self.tree_cap, self.host_tail)

    def _plan_entry(self, rows, cols, min_size, max_size, shift_factor,
                    scale_factor, angle_idx=0):
        """(routed plan, device base, device scale, device coords), built
        and uploaded once per geometry, angle and routing. coords is f32
        [W, 3], every window's (row, col, scale), from which the device
        detector decodes the packed hit list on the card."""
        key = self._plan_key(rows, cols, min_size, max_size, shift_factor,
                             scale_factor, angle_idx)
        hit = self._plans.get(key)
        if hit is None:
            plan = build_window_plan(rows, cols, min_size, max_size,
                                     shift_factor, scale_factor)
            if plan.num_windows >= MAX_WINDOWS:
                raise ValueError(f"{plan.num_windows} windows: the packed "
                                 f"hit list holds indices below {MAX_WINDOWS}")
            routed = face_cuda.route_plan(
                plan, self.forest.num_trees, prefix=self.prefix,
                tree_cap=self.tree_cap, host_tail=self.host_tail)
            coords = np.stack([plan.rows_w, plan.cols_w, plan.scale_w],
                              axis=1).astype(np.float32)
            hit = (routed, *face_cuda.device_plan(plan, self.device),
                   face_cuda.upload(coords, self.device))
            self._plans[key] = hit
        return hit

    def _scores(self, frames, routed, base, scale, angle_idx, cols):
        """Every card window's exact score f32 [B, W] in scan order: -1
        over the host scales, then the routed plan's launches (dense, then
        prefix) write their column ranges, then the finish overwrites
        every mark."""
        f = self.tensors
        forest = (f.codes, f.preds, f.thresh)
        kw = dict(angle_idx=angle_idx, cols=cols)
        q = torch.empty((frames.shape[0], routed.windows.num_windows),
                        dtype=torch.float32, device=frames.device)
        for lo, hi in routed.host_ranges:
            q[:, lo:hi] = -1.0
        for seg in routed.segments:
            kernel = (face_cuda.face_prefix if seg.prefix
                      else face_cuda.face_cascade)
            kernel(frames, base[seg.lo:seg.hi], scale[seg.lo:seg.hi],
                   *forest, seg.t_limit, out=q[:, seg.lo:seg.hi], **kw)
        if routed.finish is not None:
            lo, hi = routed.finish
            face_cuda.face_finish(frames, base[lo:hi], scale[lo:hi], *forest,
                                  q[:, lo:hi], **kw)
        return q

    def _card_stage(self, frames, routed, base, scale, angle_idx, cols):
        """The face stage's card work on frames already on the card: (the
        scores f32 [B, W], the packed hit list f32 [B, 1 + 2*cap]). A
        dispatch runs it, or a CUDA graph captures it (`_dispatch`'s
        `graph`): the same ops either way."""
        q = self._scores(frames, routed, base, scale, angle_idx, cols)
        return q, compact_hits(q, self.HIT_CAPACITY)

    # ------------------------------------------------- dispatch / collect

    def _upload(self, frames, staging: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """uint8 [B, rows, dim] frames on the device, copied into `out`
        (a device buffer of that shape) when given. Host frames go
        through the (pinned) staging buffer with a non-blocking copy."""
        if isinstance(frames, torch.Tensor):
            if frames.device == self.device:
                frames = frames.to(torch.uint8)
                return frames.contiguous() if out is None else \
                    out.copy_(frames)
            frames = frames.cpu().numpy()
        if self.device.type == "cpu":
            host = torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
            return host if out is None else out.copy_(host)
        staging.numpy()[...] = frames
        if out is None:
            return staging.to(self.device, non_blocking=True)
        return out.copy_(staging, non_blocking=True)

    @staticmethod
    def _host_frames(frames) -> np.ndarray:
        """uint8 [B, rows, dim] frames on the host, for the host engine: a
        tensor on the card is downloaded (a synchronisation)."""
        if isinstance(frames, torch.Tensor):
            frames = frames.cpu().numpy()
        return np.asarray(frames, np.uint8)

    def _tail(self, host_frames, routed, cfg, angle, cols):
        """The host engine's hits [Ni, 4] of each frame over the plan's
        host scales, in scan order (None without host scales)."""
        scales = routed.host_scales
        if not scales.size:
            return None
        _, rows, dim = host_frames.shape
        with profiling.span("face.tail"):
            return [self.native.run_scales(
                fr, rows, cols, scales, dim=dim,
                shift_factor=cfg["shift_factor"], angle=angle)
                for fr in host_frames]

    def _dispatch(self, frames, slot: _Slot, cfg: dict, angle: float = 0.0,
                  cols: int | None = None, download: bool = True,
                  host_frames=None, graph=None) -> _Ticket:
        """Async half: the upload, the cascade launches for all frames and
        scales, the hit compaction and the download of the packed hit lists
        are all enqueued without waiting for the device; then the host
        engine scans the host scales (host tail), overlapped with the card,
        on `host_frames` (default: `frames`, downloaded if on the card).
        frames are [B, rows, dim] with `cols` <= dim real columns (default
        dim), at `angle` in turns. With download=False the dispatch stops
        at `compact_hits`: the ticket's `packed` is the device's f32
        [B, 1 + 2*cap] list, with the plan's device `coords` beside it,
        and nothing is waited for or copied back
        (FaceDetector.detect_stream_device). `graph`, given (that stream
        on a card), is the key's CUDA graph of `_card_stage`: the upload
        fills its static frame buffer `graph.frames` and `graph.run(fn)`
        replays fn's graph (captured at its first run), which gives fn's
        outputs as captured."""
        with profiling.span("face.dispatch"):
            b, rows, dim = frames.shape
            cols = dim if cols is None else cols
            routed, base, scale, coords = self._plan_entry(
                rows, cols, **cfg, angle_idx=angle_index(angle))
            cap = self.HIT_CAPACITY
            ticket = _Ticket(plan=routed.windows, n_frames=b, cap=cap,
                             cols=cols)
            if routed.windows.num_windows == 0:  # smaller than min face
                return ticket
            staging, packed_host = slot.buffers(b, rows, dim, cap)
            ticket.frames = self._upload(
                frames, staging, None if graph is None else graph.frames)
            card = functools.partial(self._card_stage, ticket.frames, routed,
                                     base, scale, angle_index(angle), cols)
            ticket.q, packed = card() if graph is None else graph.run(card)
            if not download:
                ticket.packed, ticket.coords = packed, coords
            else:
                packed_host.copy_(packed, non_blocking=True)
                ticket.packed = packed_host
                if self.device.type == "cuda":
                    ticket.event = torch.cuda.Event()
                    ticket.event.record(
                        torch.cuda.current_stream(self.device))
            if self.host_tail:
                ticket.tail = self._tail(self._host_frames(
                    frames if host_frames is None else host_frames),
                    routed, cfg, angle, cols)
            return ticket

    def _collect(self, ticket: _Ticket) -> list[np.ndarray]:
        """Blocking half: wait for the packed hit lists, decode per frame
        and merge each frame's host tail hits into scan order."""
        if ticket.q is None:
            return [np.zeros((0, 4), np.float64)
                    for _ in range(ticket.n_frames)]
        with profiling.span("face.collect") as sp:
            with profiling.span("face.wait"):
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
                dets = np.stack([
                    plan.rows_w[idx].astype(np.float64),
                    plan.cols_w[idx].astype(np.float64),
                    plan.scale_w[idx].astype(np.float64),
                    qv.astype(np.float64),
                ], axis=1)
                if ticket.tail is not None and ticket.tail[i].shape[0]:
                    dets = merge_scan_order(dets, ticket.tail[i])
                out.append(dets)
            if sp is not None:
                sp.items = sum(len(d) for d in out)
        return out

    @staticmethod
    def _as_frames(pixels, rows: int, dim: int):
        """One frame (flat [rows*dim] or [rows, dim]) -> [1, rows, dim]."""
        if isinstance(pixels, torch.Tensor):
            return pixels.reshape(1, rows, dim)
        return np.asarray(pixels).reshape(1, rows, dim)

    @staticmethod
    def _layout(pixels, rows, cols, dim, angle_idx):
        """(pixels, dim) to run: destrided exactly unless the stride must
        stay (keeps_stride)."""
        if dim is None or dim == cols:
            return pixels, cols
        if dim < cols:
            raise ValueError(f"dim {dim} < cols {cols}")
        if keeps_stride(rows, cols, dim, angle_idx):
            return pixels, dim
        return destride(pixels, rows, cols, dim), cols

    @staticmethod
    def _cfg(min_size, max_size, shift_factor, scale_factor) -> dict:
        return dict(min_size=min_size, max_size=max_size,
                    shift_factor=shift_factor, scale_factor=scale_factor)

    # ---------------------------------------------------------- detection

    def window_scores(self, pixels, rows: int, cols: int, dim: int,
                      min_size: int, max_size: int, shift_factor: float,
                      scale_factor: float, angle: float = 0.0):
        """Scores for every pyramid window, reference scan order.

        Returns (host coords int32 [W, 3] = (row, col, scale),
        scores f32 [W]) with -1 for rejected windows; marked windows are
        finished first, so no score is PREFIX_MARK. With the host tail the
        engine scores the host scales' windows (`classify_batch`, at the
        raw angle, as its scan reads them), so the positive scores are the
        hits of `run_cascade`."""
        a = angle_index(angle)
        pixels, dim = self._layout(pixels, rows, cols, dim, a)
        routed, base, scale = self._plan(
            rows, cols, min_size, max_size, shift_factor, scale_factor,
            angle_idx=a)
        plan = routed.windows
        coords = np.stack([plan.rows_w, plan.cols_w, plan.scale_w], axis=1)
        if plan.num_windows == 0:
            return coords, np.zeros(0, np.float32)
        staging, _ = self._single.buffers(1, rows, dim, self.HIT_CAPACITY)
        host = self._as_frames(pixels, rows, dim)
        frames = self._upload(host, staging)
        q = self._scores(frames, routed, base, scale, a, cols)[0]
        q = q.cpu().numpy()
        if routed.host_ranges:
            pix = self._host_frames(host)[0]
            for lo, hi in routed.host_ranges:
                q[lo:hi] = self.native.classify_batch(pix, rows, dim,
                                                      coords[lo:hi], angle)
        return coords, q

    def sparse_hits(self, pixels, rows: int, cols: int, *,
                    min_size: int = 20, max_size: int = 1000,
                    shift_factor: float = 0.1, scale_factor: float = 1.1,
                    angle: float = 0.0) -> np.ndarray:
        """One contiguous frame through the card: returns [N, 4]
        (row, col, scale, q) with q > 0, reference scan order. Only the
        packed hit list crosses back to the host."""
        cfg = self._cfg(min_size, max_size, shift_factor, scale_factor)
        return self._collect(self._dispatch(
            self._as_frames(pixels, rows, cols), self._single, cfg,
            angle))[0]

    def sparse_hits_batch(self, frames, *, min_size: int = 20,
                          max_size: int = 1000, shift_factor: float = 0.1,
                          scale_factor: float = 1.1,
                          angle: float = 0.0) -> list[np.ndarray]:
        """B frames [B, rows, cols] uint8 in one set of launches over
        B x W windows and one download. Returns per-frame [Ni, 4] hit
        arrays."""
        cfg = self._cfg(min_size, max_size, shift_factor, scale_factor)
        if frames.ndim != 3:
            raise ValueError(f"frames must be [B, rows, cols], got "
                             f"{tuple(frames.shape)}")
        return self._collect(self._dispatch(frames, self._batch, cfg,
                                            angle))

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
        cfg = self._cfg(min_size, max_size, shift_factor, scale_factor)
        depth = max(1, int(depth))
        ring = [_Slot(self.device) for _ in range(depth)]
        inflight: collections.deque = collections.deque()
        for k, frame in enumerate(frames):
            rows, cols = frame.shape[-2], frame.shape[-1]
            inflight.append(self._dispatch(
                self._as_frames(frame, rows, cols), ring[k % depth], cfg,
                angle))
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
        de-strided exactly first, except for a rotated pass on a tall frame,
        which reads through the stride (keeps_stride)."""
        pixels, dim = self._layout(pixels, rows, cols, dim,
                                   angle_index(angle))
        cfg = self._cfg(min_size, max_size, shift_factor, scale_factor)
        return self._collect(self._dispatch(
            self._as_frames(pixels, rows, dim), self._single, cfg, angle,
            cols))[0]

    def run_cascade_sweep(self, pixels, rows: int, cols: int, angles, *,
                          min_size: int = 20, max_size: int = 1000,
                          shift_factor: float = 0.1,
                          scale_factor: float = 1.1) -> np.ndarray:
        """In-plane rotated detection sweep: the full pyramid at every
        angle, concatenated as [N, 5] rows (row, col, scale, q, angle). The
        frame is uploaded once and every angle's launches are enqueued
        before the first collect (with the host tail, each angle's host
        scan runs after its launches). Cluster the result with a small IoU
        threshold to merge the same face found at neighbouring angles."""
        cfg = self._cfg(min_size, max_size, shift_factor, scale_factor)
        angles = [max(float(a), 0.0) for a in angles]
        if not angles:
            return np.zeros((0, 5), np.float64)
        host = self._as_frames(pixels, rows, cols)
        if self.host_tail:
            host = self._host_frames(host)
        staging, _ = self._single.buffers(1, rows, cols, self.HIT_CAPACITY)
        frames = self._upload(host, staging)
        tickets = [self._dispatch(frames, _Slot(self.device), cfg, a,
                                  host_frames=host) for a in angles]
        parts = []
        for a, ticket in zip(angles, tickets):
            dets = self._collect(ticket)[0]
            parts.append(np.concatenate(
                [dets, np.full((dets.shape[0], 1), a)], axis=1))
        return np.concatenate(parts)

    def detect_sweep(self, pixels, rows: int, cols: int, angles, *,
                     iou_threshold: float = 0.01, **kw) -> np.ndarray:
        """Angle sweep + cross-angle IoU clustering -> clusters [M, 4]."""
        dets = self.run_cascade_sweep(pixels, rows, cols, angles, **kw)
        return cluster_detections(dets[:, :4], iou_threshold)

    def detect(self, pixels, rows: int, cols: int, dim: int | None = None,
               *, min_size: int = 20, max_size: int = 1000,
               shift_factor: float = 0.1, scale_factor: float = 1.1,
               angle: float = 0.0, iou_threshold: float = 0.2) -> np.ndarray:
        """run_cascade + ClusterDetections in one call -> clusters [M, 4]."""
        dets = self.run_cascade(
            pixels, rows, cols, dim, min_size=min_size, max_size=max_size,
            shift_factor=shift_factor, scale_factor=scale_factor, angle=angle)
        return cluster_detections(dets, iou_threshold)
