"""Multi-GPU detection over torch.distributed, on the port's kernels.

The port of pigo_tpu/parallel/sharded.py: the same kernels as
FaceCascade.sparse_hits (ops/face_cuda.py) on every rank of a mesh
(parallel/mesh.py, one process per card), the cascade replicated. Two
strategies:

1. **Window sharding** (`window_sharded_hits`): one frame's windows split
   over the ranks. The JAX package hands its TPU kernel a band of row
   tiles of every dense scale through the tile offset `meta[3]`
   (sharded.py:90-101). The port's kernels read a window list in scan
   order, scale-major then row-major (ops/windows.py), so a contiguous cut
   of one scale's range is a row band: rank r of n takes the r-th of n
   contiguous cuts of every routed segment (`band_cut`). It launches each
   segment's kernel on its cut into one score vector of its band,
   finishes the marks inside its own cuts (the finish range spans
   segments, and a rank can finish only marks its own launches wrote),
   and compacts its hits into a packed list of global window indices
   (`compact_hits`, then the band's index table). The packed lists are
   all-gathered, [n, 1 + 2*cap]. Each list's exact count rides in its
   first slot, so the total and the overflow test come from the gathered
   lists with no second collective (the JAX package psums both,
   sharded.py:119-124). The merge keeps the valid indices, sorts them
   stably by global index (scan order) and decodes them through the plan
   (sharded.py:166-202). If any rank's list overflowed (count > cap),
   every rank re-reads the whole frame exactly on its own card
   (FaceCascade._scores), where the JAX package re-reads it on the host
   (sharded.py:171-176).

2. **Frame data parallelism** (`batch_hits`, sharded.py:210-293): rank r
   dispatches frames [r*B/n, (r+1)*B/n) in one call without download
   (FaceCascade._dispatch(download=False)). The packed lists are
   all-gathered, and every rank decodes every frame with
   FaceCascade._collect, including the dense re-read of a frame whose
   count overflowed, on its own card from its host copy of that frame.

Routing: window sharding routes with the face's `prefix` and `host_tail`
at tree cap 0, as the JAX package's `_window_fn` forces
(sharded.py:69-72), so one kernel A launch covers a rank's dense cuts;
frame data parallelism routes as the face does. With the host tail every
rank scans the host scales of every frame with the engine and merges in
scan order, as every JAX process runs `_fallback_hits`. Results equal
FaceCascade.sparse_hits bit for bit (row, col, scale, f32 q).

Collectives are `dist.all_gather` into a list, which every torch the port
runs on has. Over NCCL the lists stay on the card; over gloo, which runs
its collectives on host tensors, they go through host copies. A mesh
without a group (make_mesh(1) with no process group) runs no collective.
Nothing falls back: a failed build or launch raises on the rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from pigo_tpu_torch.models.face import (
    MAX_WINDOWS, FaceCascade, _Slot, _Ticket, angle_index, compact_hits,
    merge_scan_order)
from pigo_tpu_torch.ops import face_cuda
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.ops.face_cuda import RoutedPlan, Segment
from pigo_tpu_torch.ops.windows import build_window_plan
from pigo_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class Band:
    """One rank's share of a routed plan. Its windows are laid out as its
    cuts in scan order; `segments` are the launches over those positions
    (each a cut of a routed segment, with its kernel and tree limit),
    `finish` the positions [lo, hi) of the cuts inside the plan's finish
    range (None without one), and `index` int64 [W_band] the global window
    index of each position."""

    segments: tuple[Segment, ...]
    finish: tuple[int, int] | None
    index: np.ndarray


def band_cut(routed: RoutedPlan, rank: int, n: int) -> Band:
    """Rank `rank` of `n`'s band: the rank-th of n contiguous cuts of every
    routed segment (a cut of segment [lo, hi) is [lo + (hi-lo)*r//n,
    lo + (hi-lo)*(r+1)//n)). The finish range's ends are segment ends, so
    each cut lies wholly inside it or outside, and the cuts inside it are
    consecutive in scan order: one finish range per band."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside a mesh of {n}")
    segments, parts, pos = [], [], 0
    finish = None
    for seg in sorted(routed.segments, key=lambda s: s.lo):
        size = seg.hi - seg.lo
        lo = seg.lo + size * rank // n
        hi = seg.lo + size * (rank + 1) // n
        if hi == lo:
            continue
        segments.append(Segment(pos, pos + hi - lo, seg.prefix, seg.t_limit))
        if routed.finish is not None and \
                routed.finish[0] <= lo and hi <= routed.finish[1]:
            finish = (pos if finish is None else finish[0], pos + hi - lo)
        parts.append(np.arange(lo, hi, dtype=np.int64))
        pos += hi - lo
    index = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return Band(tuple(segments), finish, index)


def merge_lists(lists: np.ndarray, cap: int):
    """The gathered packed lists f32 [n, 1 + 2*cap] (count, global index,
    score) -> (index int64 [N], score f32 [N]) in scan order, or None when
    a list overflowed (count > cap)."""
    if (lists[:, 0] > cap).any():
        return None
    idx = lists[:, 1:1 + cap].reshape(-1)
    qv = lists[:, 1 + cap:].reshape(-1)
    keep = idx >= 0
    idx, qv = idx[keep].astype(np.int64), qv[keep]
    order = np.argsort(idx, kind="stable")
    return idx[order], qv[order]


class _Rescore:
    """Frame i's exact scores on demand (`self[i]`, f32 [W]): the dense
    re-read of a frame whose packed list overflowed, on this rank's card
    from its host copy of the frame. It stands in for a ticket's device
    scores in FaceCascade._collect, which reads `ticket.q[i]` only for an
    overflowed frame."""

    def __init__(self, face: FaceCascade, host: np.ndarray, cfg: dict,
                 angle: float):
        self.face, self.host, self.cfg, self.angle = face, host, cfg, angle

    def __getitem__(self, i: int) -> torch.Tensor:
        fc = self.face
        _, rows, cols = self.host.shape
        a = angle_index(self.angle)
        routed, base, scale = fc._plan_entry(rows, cols, **self.cfg,
                                              angle_idx=a)[:3]
        frame = face_cuda.upload(self.host[i:i + 1], fc.device)
        return fc._scores(frame, routed, base, scale, a, cols)[0]


class ShardedFaceCascade:
    """FaceCascade scaled over a mesh of ranks (module docstring). `face`
    (default: FaceCascade on the mesh's device) must live on the mesh's
    device; `hit_capacity` is the packed list's length per rank in window
    sharding. Every rank of the mesh calls each method with the same
    arguments."""

    def __init__(self, mesh: Mesh, face: FaceCascade | None = None,
                 hit_capacity: int = 1024):
        if mesh.rank < 0:
            raise ValueError("this process is outside the mesh")
        self.mesh = mesh
        self.n = mesh.size
        self.face = (face if face is not None
                     else FaceCascade(device=mesh.device))
        if self.face.device != mesh.device:
            raise ValueError(f"face on {self.face.device}, mesh on "
                             f"{mesh.device}")
        self.cap = int(hit_capacity)
        self._plans: dict[tuple, tuple] = {}
        self._bands: dict[tuple, tuple] = {}
        self._slot = _Slot(mesh.device)
        self._batch_slot = _Slot(mesh.device)

    # ------------------------------------------------------ collectives

    def _all_gather(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's `t` (same shape on each), stacked [n, ...] on the
        host in rank order."""
        m = self.mesh
        if m.group is None:
            return t.cpu().numpy()[None]
        src = t if m.backend == "nccl" else t.cpu()
        parts = [torch.empty_like(src) for _ in range(m.size)]
        dist.all_gather(parts, src, group=m.group)
        return torch.stack(parts).cpu().numpy()

    # ---------------------------------------------------- window sharding

    def _window_plan(self, rows, cols, cfg):
        """(routed plan, device base, device scale) at tree cap 0, built
        and uploaded once per geometry."""
        key = (rows, cols, *cfg.values())
        hit = self._plans.get(key)
        if hit is None:
            fc = self.face
            plan = build_window_plan(rows, cols, **cfg)
            if plan.num_windows >= MAX_WINDOWS:
                raise ValueError(f"{plan.num_windows} windows: the packed "
                                 f"hit list holds indices below {MAX_WINDOWS}")
            routed = face_cuda.route_plan(
                plan, fc.forest.num_trees, prefix=fc.prefix, tree_cap=0,
                host_tail=fc.host_tail)
            hit = (routed, *face_cuda.device_plan(plan, fc.device))
            self._plans[key] = hit
        return hit

    def _band(self, key, routed, rank, n):
        """(Band, device base, device scale, device f32 global index) of
        rank `rank` of `n`, built and uploaded once per geometry."""
        hit = self._bands.get((key, rank, n))
        if hit is None:
            band = band_cut(routed, rank, n)
            plan, dev = routed.windows, self.face.device
            hit = (band,
                   face_cuda.upload(plan.base[band.index].astype(np.int32),
                                    dev),
                   face_cuda.upload(plan.scale_w[band.index]
                                    .astype(np.int32), dev),
                   face_cuda.upload(band.index.astype(np.float32), dev))
            self._bands[(key, rank, n)] = hit
        return hit

    def _band_list(self, frames, key, routed, rank, n, angle_idx, cols):
        """Rank `rank` of `n`'s packed hit list f32 [1 + 2*cap] on the
        device: its band's launches, the finish of its marks, the
        compaction, and each local index turned into the global one."""
        band, base, scale, index = self._band(key, routed, rank, n)
        cap, dev = self.cap, frames.device
        if band.index.size == 0:
            out = torch.zeros(1 + 2 * cap, dtype=torch.float32, device=dev)
            out[1:1 + cap] = -1.0
            return out
        f = self.face.tensors
        forest = (f.codes, f.preds, f.thresh)
        kw = dict(angle_idx=angle_idx, cols=cols)
        q = torch.empty((1, band.index.size), dtype=torch.float32,
                        device=dev)
        for seg in band.segments:
            kernel = (face_cuda.face_prefix if seg.prefix
                      else face_cuda.face_cascade)
            kernel(frames, base[seg.lo:seg.hi], scale[seg.lo:seg.hi],
                   *forest, seg.t_limit, out=q[:, seg.lo:seg.hi], **kw)
        if band.finish is not None:
            lo, hi = band.finish
            face_cuda.face_finish(frames, base[lo:hi], scale[lo:hi], *forest,
                                  q[:, lo:hi], **kw)
        packed = compact_hits(q, cap)[0]
        local = packed[1:1 + cap].to(torch.int64)
        glob = torch.where(local >= 0, index[local.clamp(min=0)], -1.0)
        return torch.cat([packed[:1], glob, packed[1 + cap:]])

    def _window_hits(self, pixels, rows, cols, cfg, angle, bands):
        """window_sharded_hits, or with `bands` = n every band of an n-rank
        mesh run in this process and stacked in place of the gather."""
        fc = self.face
        routed, base, scale = self._window_plan(rows, cols, cfg)
        plan = routed.windows
        if plan.num_windows == 0:  # frame smaller than the min face
            return np.zeros((0, 4), np.float64)
        a = angle_index(angle)
        host = fc._as_frames(pixels, rows, cols)
        staging, _ = self._slot.buffers(1, rows, cols, self.cap)
        frames = fc._upload(host, staging)
        key = (rows, cols, *cfg.values())
        if bands is None:
            lists = self._all_gather(self._band_list(
                frames, key, routed, self.mesh.rank, self.n, a, cols))
        else:
            lists = torch.stack([
                self._band_list(frames, key, routed, r, bands, a, cols)
                for r in range(bands)]).cpu().numpy()
        merged = merge_lists(lists, self.cap)
        if merged is None:  # a rank's list overflowed: exact dense re-read
            q = fc._scores(frames, routed, base, scale, a, cols)[0]
            q = q.cpu().numpy()
            idx = np.nonzero(q > 0.0)[0]
            qv = q[idx]
        else:
            idx, qv = merged
        dets = np.stack([
            plan.rows_w[idx].astype(np.float64),
            plan.cols_w[idx].astype(np.float64),
            plan.scale_w[idx].astype(np.float64),
            qv.astype(np.float64),
        ], axis=1)
        tail = fc._tail(fc._host_frames(host), routed, cfg, angle, cols) \
            if fc.host_tail else None
        if tail is not None and tail[0].shape[0]:
            dets = merge_scan_order(dets, tail[0])
        return dets

    def window_sharded_hits(self, pixels, rows: int, cols: int, *,
                            min_size: int = 20, max_size: int = 1000,
                            shift_factor: float = 0.1,
                            scale_factor: float = 1.1,
                            angle: float = 0.0) -> np.ndarray:
        """Detections [N, 4] (row, col, scale, q) of one contiguous frame,
        reference scan order, from this rank's band and the mesh's
        all-gather; equal to FaceCascade.sparse_hits bit for bit."""
        cfg = FaceCascade._cfg(min_size, max_size, shift_factor,
                               scale_factor)
        return self._window_hits(pixels, rows, cols, cfg, angle, None)

    def window_bands_hits(self, pixels, rows: int, cols: int, n: int, *,
                          min_size: int = 20, max_size: int = 1000,
                          shift_factor: float = 0.1,
                          scale_factor: float = 1.1,
                          angle: float = 0.0) -> np.ndarray:
        """window_sharded_hits of an n-rank mesh with every rank's band run
        in this process, one after another, and the merge fed by their
        stacked lists instead of a collective (the tests; chip_smoke.py)."""
        cfg = FaceCascade._cfg(min_size, max_size, shift_factor,
                               scale_factor)
        return self._window_hits(pixels, rows, cols, cfg, angle, int(n))

    def detect(self, pixels, rows: int, cols: int, *,
               iou_threshold: float = 0.2, **kw) -> np.ndarray:
        """window_sharded_hits + ClusterDetections -> clusters [M, 4]."""
        dets = self.window_sharded_hits(pixels, rows, cols, **kw)
        return cluster_detections(dets, iou_threshold)

    # ------------------------------------------------ frame data parallel

    def batch_hits(self, frames, rows: int, cols: int, *,
                   min_size: int = 20, max_size: int = 1000,
                   shift_factor: float = 0.1, scale_factor: float = 1.1,
                   angle: float = 0.0) -> tuple[list[np.ndarray], int]:
        """Frame data parallelism: B frames uint8 [B, rows, cols] split over
        the mesh, this rank's share dispatched in one call. Returns
        (per-frame [Ni, 4] hit lists equal to sparse_hits, the sum of every
        frame's raw hit count over the mesh). B must be a multiple of the
        mesh size."""
        fc = self.face
        host = fc._host_frames(frames).reshape(-1, rows, cols)
        b = host.shape[0]
        if b % self.n:
            raise ValueError(f"batch {b} not divisible by mesh size {self.n}")
        per = b // self.n
        lo, hi = self.mesh.rank * per, (self.mesh.rank + 1) * per
        cfg = FaceCascade._cfg(min_size, max_size, shift_factor,
                               scale_factor)
        ticket = fc._dispatch(host[lo:hi], self._batch_slot, cfg, angle,
                              download=False)
        if ticket.q is None:  # frame smaller than the min face
            return [np.zeros((0, 4), np.float64) for _ in range(b)], 0
        lists = self._all_gather(ticket.packed).reshape(b, -1)
        tails = None
        if ticket.tail is not None:
            routed = fc._plan_entry(rows, cols, **cfg,
                                    angle_idx=angle_index(angle))[0]
            tails = (fc._tail(host[:lo], routed, cfg, angle, cols)
                     + ticket.tail
                     + fc._tail(host[hi:], routed, cfg, angle, cols))
        dets = fc._collect(_Ticket(
            plan=ticket.plan, n_frames=b, cap=ticket.cap,
            q=_Rescore(fc, host, cfg, angle),
            packed=torch.from_numpy(lists), tail=tails))
        return dets, int(lists[:, 0].astype(np.int64).sum())
