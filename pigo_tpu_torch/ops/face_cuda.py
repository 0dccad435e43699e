"""The soft-cascade kernels on the card: routing and wrappers.

Three kernels, each with its plain version in ops/face_dense.py, all in
one library (csrc/face_cascade.cu and csrc/face_prefix.cu, built together):
  - `face_cascade` (csrc/face_cascade.cu) is the port of
    pigo_tpu/ops/face_pallas.py::_kernel_body: the first `t_limit` trees
    over a range of windows, -1 / PREFIX_MARK / final score;
  - `face_prefix` (csrc/face_prefix.cu) is the port of
    face_pallas.py::_multi_kernel_body: the first PREFIX_TREES trees over
    the tail scales' windows, on face_cascade's two-phase schedule with
    the trees staged (swizzled) in shared memory, -1 / PREFIX_MARK;
  - `face_finish` (csrc/face_cascade.cu) finishes every PREFIX_MARK
    window exactly, in place, where the JAX package finishes them on the
    host (`_resolve_marked`) or with its opt-in device resolver
    (`_resolve_consts`, pigo_tpu/models/face.py:313-449).
Each reads the frame upright or rotated (`angle_idx` > 0).

Routing (`route_plan`, the counterpart of build_dense_plan's per-scale
routing, face_pallas.py:405-431 and :483-488): in tree-prefix mode a scale
with fewer than TAIL_MIN_WINDOWS windows is a prefix scale; every other
scale is dense, at the tree cap when one is set. With `host_tail=True` the
JAX package's host tail rule picks host scales instead: every scale below
TAIL_MIN_WINDOWS windows, then the smallest remaining scales, sorted by
(windows, scale), while the host's share of the plan's windows stays at or
below HOST_SHARE_TARGET (promotion stops at the first scale that would
overshoot). A host scale gets no launch; the face stage scans it with the
host engine (models/face.py) and its windows' scores stay -1 on the card.
The host tail excludes tree-prefix mode (in the JAX package a prefix plan
leaves no scale to the host: PREFIX_MIN_WINDOWS = 0) and combines with the
tree cap. The JAX package's VMEM budgets and decimation search are TPU
layout and have no counterpart. Nor has `prefix_groups`
(face_pallas.py:982), which splits the prefix scales into groups under
VMEM and SMEM budgets: here all prefix windows of a frame batch go to one
`face_prefix` launch. One score vector in scan order takes every kernel's
output in place, whichever scales each kernel reads.

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches its kernel through build.launch, which counts it under the
wrapper's name, or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pigo_tpu_torch.ops import face_dense
from pigo_tpu_torch.ops.pupil_dense import QCOS_TABLE, QSIN_TABLE
from pigo_tpu_torch.ops.windows import WindowPlan
from pigo_tpu_torch.utils import build

# Routing constants (pigo_tpu/ops/face_pallas.py:83, :107, :113-154). Plans
# are cached per FaceCascade, so a changed value takes effect on new
# instances. TAIL_MIN_WINDOWS and HOST_SHARE_TARGET are the JAX package's
# values, tuned on a TPU v5e against its host engine; no H100 measurement
# chose them (there is no benchmark cell to choose them from yet).
TAIL_MIN_WINDOWS = 6144  # scales below this many windows are tail scales
HOST_SHARE_TARGET = 0.3  # host tail: the most of a plan's windows it scans
PREFIX_TREES = 32  # trees a prefix scale is evaluated for before the finish

# Dynamic shared memory `face_prefix` asks for per block: the staged
# tables, t_limit * (8 * leaves + 4) bytes, must fit (16,512 B for 32
# facefinder trees). 48 KB is what a block gets without opting in.
PREFIX_SMEM_BYTES = 48 * 1024


def resolved_cap(tree_cap: int, n_trees: int) -> int:
    """The dense tree cap in effect (FaceCascade._resolved_cap,
    pigo_tpu/models/face.py:177-188): rounded up to a multiple of 4, and 0
    when it is 0 or would not trim the forest."""
    cap = -(-int(tree_cap) // 4) * 4 if tree_cap > 0 else 0
    return 0 if cap >= n_trees else cap


@dataclasses.dataclass(frozen=True)
class Segment:
    """One kernel launch: windows [lo, hi) of the scan order."""

    lo: int
    hi: int
    prefix: bool  # face_prefix (True) or face_cascade
    t_limit: int


@dataclasses.dataclass(frozen=True)
class RoutedPlan:
    """A window plan with its per-scale routes (host numpy).

    prefix / t_limits / host: bool / int / bool [S] per scale of
    windows.scales; segments: the launches, dense ones first, then the one
    prefix launch; finish: the window range [lo, hi) holding every window
    that can be marked (None when no scale is capped or prefix);
    host_ranges: the window ranges [lo, hi) of runs of host scales, whose
    scores the card sets to -1."""

    windows: WindowPlan
    prefix: np.ndarray
    t_limits: np.ndarray
    segments: tuple[Segment, ...]
    finish: tuple[int, int] | None
    host: np.ndarray
    host_ranges: tuple[tuple[int, int], ...]

    @property
    def host_scales(self) -> np.ndarray:
        """int32 [H]: the scales the host engine scans, ascending."""
        return self.windows.scales[self.host]


def host_tail_scales(counts: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """bool [S]: the host scales of the JAX package's host tail rule
    (module docstring; face_pallas.py:405-431) for per-scale window counts
    `counts` of pyramid scales `scales`."""
    host = counts < TAIL_MIN_WINDOWS
    total = int(counts.sum())
    if total == 0:
        return host
    cum = int(counts[host].sum())
    for k in sorted(np.flatnonzero(~host),
                    key=lambda k: (int(counts[k]), int(scales[k]))):
        if (cum + int(counts[k])) / total > HOST_SHARE_TARGET:
            break
        host[k] = True
        cum += int(counts[k])
    return host


def route_plan(plan: WindowPlan, n_trees: int, *, prefix: bool,
               tree_cap: int = 0, host_tail: bool = False) -> RoutedPlan:
    """Route each scale of `plan` (module docstring). Raises ValueError for
    host_tail with prefix."""
    if host_tail and prefix:
        raise ValueError("host_tail excludes prefix: a tree-prefix plan "
                         "leaves no scale to the host engine")
    cap = resolved_cap(tree_cap, n_trees)
    counts = np.bincount(plan.scale_idx, minlength=plan.scales.size)
    host = (host_tail_scales(counts, plan.scales) if host_tail
            else np.zeros(plan.scales.size, bool))
    is_prefix = np.array(
        [prefix and PREFIX_TREES < n_trees and w < TAIL_MIN_WINDOWS
         for w in counts], bool)
    t_limits = np.where(is_prefix, PREFIX_TREES, cap or n_trees)
    starts = np.concatenate([[0], np.cumsum(counts)])
    runs: list[Segment] = []
    host_ranges: list[tuple[int, int]] = []
    for k in range(plan.scales.size):
        lo, hi = int(starts[k]), int(starts[k + 1])
        if host[k]:
            if host_ranges and host_ranges[-1][1] == lo:
                host_ranges[-1] = (host_ranges[-1][0], hi)
            else:
                host_ranges.append((lo, hi))
            continue
        key = (bool(is_prefix[k]), int(t_limits[k]))
        if runs and (runs[-1].prefix, runs[-1].t_limit) == key \
                and runs[-1].hi == lo:
            runs[-1] = dataclasses.replace(runs[-1], hi=hi)
        else:
            runs.append(Segment(lo, hi, *key))
    marked = [s for s in runs if s.t_limit < n_trees]
    finish = (marked[0].lo, marked[-1].hi) if marked else None
    segments = tuple(sorted(runs, key=lambda s: s.prefix))  # A, then B
    return RoutedPlan(plan, is_prefix, t_limits, segments, finish, host,
                      tuple(host_ranges))


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card through pinned memory without
    blocking the host (no synchronisation while a stream dispatches)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_plan(plan: WindowPlan, device: torch.device):
    """The plan's per-window kernel inputs on `device`: (base, scale) int32
    [W], uploaded once per plan."""
    return (upload(plan.base.astype(np.int32), device),
            upload(plan.scale_w.astype(np.int32), device))


def _bind(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pigo_face_cascade.restype = i
    lib.pigo_face_cascade.argtypes = [
        vp, ll, i, i, i, vp, vp, ll, vp, vp, vp, i, i, i, i, i, i, vp, ll, vp,
    ]
    lib.pigo_face_prefix.restype = i
    lib.pigo_face_prefix.argtypes = [
        vp, ll, i, i, i, vp, vp, ll, vp, vp, vp, i, i, i, i, i, vp, ll, i, vp,
    ]
    lib.pigo_face_finish.restype = i
    lib.pigo_face_finish.argtypes = [
        vp, ll, i, i, i, vp, vp, ll, vp, vp, vp, i, i, i, i, i, vp, ll, vp,
    ]
    lib.pigo_face_schedule.restype = None
    lib.pigo_face_schedule.argtypes = [ctypes.POINTER(i)]


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and bind the face kernels' library
    (csrc/face_cascade.cu with csrc/face_prefix.cu)."""
    return build.load("face_cascade", _bind)


class Schedule(NamedTuple):
    """One kernel's two-phase schedule (csrc/face_walk.cuh)."""

    phase1_trees: int  # trees a window walks alone before it goes to a warp
    block_windows: int  # windows of a block, which bound its worklist
    block_threads: int  # threads of a block: its warps share the worklist
    dense_items: int  # the longest worklist walked a warp per entry


def schedule(lib: ctypes.CDLL | None = None) -> dict[str, Schedule]:
    """The schedules of "face_cascade" (with `face_finish`) and of
    "face_prefix", from the built library (`lib`, or the one load_kernel
    builds)."""
    out = (ctypes.c_int * 8)()
    (lib or load_kernel()).pigo_face_schedule(out)
    return {"face_cascade": Schedule(*out[:4]),
            "face_prefix": Schedule(*out[4:])}


def prefix_smem_bytes(t_limit: int, leaves: int) -> int:
    """Shared memory `face_prefix` stages: codes (4 B), preds (4 B) per
    node slot and thresh (4 B) per tree."""
    return t_limit * (8 * leaves + 4)


def _check(frames, base, scale, codes, preds, thresh, angle_idx, cols,
           out=None):
    """Validates the common inputs; returns cols."""
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError(f"frames must be uint8 [B, rows, dim], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    b, _, dim = frames.shape
    cols = dim if cols is None else int(cols)
    if not 1 <= cols <= dim:
        raise ValueError(f"cols {cols} outside [1, dim {dim}]")
    if not 0 <= angle_idx < len(QCOS_TABLE):
        raise ValueError(f"angle_idx {angle_idx} outside the rotation table")
    if angle_idx == 0 and cols != dim:
        raise ValueError("upright reads take a contiguous frame (cols == "
                         "dim): destride it first")
    w = base.shape[0] if base.dim() == 1 else -1
    for name, t in (("base", base), ("scale", scale)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != w:
            raise ValueError(f"{name} must be int32 [W] like base, got "
                             f"{t.dtype} {tuple(t.shape)}")
    t_num, leaves = preds.shape if preds.dim() == 2 else (0, 0)
    if (codes.dtype != torch.int8 or tuple(codes.shape) != (t_num, leaves, 4)
            or preds.dtype != torch.float32 or leaves < 2
            or leaves & (leaves - 1)
            or thresh.dtype != torch.float32
            or tuple(thresh.shape) != (t_num,)):
        raise ValueError(
            "forest tensors must be codes int8 [T, L, 4], preds f32 [T, L], "
            "thresh f32 [T] with L a power of two; got "
            f"{tuple(codes.shape)} {tuple(preds.shape)} {tuple(thresh.shape)}")
    tensors = [frames, base, scale, codes, preds, thresh]
    if out is not None:
        if (out.dtype != torch.float32 or tuple(out.shape) != (b, w)
                or (w > 1 and out.stride(1) != 1)):
            raise ValueError(f"out must be f32 [{b}, {w}] with unit column "
                             f"stride, got {out.dtype} {tuple(out.shape)}")
        tensors.append(out)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if not all(t.is_contiguous() for t in tensors[:6]):
        raise ValueError("the face kernels need contiguous inputs")
    return cols


def _device(frames, name):
    dev = frames.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def _common_args(frames, base, scale, codes, preds, thresh, cols):
    """The leading C arguments shared by the three entry points."""
    if codes.data_ptr() % 8:
        raise ValueError("codes must be 8-byte aligned (read as char4, and "
                         "as pairs of char4 by face_cascade and face_finish)")
    b, nrows, dim = frames.shape
    return (frames.data_ptr(), b, nrows, dim, cols, base.data_ptr(),
            scale.data_ptr(), base.shape[0], codes.data_ptr(),
            preds.data_ptr(), thresh.data_ptr(),
            preds.shape[1].bit_length() - 1)


def _rotation(angle_idx):
    return (int(angle_idx > 0), QCOS_TABLE[angle_idx], QSIN_TABLE[angle_idx])


def _out(frames, base, out):
    if out is None:
        out = torch.empty((frames.shape[0], base.shape[0]),
                          dtype=torch.float32, device=frames.device)
    return out


def face_cascade(
    frames: torch.Tensor,  # uint8 [B, rows, dim]
    base: torch.Tensor,  # int32 [W] r*cols + c per window
    scale: torch.Tensor,  # int32 [W] pyramid scale per window
    codes: torch.Tensor,  # int8 [T, L, 4]
    preds: torch.Tensor,  # f32 [T, L]
    thresh: torch.Tensor,  # f32 [T]
    t_limit: int,
    *,
    angle_idx: int = 0,
    cols: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Soft-cascade scores f32 [B, W] for every window of every frame
    (semantics in ops/face_dense.py), written into `out` when given (a
    [B, W] view with unit column stride, e.g. a column range of a larger
    score array). Upright windows must lie inside the frame with the
    pyramid margin (as build_window_plan makes them): the kernel does not
    bounds-check upright reads."""
    cols = _check(frames, base, scale, codes, preds, thresh, angle_idx, cols,
                  out)
    if not 1 <= t_limit <= preds.shape[0]:
        raise ValueError(f"t_limit {t_limit} outside [1, {preds.shape[0]}]")
    dev = _device(frames, "face_cascade")
    if dev.type == "cpu":
        q = face_dense.classify_windows(frames, base, scale, codes, preds,
                                        thresh, t_limit, angle_idx=angle_idx,
                                        cols=cols)
        return q if out is None else out.copy_(q)
    out = _out(frames, base, out)
    if out.numel() == 0:
        return out
    args = _common_args(frames, base, scale, codes, preds, thresh, cols)
    build.launch(load_kernel(), "pigo_face_cascade",
                 args + (preds.shape[0], t_limit, *_rotation(angle_idx),
                         out.data_ptr(), out.stride(0)),
                 dev, "face_cascade")
    return out


def face_prefix(frames, base, scale, codes, preds, thresh, t_limit, *,
                angle_idx=0, cols=None, out=None) -> torch.Tensor:
    """Tree-prefix scores f32 [B, W]: -1 for a window that fails within the
    first `t_limit` trees (1 <= t_limit < T), PREFIX_MARK for one that
    survives them (arguments as `face_cascade`). Raises ValueError when
    the t_limit trees' tables exceed PREFIX_SMEM_BYTES of shared memory,
    on either device."""
    cols = _check(frames, base, scale, codes, preds, thresh, angle_idx, cols,
                  out)
    if not 1 <= t_limit < preds.shape[0]:
        raise ValueError(f"t_limit {t_limit} outside [1, {preds.shape[0]})")
    smem = prefix_smem_bytes(t_limit, preds.shape[1])
    if smem > PREFIX_SMEM_BYTES:
        raise ValueError(f"{t_limit} trees of {preds.shape[1]} leaves stage "
                         f"{smem} B, above the {PREFIX_SMEM_BYTES} B of "
                         "shared memory face_prefix asks for")
    dev = _device(frames, "face_prefix")
    if dev.type == "cpu":
        q = face_dense.classify_windows(frames, base, scale, codes, preds,
                                        thresh, t_limit, angle_idx=angle_idx,
                                        cols=cols)
        return q if out is None else out.copy_(q)
    out = _out(frames, base, out)
    if out.numel() == 0:
        return out
    args = _common_args(frames, base, scale, codes, preds, thresh, cols)
    build.launch(load_kernel(), "pigo_face_prefix",
                 args + (t_limit, *_rotation(angle_idx), out.data_ptr(),
                         out.stride(0), smem),
                 dev, "face_prefix")
    return out


def face_finish(frames, base, scale, codes, preds, thresh, q, *,
                angle_idx=0, cols=None) -> torch.Tensor:
    """The exact finish, in place: every PREFIX_MARK score of q f32 [B, W]
    (a view with unit column stride over the windows base/scale describe)
    becomes the window's full-forest score; the other scores stay. Returns
    q. Plain version: face_dense.finish_marked."""
    cols = _check(frames, base, scale, codes, preds, thresh, angle_idx, cols,
                  q)
    dev = _device(frames, "face_finish")
    if dev.type == "cpu":
        return face_dense.finish_marked(frames, base, scale, codes, preds,
                                        thresh, q, angle_idx=angle_idx,
                                        cols=cols)
    if q.numel() == 0:
        return q
    args = _common_args(frames, base, scale, codes, preds, thresh, cols)
    build.launch(load_kernel(), "pigo_face_finish",
                 args + (preds.shape[0], *_rotation(angle_idx), q.data_ptr(),
                         q.stride(0)),
                 dev, "face_finish")
    return q
