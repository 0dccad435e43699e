"""The regression-walk kernel on the card: its wrappers.

`pupil_walk` is the port of pigo_tpu/ops/pupil_pallas.py::_stage_kernel
(the kernel is csrc/pupil_walk.cu). Where the TPU path launched one kernel
per stage over image patches and re-ran walk groups whose probes left
their patch, here one launch runs every stage of every walker against the
whole frame, so there is no patch, overflow flag or retry. On the card the
kernel reads the codes through the 1-based layout of
`convert.card_codes`, which `convert.pupil_forest_from_numpy` gives every
CUDA forest.

On a CPU tensor the wrapper runs the plain version (ops/pupil_dense.py);
on a CUDA tensor it launches the kernel through build.launch, which
counts it as "pupil_walk", or raises.

`pupil_ensemble` is the kernel's ensemble mode, on the card only: one
launch jitters G groups of P walkers from their anchors and uniforms
(pupil_dense.walker_starts), walks them and writes each group's per-axis
median (pupil_dense.median_vote), bit for bit what pupil_dense.ensemble
computes with this module's walk. A group's anchor may come from the eye
medians an earlier launch wrote (the landmark anchors of
detector.landmark_anchors), so a frame's post stage is two launches. It is
the same kernel, and counts as "pupil_walk" too.
"""

from __future__ import annotations

import ctypes

import torch

from pigo_tpu_torch.ops import pupil_dense
from pigo_tpu_torch.utils import build

# One warp per walker, one lane per tree (csrc/pupil_walk.cu).
MAX_TREES = 32

# The most walkers of one ensemble group: the group's votes, 12 B a
# walker, fill at most the 48 KB of shared memory a block has by default.
MAX_PERTURBS = 4096


def _bind(lib: ctypes.CDLL) -> None:
    vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_float
    lib.pigo_pupil_walk.restype = i
    lib.pigo_pupil_walk.argtypes = [
        vp, i, i, i, vp, vp, i, i, i, i, f, i, f, f, vp, vp, vp, vp, vp,
        ll, vp, vp,
    ]
    lib.pigo_pupil_ensemble.restype = i
    lib.pigo_pupil_ensemble.argtypes = [
        vp, i, i, i, vp, vp, i, i, i, i, f, i, f, f, vp, vp, vp, vp, vp, i,
        vp, vp, ll, ll, i, i, vp, ll, ll, vp,
    ]
    lib.pigo_pupil_schedule.restype = None
    lib.pigo_pupil_schedule.argtypes = [ctypes.POINTER(i)]


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    return build.load("pupil_walk", _bind)


def schedule(lib: ctypes.CDLL | None = None) -> int:
    """The walkers (warps) of one block of the walk kernel, from the built
    library (`lib`, or the one load_kernel builds)."""
    out = (ctypes.c_int * 1)()
    (lib or load_kernel()).pigo_pupil_schedule(out)
    return out[0]


def check_cascade_ids(casc_id: torch.Tensor, nc: int) -> None:
    """Raise ValueError for a host (CPU) id outside [0, nc). Ids already on
    the card are checked by the kernel, which faults the launch."""
    if casc_id.device.type == "cpu" and casc_id.numel() and not (
            0 <= int(casc_id.min()) and int(casc_id.max()) < nc):
        raise ValueError(f"cascade ids outside [0, {nc})")


def _check_tables(codes, preds, pixels, nrows, ncols, dim, angle_idx):
    """What every launch reads: the stacked forest, the frame, the angle."""
    if codes.dtype != torch.int8 or codes.dim() != 5 or codes.shape[4] != 4:
        raise ValueError(f"codes must be int8 [NC, S, T, L, 4], got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    nc, stages, trees, leaves, _ = codes.shape
    if (preds.dtype != torch.float32
            or tuple(preds.shape) != (nc, stages, trees, leaves, 2)
            or leaves < 2 or leaves & (leaves - 1)):
        raise ValueError(
            f"preds must be f32 [{nc}, {stages}, {trees}, {leaves}, 2] with "
            f"L a power of two, got {preds.dtype} {tuple(preds.shape)}")
    if not 1 <= trees <= MAX_TREES:
        raise ValueError(f"{trees} trees a stage: the kernel takes 1 to "
                         f"{MAX_TREES} (one lane each)")
    if (pixels.dtype != torch.uint8 or not 1 <= ncols <= dim
            or nrows < 1 or pixels.numel() < (nrows - 1) * dim + ncols):
        raise ValueError(
            f"pixels must be uint8 holding {nrows} rows of stride {dim} >= "
            f"{ncols} columns, got {pixels.dtype} {pixels.numel()} values")
    if not 0 <= angle_idx < len(pupil_dense.QSIN_TABLE):
        raise ValueError(f"angle_idx {angle_idx} outside the rotation table")


def _check_vectors(n: int, named) -> None:
    """Each (name, tensor or None, dtype) of `named`: that dtype, [n]."""
    for name, t, dt in named:
        if t is not None and (t.dtype != dt or t.dim() != 1
                              or t.shape[0] != n):
            raise ValueError(f"{name} must be {dt} [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def _check_placed(tensors, what: str) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous tensors")


def _check_card_layout(codes, preds) -> None:
    if codes.data_ptr() % 8 != 4 or preds.data_ptr() % 16:
        raise ValueError(
            "codes must be the card copy of convert.card_codes (one word "
            "past an 8-byte boundary, read as aligned pairs from the word "
            "before) and preds 16-byte aligned (read as leaf pairs)")


def _forest_args(codes, preds, pixels, nrows, ncols, dim, scale_mult,
                 rotated, angle_idx) -> tuple:
    """The arguments both C entry points open with."""
    nc, stages, trees, leaves, _ = codes.shape
    return (pixels.data_ptr(), nrows, ncols, dim, codes.data_ptr(),
            preds.data_ptr(), nc, stages, trees, leaves.bit_length() - 1,
            scale_mult, int(rotated),
            float(pupil_dense.QSIN_TABLE[angle_idx]),
            float(pupil_dense.QCOS_TABLE[angle_idx]))


def pupil_walk(codes, preds, casc_id, r0, c0, s0, col_sign, pixels, *,
               nrows, ncols, dim, scale_mult, rotated=False, angle_idx=0):
    """Refined (r, c, s) f32 [B] each for B walkers (semantics and
    arguments as ops/pupil_dense.walk). A casc_id outside [0, NC) raises
    ValueError on a CPU tensor; on the card the kernel traps before it
    reads a table, which fails the launch's stream (the next
    synchronisation raises) as PyTorch's own device-side index checks do."""
    _check_tables(codes, preds, pixels, nrows, ncols, dim, angle_idx)
    n = r0.shape[0] if r0.dim() == 1 else -1
    _check_vectors(n, (
        ("casc_id", casc_id, torch.int32), ("r0", r0, torch.float32),
        ("c0", c0, torch.float32), ("s0", s0, torch.float32),
        ("col_sign", col_sign, torch.int32)))
    check_cascade_ids(casc_id, codes.shape[0])
    _check_placed((codes, preds, casc_id, r0, c0, s0, col_sign, pixels),
                  "pupil_walk")
    dev = r0.device
    if dev.type == "cpu":
        return pupil_dense.walk(
            codes, preds, casc_id, r0, c0, s0, col_sign, pixels,
            nrows=nrows, ncols=ncols, dim=dim, scale_mult=scale_mult,
            rotated=rotated, angle_idx=angle_idx)
    if dev.type != "cuda":
        raise ValueError(f"pupil_walk runs on cuda or cpu, not {dev}")
    _check_card_layout(codes, preds)
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out[0], out[1], out[2]
    build.launch(load_kernel(), "pigo_pupil_walk", (
        *_forest_args(codes, preds, pixels, nrows, ncols, dim, scale_mult,
                      rotated, angle_idx),
        casc_id.data_ptr(), col_sign.data_ptr(), r0.data_ptr(),
        c0.data_ptr(), s0.data_ptr(), n, out.data_ptr()), dev, "pupil_walk")
    return out[0], out[1], out[2]


def pupil_ensemble(codes, preds, out, u, pixels, *, col0, nrows, ncols,
                   dim, scale_mult, anchors=None, npts=0, casc_id=None,
                   flips=None, u_rows=None, rotated=False, angle_idx=0):
    """One launch of the kernel's ensemble mode, on the card: G groups of
    P walkers jittered, walked and voted, group g's medians (row, col,
    scale) written to out[:, col0 + g] (out f32 [3, N]). Returns out.

    anchors: (rows0, cols0, scales0) f32 [G] each; or None, and group g
    anchors on face g // npts's landmark anchor (detector.
    landmark_anchors) from the eye medians in out's columns
    2 (g // npts) and 2 (g // npts) + 1, which an earlier launch wrote.
    casc_id int32 [G] (None: cascade 0); flips bool [G] (None: none);
    u f32 [R, P, 3]; u_rows int64 [G], group g's row of u (None: row g).
    The walk's arguments are pupil_walk's. An id outside [0, NC) or a row
    outside [0, R) traps on the card."""
    _check_tables(codes, preds, pixels, nrows, ncols, dim, angle_idx)
    g = anchors[0].shape[0] if anchors is not None else casc_id.shape[0]
    _check_vectors(g, (
        *zip(("rows0", "cols0", "scales0"), anchors or (None,) * 3,
             (torch.float32,) * 3),
        ("casc_id", casc_id, torch.int32), ("flips", flips, torch.bool),
        ("u_rows", u_rows, torch.int64)))
    p = u.shape[1] if u.dim() == 3 else 0
    if (u.dtype != torch.float32 or u.dim() != 3 or u.shape[2] != 3
            or not 1 <= p <= MAX_PERTURBS
            or (u_rows is None and u.shape[0] < g)):
        raise ValueError(f"u must be f32 [R, P, 3] with P in [1, "
                         f"{MAX_PERTURBS}] and a row for each of {g} "
                         f"groups, got {u.dtype} {tuple(u.shape)}")
    if anchors is None and (npts < 1 or g % npts or col0 < 2 * (g // npts)):
        raise ValueError(f"{g} groups anchored on the eye medians need "
                         f"npts >= 1 dividing them and their faces' eye "
                         f"columns before col0 {col0}")
    if (out.dtype != torch.float32 or out.dim() != 2 or out.shape[0] != 3
            or not 0 <= col0 <= out.shape[1] - g):
        raise ValueError(f"out must be f32 [3, N] with columns {col0} to "
                         f"{col0} + {g}, got {out.dtype} {tuple(out.shape)}")
    _check_placed([t for t in (codes, preds, out, u, pixels, casc_id, flips,
                               u_rows, *(anchors or ())) if t is not None],
                  "pupil_ensemble")
    if codes.device.type != "cuda":
        raise ValueError(f"pupil_ensemble runs on cuda, not {codes.device}")
    _check_card_layout(codes, preds)
    if g == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch(load_kernel(), "pigo_pupil_ensemble", (
        *_forest_args(codes, preds, pixels, nrows, ncols, dim, scale_mult,
                      rotated, angle_idx),
        ptr(casc_id), ptr(flips),
        *(map(ptr, anchors) if anchors is not None else (None,) * 3),
        npts, u.data_ptr(), ptr(u_rows), u.shape[0], g, p,
        pupil_dense.median_index(p), out.data_ptr(), out.shape[1], col0),
        codes.device, "pupil_walk")
    return out
