"""The soft-cascade kernel on the card: plan tables, wrapper, launch count.

`face_cascade` is the port of pigo_tpu/ops/face_pallas.py::_kernel_body
(the kernel is csrc/face_cascade.cu). Where the TPU path launched one
kernel per pyramid scale over a routed subset of scales, here every window
of every scale of every frame goes to one launch, in the plan's scan order
(scale-major, then row, then col). So the host tail engine, tree-prefix
mode and the tree cap have no role on this path; `t_limit` still selects
the prefix semantics (PREFIX_MARK for survivors) when it is below T.

On a CPU tensor the wrapper runs the plain version (ops/face_dense.py); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pigo_tpu_torch.ops import face_dense
from pigo_tpu_torch.ops.windows import WindowPlan
from pigo_tpu_torch.utils import build

# Kernel launches made by `face_cascade` (CUDA tensors only). Callers reset
# it to 0 and read it to show that a run went through the kernel.
face_cascade_launches = 0


def device_plan(plan: WindowPlan, device: torch.device):
    """The plan's per-window kernel inputs on `device`: (base, scale) int32
    [W], uploaded once per plan."""
    base = torch.from_numpy(np.ascontiguousarray(plan.base, np.int32))
    scale = torch.from_numpy(np.ascontiguousarray(plan.scale_w, np.int32))
    return base.to(device), scale.to(device)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pigo_face_cascade.restype = i
    lib.pigo_face_cascade.argtypes = [
        vp, ll, ll, i, vp, vp, ll, vp, vp, vp, i, i, i, vp, vp,
    ]
    lib.pigo_cuda_error_string.restype = ctypes.c_char_p
    lib.pigo_cuda_error_string.argtypes = [i]


def load_kernel() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    return build.load("face_cascade", _bind)


def _check(frames, base, scale, codes, preds, thresh, t_limit):
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError(f"frames must be uint8 [B, rows, cols], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
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
    if not 1 <= t_limit <= t_num:
        raise ValueError(f"t_limit {t_limit} outside [1, {t_num}]")
    devs = {t.device for t in (frames, base, scale, codes, preds, thresh)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    if not all(t.is_contiguous()
               for t in (frames, base, scale, codes, preds, thresh)):
        raise ValueError("face_cascade needs contiguous tensors")


def face_cascade(
    frames: torch.Tensor,  # uint8 [B, rows, cols]
    base: torch.Tensor,  # int32 [W] r*cols + c per window
    scale: torch.Tensor,  # int32 [W] pyramid scale per window
    codes: torch.Tensor,  # int8 [T, L, 4]
    preds: torch.Tensor,  # f32 [T, L]
    thresh: torch.Tensor,  # f32 [T]
    t_limit: int,
) -> torch.Tensor:
    """Soft-cascade scores f32 [B, W] for every window of every frame
    (semantics in ops/face_dense.py). The windows must lie inside the frame
    with the pyramid margin (as build_window_plan makes them): the kernel
    does not bounds-check its pixel reads."""
    global face_cascade_launches
    _check(frames, base, scale, codes, preds, thresh, t_limit)
    dev = frames.device
    if dev.type == "cpu":
        return face_dense.classify_windows(frames, base, scale, codes, preds,
                                           thresh, t_limit)
    if dev.type != "cuda":
        raise ValueError(f"face_cascade runs on cuda or cpu, not {dev}")
    if codes.data_ptr() % 4:
        raise ValueError("codes must be 4-byte aligned (read as char4)")
    b, rows, cols = frames.shape
    w = base.shape[0]
    out = torch.empty((b, w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pigo_face_cascade(
            frames.data_ptr(), b, rows * cols, cols, base.data_ptr(),
            scale.data_ptr(), w, codes.data_ptr(), preds.data_ptr(),
            thresh.data_ptr(), preds.shape[1].bit_length() - 1,
            preds.shape[0], t_limit, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.pigo_cuda_error_string(rc).decode()
        raise RuntimeError(f"face_cascade launch failed: {msg} ({rc})")
    face_cascade_launches += 1
    return out
