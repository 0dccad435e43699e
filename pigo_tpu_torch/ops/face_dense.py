"""Plain PyTorch version of the soft-cascade face classifier.

The same function as the CUDA kernel (csrc/face_cascade.cu) on tensors:
for every (frame, window) it walks each tree by comparing `p1 <= p2` at the
node's pixel pair, adds the leaf value to an f32 running sum strictly left
to right (one elementwise add per tree, never a reduction over trees, which
would reorder the sum), and fails the window for good on
`out <= thresh[t]` (core/pigo.go:113-147).

Result per window: -1.0 when it failed; PREFIX_MARK when it survived
`t_limit < T` trees; otherwise `out - thresh[T-1]`.

The working set shrinks to the windows still alive after each tree. That is
exact: a failed window's result is -1 whatever follows. Only CPU tensors
(the tests) and the on-card comparison in chip_smoke.py run this version.
"""

from __future__ import annotations

import torch

# Placeholder score for a window that survived a tree limit below the
# forest size (pigo_tpu/ops/face_pallas.py PREFIX_MARK).
PREFIX_MARK = 1e30


def classify_windows(
    frames: torch.Tensor,  # uint8 [B, rows, cols]
    base: torch.Tensor,  # int32 [W] r*cols + c per window
    scale: torch.Tensor,  # int32 [W] pyramid scale per window
    codes: torch.Tensor,  # int8 [T, L, 4] node (r1, c1, r2, c2)
    preds: torch.Tensor,  # f32 [T, L]
    thresh: torch.Tensor,  # f32 [T]
    t_limit: int,
) -> torch.Tensor:
    """Scores f32 [B, W] (see module docstring)."""
    return cascade_with_work(frames, base, scale, codes, preds, thresh,
                             t_limit)[0]


def cascade_with_work(frames, base, scale, codes, preds, thresh, t_limit):
    """classify_windows plus the number of tree evaluations it took
    (sum over trees of the windows alive at that tree)."""
    b, rows, cols = frames.shape
    w = base.shape[0]
    t_num, leaves = preds.shape
    depth = leaves.bit_length() - 1
    dev = frames.device
    pix = frames.reshape(-1)
    gbase = (torch.arange(b, device=dev, dtype=torch.int64)[:, None]
             * (rows * cols) + base.to(torch.int64)[None, :]).reshape(-1)
    s = scale.to(torch.int64).repeat(b)[:, None]
    live = torch.arange(b * w, device=dev)
    out = torch.zeros(b * w, dtype=torch.float32, device=dev)
    codes64 = codes.to(torch.int64)
    evals = 0
    for t in range(t_limit):
        if live.numel() == 0:
            break
        evals += live.numel()
        node = codes64[t]
        idx = torch.ones_like(live)
        for _ in range(depth):
            d = (node[idx] * s) >> 8  # [n, 4] (dr1, dc1, dr2, dc2)
            p1 = pix[gbase + d[:, 0] * cols + d[:, 1]]
            p2 = pix[gbase + d[:, 2] * cols + d[:, 3]]
            idx = 2 * idx + (p1 <= p2).to(torch.int64)
        out = out + preds[t][idx - leaves]
        keep = ~(out <= thresh[t])
        live, out, gbase, s = live[keep], out[keep], gbase[keep], s[keep]
    if t_limit < t_num:
        final = torch.full_like(out, PREFIX_MARK)
    else:
        final = out - thresh[t_num - 1]
    q = torch.full((b * w,), -1.0, dtype=torch.float32, device=dev)
    q[live] = final
    return q.reshape(b, w), evals
