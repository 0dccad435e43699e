"""Plain PyTorch version of the soft-cascade face classifier.

The same functions as the CUDA kernels (csrc/face_cascade.cu,
csrc/face_prefix.cu) on tensors: for every (frame, window) it walks each
tree by comparing `p1 <= p2` at the node's pixel pair, adds the leaf value
to an f32 running sum strictly left to right (one elementwise add per
tree, never a reduction over trees, which would reorder the sum), and fails
the window for good on `out <= thresh[t]` (core/pigo.go:113-147).

Result per window: -1.0 when it failed; PREFIX_MARK when it survived
`t_limit < T` trees; otherwise `out - thresh[T-1]`.

Node reads (frames uint8 [B, nrows, dim], row stride dim; window centre
(r, c) at scale s; node code (cr, cc)):
  - upright (angle_idx 0): pix[(r + ((cr*s) >> 8)) * dim + c + ((cc*s) >> 8)],
    never clamped (the pyramid margin keeps every read inside the frame);
  - rotated (angle_idx in 1..32, core/pigo.go:150-191): with
    qc = s*QCOS[angle_idx] and qs = s*QSIN[angle_idx],
        r' = min(nrows-1, max(0, r*65536 + qc*cr - qs*cc) >> 16)
        c' = min(nrows-1, max(0, c*65536 + qs*cr + qc*cc) >> 16)
    and pix[min(r'*dim + c', nrows*dim - 1)]. Both axes clamp with nrows-1
    (the reference's quirk), so on a tall frame a clamped column can pass
    the row's end and wrap into the next row (the reference reads it so);
    on the last row the flat index is clamped to the buffer, as the JAX
    package's gather clamps it.

The working set shrinks to the windows still alive after each tree. That is
exact: a failed window's result is -1 whatever follows. Only CPU tensors
(the tests) and the on-card comparisons in chip_smoke.py run this version.
"""

from __future__ import annotations

import torch

from pigo_tpu_torch.ops.pupil_dense import QCOS_TABLE, QSIN_TABLE

# Placeholder score for a window that survived a tree limit below the
# forest size (pigo_tpu/ops/face_pallas.py PREFIX_MARK).
PREFIX_MARK = 1e30


def classify_windows(
    frames: torch.Tensor,  # uint8 [B, nrows, dim]
    base: torch.Tensor,  # int32 [W] r*cols + c per window
    scale: torch.Tensor,  # int32 [W] pyramid scale per window
    codes: torch.Tensor,  # int8 [T, L, 4] node (r1, c1, r2, c2)
    preds: torch.Tensor,  # f32 [T, L]
    thresh: torch.Tensor,  # f32 [T]
    t_limit: int,
    *,
    angle_idx: int = 0,
    cols: int | None = None,  # base's row length; default dim
) -> torch.Tensor:
    """Scores f32 [B, W] (see module docstring). With angle_idx > 0 this is
    the counterpart of pigo_tpu/ops/face_dense.py:108
    classify_windows_rotated, with a tree limit: the window centres are
    base decoded with cols, and the frame is read with its row stride."""
    return cascade_with_work(frames, base, scale, codes, preds, thresh,
                             t_limit, angle_idx=angle_idx, cols=cols,
                             track=False)[0]


def cascade_with_work(frames, base, scale, codes, preds, thresh, t_limit, *,
                      angle_idx=0, cols=None, track=True):
    """classify_windows plus what this run's data took: a dict with the
    tree evaluations ("evaluations", the sum over trees of the windows alive
    at that tree) and the trees evaluated ("trees"), and, when `track`, the
    distinct pixels ("pixels", over the whole batch), code words
    ("code_words") and leaves ("leaves") read."""
    b, nrows, dim = frames.shape
    w = base.shape[0]
    dev = frames.device
    frame = torch.arange(b, device=dev, dtype=torch.int64).repeat_interleave(w)
    win = torch.arange(w, device=dev, dtype=torch.int64).repeat(b)
    q, work = _cascade(frames, frame, win, base, scale, codes, preds, thresh,
                       t_limit, angle_idx, cols, track)
    return q.reshape(b, w), work


def finish_marked(frames, base, scale, codes, preds, thresh, q, *,
                  angle_idx=0, cols=None) -> torch.Tensor:
    """The exact finish: every window of q f32 [B, W] whose score is
    PREFIX_MARK gets its full-forest score (-1 or out - thresh[T-1]), in
    place; every other score stays. Returns q."""
    return finish_with_work(frames, base, scale, codes, preds, thresh, q,
                            angle_idx=angle_idx, cols=cols, track=False)[0]


def finish_with_work(frames, base, scale, codes, preds, thresh, q, *,
                     angle_idx=0, cols=None, track=True):
    """finish_marked plus what it took (the dict of cascade_with_work, over
    the marked windows alone)."""
    frame, win = torch.nonzero(q == PREFIX_MARK, as_tuple=True)
    q[frame, win], work = _cascade(frames, frame, win, base, scale, codes,
                                   preds, thresh, preds.shape[0], angle_idx,
                                   cols, track)
    return q, work


def _cascade(frames, frame, win, base, scale, codes, preds, thresh, t_limit,
             angle_idx, cols, track):
    """Scores f32 [N] and the work (cascade_with_work) of N (frame, window)
    pairs: frame and win int64 [N] index frames and the window tables.

    Both pixels of a node are read in one gather. Rotated reads take their
    numerators (qc*cr - qs*cc, qs*cr + qc*cc per node end) from a table per
    (scale, tree, node), the same integers the kernel computes per read.
    The per-window state is filtered only after a tree that fails some
    window: on the long tail of trees nothing fails, and the op count, not
    the data, is what this version's time goes to."""
    _, nrows, dim = frames.shape
    cols = dim if cols is None else cols
    t_num, leaves = preds.shape
    depth = leaves.bit_length() - 1
    dev = frames.device
    pix = frames.reshape(-1)
    base64 = base.to(torch.int64)[win]
    r = torch.div(base64, cols, rounding_mode="floor")
    c = base64 - r * cols
    origin = frame * (nrows * dim)
    codes64 = codes[:t_limit].to(torch.int64)  # [t, L, 4] (r1, c1, r2, c2)
    if angle_idx == 0:
        state = [origin + r * dim + c, scale.to(torch.int64)[win][:, None]]

        def addresses(t, idx, st):  # -> [n, 2] flat pixels of both node ends
            at, s = st
            d = (codes64[t][idx] * s) >> 8
            return at[:, None] + d[:, 0::2] * dim + d[:, 1::2]
    else:
        hi, last = nrows - 1, nrows * dim - 1
        scales, sid = torch.unique(scale.to(torch.int64),
                                   return_inverse=True)
        qc = (scales * QCOS_TABLE[angle_idx])[:, None, None, None]
        qs = (scales * QSIN_TABLE[angle_idx])[:, None, None, None]
        cr, cc = codes64[None, ..., 0::2], codes64[None, ..., 1::2]
        # [S, t, L, 4]: (row1, col1, row2, col2) numerators
        num = torch.stack([qc * cr - qs * cc, qs * cr + qc * cc],
                          dim=-1).reshape(*qc.shape[:1], *codes64.shape)
        state = [origin[:, None], (torch.stack([r, c, r, c], 1) << 16),
                 sid[win]]

        def addresses(t, idx, st):
            at, b16, sc = st
            v = ((b16 + num[:, t][sc, idx]).clamp_min(0) >> 16).clamp_max(hi)
            return at + (v[:, 0::2] * dim + v[:, 1::2]).clamp_max(last)

    seen = {kind: torch.zeros(n, dtype=torch.bool, device=dev)
            for kind, n in (("pixels", pix.shape[0]),
                            ("code_words", t_limit * leaves),
                            ("leaves", t_limit * leaves))} if track else {}

    n = frame.numel()
    live = torch.arange(n, device=dev)
    out = torch.zeros(n, dtype=torch.float32, device=dev)
    evals = trees = 0
    for t in range(t_limit):
        if live.numel() == 0:
            break
        evals += live.numel()
        trees += 1
        idx = torch.ones_like(live)
        for _ in range(depth):
            at = addresses(t, idx, state)
            if track:
                seen["pixels"][at.reshape(-1)] = True
                seen["code_words"][t * leaves + idx] = True
            p = pix[at]
            idx = 2 * idx + (p[:, 0] <= p[:, 1]).to(torch.int64)
        if track:
            seen["leaves"][t * leaves + idx - leaves] = True
        out = out + preds[t][idx - leaves]
        keep = ~(out <= thresh[t])
        if not bool(keep.all()):
            sel = torch.nonzero(keep).squeeze(1)
            live, out = live[sel], out[sel]
            state = [v[sel] for v in state]
    if t_limit < t_num:
        final = torch.full_like(out, PREFIX_MARK)
    else:
        final = out - thresh[t_num - 1]
    q = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    q[live] = final
    work = {"evaluations": evals, "trees": trees}
    work.update((kind, int(v.sum())) for kind, v in seen.items())
    return q, work
