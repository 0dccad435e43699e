"""Plain PyTorch version of the pupil/landmark regression-tree walk.

Reference semantics: core/puploc.go classifyRegion (:106-154),
classifyRotatedRegion (:157-217) and RunDetector (:239-277); a copy of
pigo_tpu/ops/pupil_dense.py on tensors. The same function as the CUDA
kernel (csrc/pupil_walk.cu): every walker (one perturbed start of one
anchor) runs every stage; within a stage the trees are independent, so all
T trees of all B walkers advance together on a [B, T] grid, one depth level
at a time. Only CPU tensors (the tests) and the on-card comparison in
chip_smoke.py run this version.

Exactness (all kept, given identical uniforms):
  - int(r) truncates toward zero; the scale rounds half away from zero;
  - bintest `p1 > p2` upright, `p1 <= p2` rotated (a reference quirk);
  - each probe axis is clamped to [0, n-1] after a floor shift; the pixel
    index is r*dim + c, honouring a row stride;
  - a vertical flip negates the column codes and dc;
  - dr and dc are summed over trees strictly left to right from tree 0, one
    f32 add per tree (never `.sum()`, which would reorder the sum);
  - every f32 product and sum is its own rounded operation (no FMA), with
    f32 constants;
  - the ensemble takes each axis's median at index round(P/2), clamped.
"""

from __future__ import annotations

import numpy as np
import torch

# Quantized cos/sin of 2*pi*k/32, scaled by 256 (core/puploc.go:157-170).
QCOS_TABLE = (
    256, 251, 236, 212, 181, 142, 97, 49, 0, -49, -97, -142, -181, -212,
    -236, -251, -256, -251, -236, -212, -181, -142, -97, -49, 0, 49, 97,
    142, 181, 212, 236, 251, 256,
)
QSIN_TABLE = (
    0, 49, 97, 142, 181, 212, 236, 251, 256, 251, 236, 212, 181, 142, 97,
    49, 0, -49, -97, -142, -181, -212, -236, -251, -256, -251, -236, -212,
    -181, -142, -97, -49, 0,
)


def f32_scalar(v: float) -> torch.Tensor:
    """A float32 constant, so that no operand is carried in float64."""
    return torch.tensor(v, dtype=torch.float32)


def round_away(x: torch.Tensor) -> torch.Tensor:
    """Go math.Round: half away from zero, in f32."""
    half = f32_scalar(0.5)
    return torch.where(x >= 0, torch.floor(x + half), torch.ceil(x - half))


def angle_index(angle: float) -> int:
    """Index into QCOS_TABLE/QSIN_TABLE of an angle in turns (0 upright)."""
    return int(32.0 * min(angle, 1.0)) if angle > 0.0 else 0


def walk(codes, preds, casc_id, r0, c0, s0, col_sign, pixels, *, nrows,
         ncols, dim, scale_mult, rotated=False, angle_idx=0):
    """Run every stage for B walkers -> refined (r, c, s), f32 [B] each.

    codes int8 [NC, S, T, L, 4]; preds f32 [NC, S, T, L, 2]; casc_id int32
    [B] (the cascade of each walker); r0/c0/s0 f32 [B]; col_sign int32 [B]
    (+1, or -1 for a vertical flip); pixels uint8 [nrows*dim] (row stride
    dim)."""
    return walk_with_work(codes, preds, casc_id, r0, c0, s0, col_sign,
                          pixels, nrows=nrows, ncols=ncols, dim=dim,
                          scale_mult=scale_mult, rotated=rotated,
                          angle_idx=angle_idx, track=False)[:3]


def walk_with_work(codes, preds, casc_id, r0, c0, s0, col_sign, pixels, *,
                   nrows, ncols, dim, scale_mult, rotated=False,
                   angle_idx=0, track=True):
    """walk, plus what this run's data read: a dict with the distinct
    pixels the probes hit ("pixels"), and the distinct code words and
    leaves the walkers visited (None when not `track`)."""
    nc, stages, trees, leaves, _ = codes.shape
    depth = leaves.bit_length() - 1
    dev = r0.device
    i32 = torch.int32
    codes_flat = codes.reshape(-1, 4).to(i32)
    preds_flat = preds.reshape(-1, 2)
    pix = pixels.reshape(-1)
    seen = {kind: torch.zeros(n, dtype=torch.bool, device=dev)
            for kind, n in (("pixels", pix.shape[0]),
                            ("code_words", codes_flat.shape[0]),
                            ("leaves", codes_flat.shape[0]))} if track else {}
    sign_f = col_sign.to(torch.float32)[:, None]
    cs = col_sign.to(i32)[:, None]
    base_c = casc_id.to(torch.int64) * (stages * trees * leaves)
    tree_ix = torch.arange(trees, device=dev, dtype=torch.int64)[None, :]
    smul = f32_scalar(scale_mult)
    qsin_v = f32_scalar(QSIN_TABLE[angle_idx])
    qcos_v = f32_scalar(QCOS_TABLE[angle_idx])

    def mark(kind, at):
        if track:
            seen[kind][at.reshape(-1)] = True

    def probe(rr, cc):
        at = (rr * dim + cc).to(torch.int64)
        mark("pixels", at)
        return pix[at]

    r, c, s = r0, c0, s0
    for i in range(stages):
        if rotated:
            qsin = (s * qsin_v).to(i32)[:, None]
            qcos = (s * qcos_v).to(i32)[:, None]
            ri = (65536 * r.to(i32))[:, None]
            ci = (65536 * c.to(i32))[:, None]
        else:
            ri = (256 * r.to(i32))[:, None]
            ci = (256 * c.to(i32))[:, None]
            si = round_away(s).to(i32)[:, None]
        node_base = base_c[:, None] + (i * trees + tree_ix) * leaves  # [B, T]
        idx = torch.zeros_like(node_base)
        for _ in range(depth):
            node = node_base + idx
            mark("code_words", node)
            k0, k1, k2, k3 = codes_flat[node].unbind(-1)
            if rotated:
                # 16.16 fixed point, max before the shift (puploc.go:181-190)
                col1 = cs * k1
                col2 = cs * k3
                r1 = torch.clamp(torch.clamp(
                    ri + qcos * k0 - qsin * col1, min=0) >> 16, 0, nrows - 1)
                c1 = torch.clamp(torch.clamp(
                    ci + qsin * k0 + qcos * col1, min=0) >> 16, 0, ncols - 1)
                r2 = torch.clamp(torch.clamp(
                    ri + qcos * k2 - qsin * col2, min=0) >> 16, 0, nrows - 1)
                c2 = torch.clamp(torch.clamp(
                    ci + qsin * k2 + qcos * col2, min=0) >> 16, 0, ncols - 1)
                bit = probe(r1, c1) <= probe(r2, c2)
            else:
                r1 = torch.clamp((ri + k0 * si) >> 8, 0, nrows - 1)
                r2 = torch.clamp((ri + k2 * si) >> 8, 0, nrows - 1)
                c1 = torch.clamp((ci + cs * k1 * si) >> 8, 0, ncols - 1)
                c2 = torch.clamp((ci + cs * k3 * si) >> 8, 0, ncols - 1)
                bit = probe(r1, c1) > probe(r2, c2)
            idx = 2 * idx + 1 + bit.to(torch.int64)
        lut = node_base + (idx - (leaves - 1))
        mark("leaves", lut)
        pr = preds_flat[lut]  # [B, T, 2]
        dr_t = pr[..., 0]
        dc_t = sign_f * pr[..., 1]
        dr = dr_t[:, 0]
        dc = dc_t[:, 0]
        for j in range(1, trees):
            dr = dr + dr_t[:, j]
            dc = dc + dc_t[:, j]
        r = r + dr * s
        c = c + dc * s
        s = s * smul
    work = {kind: int(v.sum()) for kind, v in seen.items()} if track else None
    return r, c, s, work


def make_perturbations(row, col, scale, u):
    """Jittered start triples from uniforms u [..., 3] (puploc.go:248-250).

    row/col/scale are f32 tensors broadcastable against u[..., 0]. Every
    operation is one f32 rounding, in the reference's order."""
    u = u.to(torch.float32)
    k15, half = f32_scalar(0.15), f32_scalar(0.5)
    rows = row + (scale * k15) * (half - u[..., 0])
    cols = col + (scale * k15) * (half - u[..., 1])
    scales = scale * (f32_scalar(0.925) + k15 * u[..., 2])
    return rows, cols, scales


def median_index(perturbs: int) -> int:
    """The vote's index in sorted order: round(P/2), clamped to P - 1."""
    return min(int(np.floor(perturbs / 2.0 + 0.5)), perturbs - 1)


def median_vote(r, c, s, perturbs: int):
    """Per-axis median at index round(P/2) (puploc.go:266-276), clamped.

    r/c/s: [..., P]. Returns ([...], [...], [...]) median triples."""
    mid = median_index(perturbs)
    return tuple(torch.sort(v, dim=-1).values[..., mid] for v in (r, c, s))


def ensemble(codes, preds, casc_id, rows0, cols0, scales0, flips, u, pixels,
             *, nrows, ncols, dim, scale_mult, rotated=False, angle_idx=0,
             walk=walk):
    """Jitter -> walk -> per-group median.

    casc_id/rows0/cols0/scales0/flips: [G] per group; u: [G, P, 3] f32
    uniforms. Returns [3, G] f32 medians (row, col, scale). `walk` is this
    module's plain walk or the kernel wrapper `pupil_cuda.pupil_walk`,
    which takes the same arguments."""
    g, p = u.shape[0], u.shape[1]
    r, c, s = walk(
        codes, preds,
        *walker_starts(casc_id, rows0, cols0, scales0, flips, u), pixels,
        nrows=nrows, ncols=ncols, dim=dim, scale_mult=scale_mult,
        rotated=rotated, angle_idx=angle_idx)
    rm, cm, sm = median_vote(r.reshape(g, p), c.reshape(g, p),
                             s.reshape(g, p), p)
    return torch.stack([rm, cm, sm])


def repeat_each(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [N] -> [N*k] contiguous, each element k times in a row:
    repeat_interleave by a copy, with no host synchronisation on a card."""
    return x[:, None].repeat(1, k).reshape(-1)


def walker_starts(casc_id, rows0, cols0, scales0, flips, u):
    """The walk's inputs for G groups of P jittered starts: per-group
    casc_id/rows0/cols0/scales0/flips [G] and uniforms u [G, P, 3] ->
    (casc_id int32, r0, c0, s0 f32, col_sign int32), each [G*P] in group
    order."""
    p = u.shape[1]
    r0, c0, s0 = make_perturbations(rows0[:, None], cols0[:, None],
                                    scales0[:, None], u)
    col_sign = torch.where(flips, -1, 1).to(torch.int32)
    return (repeat_each(casc_id.to(torch.int32), p), r0.reshape(-1),
            c0.reshape(-1), s0.reshape(-1), repeat_each(col_sign, p))
