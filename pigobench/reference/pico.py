"""Plain reference of the PICO pipeline the benchmark judges answers by.

Faces (soft-cascade face classifier over the window pyramid, then IoU
clustering), pupils (puploc's regression walk over 63 jittered starts and
a median vote) and the 15 landmark points (the nine `lps` cascades) of
esimov/pigo (core/pigo.go, core/puploc.go, core/flploc.go, cmd/pigo), in
plain PyTorch and NumPy. It reads the raw cascade files and the frames the
harness makes, and nothing of the program under test: every table, anchor
and draw is worked out here again.

Exactness: integer window and probe arithmetic with arithmetic shifts;
leaf values added one tree at a time, left to right, in `acc` (float32 is
the reference; the control passes a lower precision); every float product
and sum its own rounded operation; int() truncates toward zero, the walk's
scale rounds half away from zero; the median at index round(P/2).

Jitter: request i draws its uniforms from
`torch.Generator().manual_seed(seed_i)` on the host, the eyes' [2F, P, 3]
first, then the landmarks' [15F, P, 3], F being the frame's faces with
q > 5 and scale > 50.

Work counts (`work=True`) are what a kernel needs to read for these inputs:
the distinct pixels, code words and leaves, with the trees and windows
walked; lib/work.py turns them into operations and bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# cmd/pigo/main.go: perturbations, the face gate and the eye gate
PERTURBS = 63
Q_THRESH = 5.0
MIN_EYE_FACE_SCALE = 50
# The landmark schedule (cmd/pigo/main.go:68-71, :493-564): five eye
# cascades, then the same five flipped, four mouth cascades, and lp84
# flipped as the nose.
EYE_CASCADES = ("lp46", "lp44", "lp42", "lp38", "lp312")
MOUTH_CASCADES = ("lp93", "lp84", "lp82", "lp81")
POINTS = ([(n, False) for n in EYE_CASCADES] + [(n, True) for n in EYE_CASCADES]
          + [(n, False) for n in MOUTH_CASCADES] + [("lp84", True)])


# ---------------------------------------------------------------- cascades


@dataclasses.dataclass(frozen=True)
class FaceForest:
    depth: int
    codes: np.ndarray  # int8 [T, L, 4], node 0 a zero pad
    preds: np.ndarray  # f32 [T, L]
    thresh: np.ndarray  # f32 [T]


@dataclasses.dataclass(frozen=True)
class WalkForest:
    """One or more regression cascades of one geometry, stacked."""

    stages: int
    trees: int
    depth: int
    scale_mult: float
    codes: np.ndarray  # int8 [NC, S, T, L, 4], slot L-1 a zero pad
    preds: np.ndarray  # f32 [NC, S, T, L, 2]


def face_forest(packet: bytes) -> FaceForest:
    """core/pigo.go:51-110: an 8-byte header, depth and tree count, then per
    tree 4*(2^depth - 1) code bytes, 2^depth f32 leaves and a threshold."""
    depth, trees = (int(v) for v in np.frombuffer(packet, "<u4", 2, 8))
    leaves = 1 << depth
    nbytes = 4 * leaves - 4
    rec = np.frombuffer(packet, np.uint8, trees * (nbytes + 4 * leaves + 4),
                        16).reshape(trees, -1)
    codes = np.zeros((trees, leaves, 4), np.int8)
    codes[:, 1:] = rec[:, :nbytes].view(np.int8).reshape(trees, leaves - 1, 4)
    tail = rec[:, nbytes:].copy().view("<f4")
    return FaceForest(depth, codes, tail[:, :leaves].astype(np.float32),
                      tail[:, leaves].astype(np.float32))


def walk_forest(packets: list[bytes]) -> WalkForest:
    """core/puploc.go:38-103 for each packet: stages, scale multiplier,
    trees a stage and depth, then per tree 4*(2^depth - 1) code bytes and
    2^depth (dr, dc) f32 leaves; stacked on a leading cascade axis."""
    codes, preds, geom = [], [], None
    for packet in packets:
        stages, _, trees, depth = (int(v) for v in np.frombuffer(packet,
                                                                  "<u4", 4))
        mult = float(np.frombuffer(packet, "<f4", 1, 4)[0])
        leaves = 1 << depth
        nbytes = 4 * leaves - 4
        n = stages * trees
        rec = np.frombuffer(packet, np.uint8, n * (nbytes + 8 * leaves),
                            16).reshape(n, -1)
        c = np.zeros((n, leaves, 4), np.int8)
        c[:, :leaves - 1] = rec[:, :nbytes].view(np.int8).reshape(
            n, leaves - 1, 4)
        codes.append(c.reshape(stages, trees, leaves, 4))
        preds.append(rec[:, nbytes:].copy().view("<f4").reshape(
            stages, trees, leaves, 2))
        if geom not in (None, (stages, trees, depth, mult)):
            raise ValueError("stacked cascades differ in geometry")
        geom = (stages, trees, depth, mult)
    stages, trees, depth, mult = geom
    return WalkForest(stages, trees, depth, mult, np.stack(codes),
                      np.stack(preds))


# ----------------------------------------------------------------- faces


def pyramid(rows: int, cols: int, min_size: int, max_size: int,
            shift_factor: float, scale_factor: float):
    """RunCascade's windows in scan order (core/pigo.go:212-258): window
    centre rows, cols and scales, int64 [W] each."""
    rr_all, cc_all, ss_all = [], [], []
    s = int(min_size)
    while s <= max_size:
        step = int(max(shift_factor * s, 1.0))
        off = s // 2 + 1
        rr = np.arange(off, rows - off + 1, step, dtype=np.int64)
        cc = np.arange(off, cols - off + 1, step, dtype=np.int64)
        rr_all.append(np.repeat(rr, cc.size))
        cc_all.append(np.tile(cc, rr.size))
        ss_all.append(np.full(rr.size * cc.size, s, np.int64))
        s = int(s + max(2.0, s * scale_factor - s))
    cat = (lambda v: np.concatenate(v) if v else np.zeros(0, np.int64))
    return cat(rr_all), cat(cc_all), cat(ss_all)


def face_scores(frames: torch.Tensor, forest: FaceForest, windows, *,
                acc=torch.float32, work: bool = False):
    """Soft-cascade scores f32 [B, W] of frames uint8 [B, rows, cols] at
    the windows (pyramid's rows, cols, scales): -1 for a window that failed
    a tree, else the sum of its leaves less the last threshold
    (core/pigo.go:113-147). With `work`, per frame: windows, evaluations
    (windows alive at each tree, summed), trees, and the distinct pixels,
    code words and leaves read."""
    b, rows, cols = frames.shape
    dev = frames.device
    r, c, s = (torch.as_tensor(v, device=dev) for v in windows)
    w = r.numel()
    leaves = 1 << forest.depth
    codes = torch.as_tensor(forest.codes, device=dev).to(torch.int64)
    preds = torch.as_tensor(forest.preds, device=dev).to(acc)
    thresh = torch.as_tensor(forest.thresh, device=dev).to(acc)
    pix = frames.reshape(-1)
    frame = torch.arange(b, device=dev).repeat_interleave(w)
    win = torch.arange(w, device=dev).repeat(b)
    r256, c256, sc = r[win] * 256, c[win] * 256, s[win]
    origin = frame * (rows * cols)
    live = torch.arange(b * w, device=dev)
    out = torch.zeros(b * w, dtype=acc, device=dev)
    if work:
        seen_pix = torch.zeros(b * rows * cols, dtype=torch.bool, device=dev)
        seen_code = torch.zeros(b, codes.shape[0] * leaves, dtype=torch.bool,
                                device=dev)
        seen_leaf = torch.zeros_like(seen_code)
        evals = torch.zeros(b, dtype=torch.int64, device=dev)
        trees = torch.zeros(b, dtype=torch.int64, device=dev)
    for t in range(codes.shape[0]):
        if live.numel() == 0:
            break
        idx = torch.ones_like(live)
        fr = frame[live]
        ra, ca, sa, oa = r256[live], c256[live], sc[live], origin[live]
        if work:
            alive = torch.bincount(fr, minlength=b)
            evals += alive
            trees += alive > 0
        for _ in range(forest.depth):
            k = codes[t][idx]  # [A, 4] (r1, c1, r2, c2)
            x1 = oa + ((ra + k[:, 0] * sa) >> 8) * cols + (
                (ca + k[:, 1] * sa) >> 8)
            x2 = oa + ((ra + k[:, 2] * sa) >> 8) * cols + (
                (ca + k[:, 3] * sa) >> 8)
            if work:
                seen_pix[x1] = True
                seen_pix[x2] = True
                seen_code[fr, t * leaves + idx] = True
            idx = 2 * idx + (pix[x1] <= pix[x2]).to(torch.int64)
        if work:
            seen_leaf[fr, t * leaves + idx - leaves] = True
        out = out + preds[t][idx - leaves]
        keep = out > thresh[t]
        live, out = live[keep], out[keep]
    q = torch.full((b * w,), -1.0, dtype=torch.float32, device=dev)
    q[live] = (out - thresh[-1]).to(torch.float32)
    counts = None
    if work:
        counts = [dict(windows=w, evaluations=int(evals[i]),
                       trees=int(trees[i]),
                       pixels=int(seen_pix[i * rows * cols:(i + 1) * rows
                                           * cols].sum()),
                       code_words=int(seen_code[i].sum()),
                       leaves=int(seen_leaf[i].sum()))
                  for i in range(b)]
    return q.reshape(b, w), counts


def face_hits(q: torch.Tensor, windows) -> list[np.ndarray]:
    """Scores [B, W] -> per frame the hits (row, col, scale, q) f64 [N, 4]
    with q > 0, in scan order."""
    r, c, s = windows
    out = []
    for row in q.cpu().numpy():
        hit = row > 0.0
        out.append(np.stack([r[hit], c[hit], s[hit], row[hit]], 1).astype(
            np.float64).reshape(-1, 4))
    return out


def cluster(dets: np.ndarray, iou_threshold: float) -> np.ndarray:
    """ClusterDetections (core/pigo.go:262-308): ascending q (stable); each
    detection not yet taken seeds a cluster of every detection, taken or
    not, whose IoU with it exceeds the threshold; the cluster's row, col
    and scale are integer means and its q the f32 sum in that order. IoU of
    square boxes over s1^2 + s2^2 - intersection, in f64."""
    d = dets[np.argsort(dets[:, 3], kind="stable")]
    r, c, s = d[:, 0], d[:, 1], d[:, 2]
    h = s / 2.0

    def overlap(x):
        return np.maximum(0.0, np.minimum(x[:, None] + h[:, None],
                                          x[None, :] + h[None, :])
                          - np.maximum(x[:, None] - h[:, None],
                                       x[None, :] - h[None, :]))

    inter = overlap(r) * overlap(c)
    iou = inter / (s[:, None] ** 2 + s[None, :] ** 2 - inter)
    taken = np.zeros(len(d), bool)
    out = []
    for i in range(len(d)):
        if taken[i]:
            continue
        m = iou[i] > iou_threshold
        taken |= m
        n = int(m.sum())
        qs = np.float32(0.0)
        for v in d[m, 3].astype(np.float32):
            qs = np.float32(qs + v)
        out.append((int(d[m, 0].astype(np.int64).sum()) // n,
                    int(d[m, 1].astype(np.int64).sum()) // n,
                    int(d[m, 2].astype(np.int64).sum()) // n, float(qs)))
    return np.array(out, np.float64).reshape(-1, 4)


# ----------------------------------------------------------------- walks


def walk(forest: WalkForest, casc: torch.Tensor, r: torch.Tensor,
         c: torch.Tensor, s: torch.Tensor, flip: torch.Tensor,
         pix: torch.Tensor, base: torch.Tensor, *, nrows: int, ncols: int,
         acc=torch.float32, group: torch.Tensor | None = None,
         groups: int = 0):
    """The upright regression walk (core/puploc.go:106-154) of B walkers:
    cascade ids casc [B], starts r, c, s [B] in `acc`, flips bool [B],
    each reading the frame at base [B] of the flat pixels (row stride
    ncols). Returns the refined (r, c, s). With `group` [B] (ids below
    `groups`), also the distinct pixels, code words and leaves each group
    read."""
    dev = r.device
    nc, st, tr, lv, _ = forest.codes.shape
    codes = torch.as_tensor(forest.codes, device=dev).reshape(-1, 4).to(
        torch.int64)
    preds = torch.as_tensor(forest.preds, device=dev).reshape(-1, 2).to(acc)
    sign = torch.where(flip, -1, 1).to(torch.int64)[:, None]
    sign_f = sign.to(acc)
    tree = torch.arange(tr, device=dev)[None, :]
    mult = torch.tensor(forest.scale_mult, dtype=torch.float32).to(acc)
    half = torch.tensor(0.5, dtype=acc)
    seen = None
    if group is not None:  # pixels by their place in the group's frame
        seen = {"pixels": torch.zeros(groups, nrows * ncols, dtype=torch.bool,
                                      device=dev),
                "code_words": torch.zeros(groups, codes.shape[0],
                                          dtype=torch.bool, device=dev)}
        seen["leaves"] = torch.zeros_like(seen["code_words"])
        g2 = group[:, None].expand(-1, tr)
    for i in range(st):
        ri = (256 * r.to(torch.int64))[:, None]
        ci = (256 * c.to(torch.int64))[:, None]
        si = torch.where(s >= 0, torch.floor(s + half),
                         torch.ceil(s - half)).to(torch.int64)[:, None]
        node0 = ((casc.to(torch.int64) * st + i)[:, None] * tr + tree) * lv
        idx = torch.zeros_like(node0)
        for _ in range(forest.depth):
            k = codes[node0 + idx]  # [B, T, 4]
            r1 = ((ri + k[..., 0] * si) >> 8).clamp(0, nrows - 1)
            r2 = ((ri + k[..., 2] * si) >> 8).clamp(0, nrows - 1)
            c1 = ((ci + sign * k[..., 1] * si) >> 8).clamp(0, ncols - 1)
            c2 = ((ci + sign * k[..., 3] * si) >> 8).clamp(0, ncols - 1)
            a1 = base[:, None] + r1 * ncols + c1
            a2 = base[:, None] + r2 * ncols + c2
            if seen is not None:
                seen["pixels"][g2, a1 - base[:, None]] = True
                seen["pixels"][g2, a2 - base[:, None]] = True
                seen["code_words"][g2, node0 + idx] = True
            idx = 2 * idx + 1 + (pix[a1] > pix[a2]).to(torch.int64)
        leaf = node0 + idx - (lv - 1)
        if seen is not None:
            seen["leaves"][g2, leaf] = True
        p = preds[leaf]  # [B, T, 2]
        dr_t, dc_t = p[..., 0], sign_f * p[..., 1]
        dr, dc = dr_t[:, 0], dc_t[:, 0]
        for j in range(1, tr):
            dr = dr + dr_t[:, j]
            dc = dc + dc_t[:, j]
        r = r + dr * s
        c = c + dc * s
        s = s * mult
    counts = None
    if seen is not None:
        counts = {k: v.sum(1).tolist() for k, v in seen.items()}
    return r, c, s, counts


def perturb(row, col, scale, u):
    """The jittered starts (core/puploc.go:248-250) of anchors [G] from
    uniforms [G, P, 3], in the anchors' dtype."""
    dt = row.dtype
    k15, half = torch.tensor(0.15, dtype=dt), torch.tensor(0.5, dtype=dt)
    u = u.to(dt)
    row, col, scale = row[:, None], col[:, None], scale[:, None]
    return (row + (scale * k15) * (half - u[..., 0]),
            col + (scale * k15) * (half - u[..., 1]),
            scale * (torch.tensor(0.925, dtype=dt) + k15 * u[..., 2]))


def median(v: torch.Tensor) -> torch.Tensor:
    """Per group [G, P] -> [G]: the value at index round(P/2), clamped."""
    p = v.shape[1]
    return torch.sort(v, dim=1).values[:, min(int(np.floor(p / 2 + 0.5)),
                                               p - 1)]


# -------------------------------------------------------------- pipeline


@dataclasses.dataclass
class Request:
    """One answer to work out: the frame (index into the frames handed to
    `answers`) and the seed of its jitter."""

    frame: int
    seed: int


def eye_anchor(row: int, col: int, scale: int):
    """The left and right eye anchors of a face (cmd/pigo/main.go:416-458):
    offsets int(f32(k) * f32(scale)), scale / 4."""
    f = np.float32
    o_row = int(f(0.075) * f(scale))
    o_l, o_r = int(f(0.175) * f(scale)), int(f(0.185) * f(scale))
    es = float(scale) * 0.25
    return [(row - o_row, col - o_l, es), (row - o_row, col + o_r, es)]


def landmark_anchors(er, ec):
    """Landmark anchors (row, col, scale) [F] from the eyes' medians
    [2F] (left, right per face), truncated first (core/flploc.go:37-43), in
    the medians' dtype."""
    dt = er.dtype
    k = (lambda v: torch.tensor(v, dtype=dt))
    ler, lec = torch.trunc(er[0::2]), torch.trunc(ec[0::2])
    rer, rec = torch.trunc(er[1::2]), torch.trunc(ec[1::2])
    d, e = ler - rer, lec - rec
    dist = torch.sqrt(d * d + e * e)
    return (torch.trunc((ler + rer) / k(2.0) + k(0.25) * dist),
            torch.trunc((lec + rec) / k(2.0) + k(0.15) * dist),
            k(3.0) * dist)


class Pipeline:
    """The reference detector for one parameter set: faces, pupils and
    landmark points of frames, for given requests."""

    def __init__(self, face: FaceForest, pupil: WalkForest,
                 landmarks: WalkForest, landmark_names: list[str], *,
                 min_size, max_size, shift_factor, scale_factor,
                 iou_threshold, acc=torch.float32, device="cpu"):
        self.face, self.pupil, self.landmarks = face, pupil, landmarks
        self.cfg = (min_size, max_size, shift_factor, scale_factor)
        self.iou = iou_threshold
        self.acc = acc
        self.device = torch.device(device)
        ids = {n: i for i, n in enumerate(landmark_names)}
        self.point_casc = [ids[n] for n, _ in POINTS]
        self.point_flip = [f for _, f in POINTS]

    def faces(self, frames: np.ndarray, work: bool = False,
              block_windows: int = 1 << 23):
        """Faces of frames uint8 [N, rows, cols]: per frame the clusters
        (row, col, scale, q) with q > Q_THRESH in cluster order, and with
        `work` per frame the face stage's counts and the clustering's hits
        and clusters."""
        n, rows, cols = frames.shape
        windows = pyramid(rows, cols, *self.cfg)
        per = max(1, block_windows // max(1, windows[0].size))
        faces, counts = [], []
        for lo in range(0, n, per):
            block = torch.as_tensor(frames[lo:lo + per], device=self.device)
            q, wk = face_scores(block, self.face, windows, acc=self.acc,
                                work=work)
            for k, hits in enumerate(face_hits(q, windows)):
                cl = cluster(hits, self.iou)
                faces.append([tuple(f) for f in cl if f[3] > Q_THRESH])
                if work:
                    counts.append(dict(wk[k], hits=len(hits),
                                       clusters=len(cl)))
        return faces, counts

    def answers(self, frames: np.ndarray, requests: list[Request],
                faces=None, work: bool = False, block_requests: int = 16):
        """Each request's answer: per face (row, col, scale, q, eyes, points),
        eyes and points as (row, col, scale) tuples after the reference's
        gates (cmd/pigo/main.go:422-470). `faces` (from `faces`) saves
        working them out again. With `work`, also per request the walks'
        counts ({"eyes": ..., "landmarks": ...}, None for a request with
        no eyed face)."""
        if faces is None:
            used = sorted({q.frame for q in requests})
            got, _ = self.faces(frames[used])
            faces = dict(zip(used, got))
        out, counts = [], []
        for lo in range(0, len(requests), block_requests):
            a, w = self._post(frames, requests[lo:lo + block_requests],
                              faces, work)
            out += a
            counts += w
        return (out, counts) if work else out

    def _post(self, frames, requests, faces, work):
        """Eyes and landmark points of a block of requests, in one walk of
        each forest over all their walkers."""
        _, rows, cols = frames.shape
        dev, acc, p = self.device, self.acc, PERTURBS
        used = sorted({q.frame for q in requests})
        slot = {f: k for k, f in enumerate(used)}
        pix = torch.as_tensor(frames[used], device=dev).reshape(-1)
        eyes, lmk = [], []  # per request: (anchor rows, uniforms) pieces
        for q in requests:
            eyed = [f for f in faces[q.frame] if f[2] > MIN_EYE_FACE_SCALE]
            if not eyed:
                eyes.append(None)
                lmk.append(None)
                continue
            g = torch.Generator().manual_seed(q.seed)
            ue = torch.rand((2 * len(eyed), p, 3), generator=g,
                            dtype=torch.float32)
            ul = torch.rand((len(POINTS) * len(eyed), p, 3), generator=g,
                            dtype=torch.float32)
            anchors = [a for f in eyed for a in eye_anchor(*(
                int(v) for v in f[:3]))]
            eyes.append((np.array(anchors, np.float32), ue))
            lmk.append(ul)
        live = [k for k, e in enumerate(eyes) if e is not None]
        answers = [[(f[0], f[1], f[2], f[3], (), ()) for f in faces[q.frame]]
                   for q in requests]
        counts = [None] * len(requests)
        if not live:
            return answers, counts
        base_of = [slot[requests[k].frame] * rows * cols for k in live]
        # eyes: 2F anchors a request, P walkers each
        na = [len(eyes[k][0]) for k in live]
        anc = torch.as_tensor(np.concatenate([eyes[k][0] for k in live]),
                              device=dev).to(acc)
        u = torch.cat([eyes[k][1] for k in live]).to(dev)
        gid = torch.repeat_interleave(torch.arange(len(live), device=dev),
                                      torch.tensor(na, device=dev))
        r0, c0, s0 = perturb(anc[:, 0], anc[:, 1], anc[:, 2], u)
        base = torch.tensor(base_of, device=dev)[gid]
        r, c, s, ew = walk(
            self.pupil, torch.zeros(r0.numel(), dtype=torch.int64,
                                    device=dev),
            r0.reshape(-1), c0.reshape(-1), s0.reshape(-1),
            torch.zeros(r0.numel(), dtype=torch.bool, device=dev), pix,
            base.repeat_interleave(p), nrows=rows, ncols=cols, acc=acc,
            group=gid.repeat_interleave(p) if work else None,
            groups=len(live))
        em = [median(v.reshape(-1, p)) for v in (r, c, s)]
        # landmarks: 15 points a face, anchored on the face's eyes
        ar, ac, asc = landmark_anchors(em[0], em[1])
        npt = len(POINTS)
        nf = torch.tensor(na, device=dev) // 2
        ul = torch.cat([lmk[k] for k in live]).to(dev)
        fid = torch.repeat_interleave(torch.arange(len(live), device=dev), nf)
        pts = torch.arange(npt, device=dev).repeat(int(nf.sum()))
        face_of = torch.arange(int(nf.sum()), device=dev).repeat_interleave(
            npt)
        lr0, lc0, ls0 = perturb(ar[face_of], ac[face_of], asc[face_of], ul)
        lgid = fid.repeat_interleave(npt)
        lr, lc, ls, lw = walk(
            self.landmarks,
            torch.tensor(self.point_casc, device=dev)[pts].repeat_interleave(
                p),
            lr0.reshape(-1), lc0.reshape(-1), ls0.reshape(-1),
            torch.tensor(self.point_flip, device=dev)[pts].repeat_interleave(
                p), pix, torch.tensor(base_of, device=dev)[lgid]
            .repeat_interleave(p), nrows=rows, ncols=cols, acc=acc,
            group=lgid.repeat_interleave(p) if work else None,
            groups=len(live))
        lm = [median(v.reshape(-1, p)) for v in (lr, lc, ls)]
        em = [v.to(torch.float32).cpu().numpy() for v in em]
        lm = [v.to(torch.float32).cpu().numpy() for v in lm]
        e_at = f_at = 0
        for j, k in enumerate(live):
            out = []
            eyed_seen = 0
            for f in faces[requests[k].frame]:
                if f[2] <= MIN_EYE_FACE_SCALE:
                    out.append((f[0], f[1], f[2], f[3], (), ()))
                    continue
                pair = [(int(em[0][e_at + h]), int(em[1][e_at + h]),
                         float(em[2][e_at + h])) for h in (0, 1)]
                e_at += 2
                pts_f = [(int(lm[0][f_at * npt + m]),
                          int(lm[1][f_at * npt + m]),
                          float(lm[2][f_at * npt + m])) for m in range(npt)]
                f_at += 1
                eyed_seen += 1
                ok = [e for e in pair if e[0] > 0 and e[1] > 0]
                pts_ok = (tuple(x for x in pts_f if x[0] > 0 and x[1] > 0)
                          if len(ok) == 2 else ())
                out.append((f[0], f[1], f[2], f[3], tuple(ok), pts_ok))
            answers[k] = out
            if work:
                counts[k] = {
                    "eyes": dict(walkers=na[j] * p,
                                 **{n: v[j] for n, v in ew.items()}),
                    "landmarks": dict(walkers=na[j] // 2 * npt * p,
                                      **{n: v[j] for n, v in lw.items()})}
        return answers, counts
