"""The walk kernel's card layout of the pupil/landmark codes, on the CPU.

csrc/pupil_walk.cu reads the codes that convert.card_codes stores one code
word into their buffer: from the word before them, node k of each tree is
at 1-based slot k + 1, so the children of 1-based node j (0-based
2j - 1 and 2j) are one aligned 8-byte word at slot 2j, and the two leaves
a last-level node j can reach, (2j, 2j + 1) - L, are one aligned 16-byte
pair of the preds. Each level loads the children's pair beside its
pixels, the last level the leaf pair. A CUDA kernel cannot run here, so
these tests check that layout on the shipped cascades (the puploc and one
lps cascade), and hold `layout_walk`, a torch walk that reads the way the
kernel does, bit for bit against the plain walk (ops/pupil_dense.walk),
upright and rotated, with flips. The kernel itself is held against the
plain walk on the card (tests/test_torch_cuda.py, chip_smoke.py).

The kernel's ensemble mode votes each group's median by counting, for
each walker's value, the values that sort before it as unsigned keys;
`rank_vote`, that vote in torch, is held against pupil_dense.median_vote.
Every kernel the source defines keeps `pupil_walk_kernel` in its name,
which the benchmark's roofline of kernel C reads.
"""

import os
import re

import numpy as np
import pytest
import torch

from pigo_tpu_torch.cascade import assets
from pigo_tpu_torch.convert import card_codes, pupil_forest_from_numpy
from pigo_tpu_torch.ops import pupil_dense
from test_torch_face_kernel import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def forest(which: str, stacked: bool = False):
    """The shipped puploc, or the first lps cascade (every lps cascade,
    stacked as the detector has them, with `stacked`), as port tensors."""
    if which == "puploc":
        fs = [assets.load_puploc()]
    else:
        lps = assets.load_landmark_dir()
        fs = [lps[n] for n in sorted(lps)][:None if stacked else 1]
    return pupil_forest_from_numpy(
        np.stack([f.codes for f in fs]), np.stack([f.preds for f in fs]),
        stages=fs[0].stages, trees=fs[0].trees, depth=fs[0].depth,
        scale_mult=fs[0].scale_mult)


def one_based_words(card: torch.Tensor) -> torch.Tensor:
    """The card copy read from the word before it, as the kernel does:
    int32 words [1 + NC*S*T*L], word k + 1 of a tree its 0-based node k."""
    start = card.storage_offset() - 4
    return torch.as_strided(card, (card.numel() + 4,), (1,),
                            start).view(torch.int32)


@pytest.mark.parametrize("which", ["puploc", "lps"])
def test_card_codes_pair_children_and_leaves(which):
    """For every internal node of every tree, the aligned 8-byte word at
    1-based slot 2j holds its two children's code words (left, right); for
    every last-level node, the aligned 16-byte pair at (2j - L) / 2 holds
    the two leaves the plain walk reaches from it."""
    t = forest(which)
    codes, preds = t.codes, t.preds
    card = card_codes(codes, "cpu")
    assert card.shape == codes.shape and torch.equal(card, codes)
    assert card.storage_offset() == 4 and card.data_ptr() % 8 == 4
    leaves = codes.shape[3]
    n_trees = codes.numel() // (4 * leaves)
    plain = codes.reshape(n_trees, leaves, 4).contiguous().view(
        torch.int32)[..., 0]  # [N, L] 0-based code words
    words = one_based_words(card)
    assert torch.equal(words[1:], plain.reshape(-1))
    pairs = words[:n_trees * leaves].reshape(n_trees, leaves // 2, 2)
    i = torch.arange(leaves // 2 - 1)  # 0-based internal nodes above leaves
    j = i + 1  # 1-based
    assert torch.equal(pairs[:, j, 0], plain[:, 2 * i + 1])
    assert torch.equal(pairs[:, j, 1], plain[:, 2 * i + 2])
    # the last level: 0-based nodes i in [L/2 - 1, L - 1) reach leaves
    # (2i + 1 + bit) - (L - 1); the kernel reads pair j - L/2 of float4
    flat = preds.reshape(n_trees, leaves, 2)
    quads = preds.reshape(n_trees, leaves // 2, 4)
    i = torch.arange(leaves // 2 - 1, leaves - 1)
    j = i + 1
    for bit in (0, 1):
        assert torch.equal(quads[:, j - leaves // 2, 2 * bit:2 * bit + 2],
                           flat[:, 2 * i + 1 + bit - (leaves - 1)])


def layout_walk(card, preds, casc_id, r0, c0, s0, col_sign, pixels, *,
                nrows, ncols, dim, scale_mult, rotated=False, angle_idx=0):
    """The walk as csrc/pupil_walk.cu reads it: the root of each tree from
    1-based slot 1, each level's children as the pair at slot 2j beside
    the level's pixels, the last level's two leaves as one 16-byte pair,
    and the leaves summed in tree order over a compile-time 32 trees, tree
    t added when t < T."""
    nc, stages, trees, leaves, _ = card.shape
    depth = leaves.bit_length() - 1
    words = one_based_words(card)
    quads = preds.reshape(-1, 4)
    i32 = torch.int32

    def unpack(w):
        return w.contiguous().view(torch.int8).reshape(*w.shape, 4).to(i32)

    cs = col_sign.to(i32)[:, None]
    sign = col_sign.to(torch.float32)[:, None]
    smul = pupil_dense.f32_scalar(scale_mult)
    qsin_v = pupil_dense.f32_scalar(pupil_dense.QSIN_TABLE[angle_idx])
    qcos_v = pupil_dense.f32_scalar(pupil_dense.QCOS_TABLE[angle_idx])
    lane = torch.arange(trees, dtype=torch.int64)[None, :]
    tree = casc_id.to(torch.int64)[:, None] * (stages * trees * leaves) \
        + lane * leaves  # [B, T] the lanes' trees in stage 0
    r, c, s = r0, c0, s0
    for _ in range(stages):
        if rotated:
            qsin = (s * qsin_v).to(i32)[:, None]
            qcos = (s * qcos_v).to(i32)[:, None]
            ri = (65536 * r.to(i32))[:, None]
            ci = (65536 * c.to(i32))[:, None]
        else:
            ri = (256 * r.to(i32))[:, None]
            ci = (256 * c.to(i32))[:, None]
            si = pupil_dense.round_away(s).to(i32)[:, None]

        def bintest(code):
            k0, k1, k2, k3 = unpack(code).unbind(-1)
            if rotated:
                col1, col2 = cs * k1, cs * k3
                r1 = torch.clamp(torch.clamp(ri + qcos * k0 - qsin * col1,
                                             min=0) >> 16, 0, nrows - 1)
                c1 = torch.clamp(torch.clamp(ci + qsin * k0 + qcos * col1,
                                             min=0) >> 16, 0, ncols - 1)
                r2 = torch.clamp(torch.clamp(ri + qcos * k2 - qsin * col2,
                                             min=0) >> 16, 0, nrows - 1)
                c2 = torch.clamp(torch.clamp(ci + qsin * k2 + qcos * col2,
                                             min=0) >> 16, 0, ncols - 1)
            else:
                r1 = torch.clamp((ri + k0 * si) >> 8, 0, nrows - 1)
                r2 = torch.clamp((ri + k2 * si) >> 8, 0, nrows - 1)
                c1 = torch.clamp((ci + cs * k1 * si) >> 8, 0, ncols - 1)
                c2 = torch.clamp((ci + cs * k3 * si) >> 8, 0, ncols - 1)
            p1 = pixels[(r1 * dim + c1).to(torch.int64)]
            p2 = pixels[(r2 * dim + c2).to(torch.int64)]
            return (p1 <= p2) if rotated else (p1 > p2)

        code, j = words[tree + 1], torch.ones_like(tree)
        for _ in range(depth - 1):
            kids = words[(tree + 2 * j)[..., None] + torch.arange(2)]
            bit = bintest(code).to(torch.int64)
            j = 2 * j + bit
            code = torch.gather(kids, 2, bit[..., None])[..., 0]
        pair = quads[tree // 2 + j - leaves // 2]  # [B, T, 4]
        bit = bintest(code)
        dr_t = torch.where(bit, pair[..., 2], pair[..., 0])
        dc_t = sign * torch.where(bit, pair[..., 3], pair[..., 1])
        dr, dc = dr_t[:, 0], dc_t[:, 0]
        for t in range(1, 32):
            if t < trees:
                dr = dr + dr_t[:, t]
                dc = dc + dc_t[:, t]
        r = r + dr * s
        c = c + dc * s
        s = s * smul
        tree = tree + trees * leaves
    return r, c, s


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("which", ["puploc", "lps"])
def test_layout_walk_matches_plain_walk(which, rotated):
    """Seeded walkers (random cascade ids, starts and flips) over the
    sample frame: the walk read through the card layout equals
    pupil_dense.walk on (r, c, s), bit for bit."""
    t = forest(which, stacked=True)
    gray = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                "sample_gray.npy"))
    pix = torch.from_numpy(gray.reshape(-1))
    rng = np.random.default_rng(7 + rotated)
    n = 150
    starts = [torch.from_numpy(a) for a in (
        rng.integers(0, t.codes.shape[0], n).astype(np.int32),
        rng.uniform(0, 400, n).astype(np.float32),
        rng.uniform(0, 320, n).astype(np.float32),
        rng.uniform(8, 300, n).astype(np.float32),
        np.where(rng.random(n) < 0.5, -1, 1).astype(np.int32))]
    kw = dict(nrows=400, ncols=320, dim=320, scale_mult=t.scale_mult,
              rotated=rotated, angle_idx=8 if rotated else 0)
    got = layout_walk(card_codes(t.codes, "cpu"), t.preds, *starts, pix,
                      **kw)
    want = pupil_dense.walk(t.codes, t.preds, *starts, pix, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(want[0], starts[1])  # the walk moved


def order_keys(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 keys in torch.sort's order (the kernel's order_key):
    -0.0 taken as +0.0, then negative floats' bits inverted, others' sign
    bit set."""
    v = torch.where(v == 0.0, 0.0, v).contiguous()
    b = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)


def rank_vote(v: torch.Tensor, perturbs: int) -> torch.Tensor:
    """The kernel's vote over the last axis of v [G, P]: the value with
    exactly median_index(P) values before it in key order, ties broken by
    walker index."""
    k = order_keys(v)
    j = torch.arange(perturbs)
    below = ((k[:, None, :] < k[:, :, None])
             | ((k[:, None, :] == k[:, :, None])
                & (j[None, None, :] < j[None, :, None]))).sum(-1)
    pick = below == pupil_dense.median_index(perturbs)
    assert bool((pick.sum(-1) == 1).all())
    return v[pick]


@pytest.mark.parametrize("perturbs", [1, 2, 15, 63, 100])
def test_rank_vote_matches_median_vote(perturbs):
    """Seeded groups with ties, negatives and zeros: the rank-counting
    vote selects the value pupil_dense.median_vote's sort does, bit for
    bit. -0.0 and +0.0 share a key, as in the card's sort (the CPU's
    orders a mix of them otherwise, so the groups hold +0.0 alone; the
    card tests hold mixed zeros to the card's sort)."""
    rng = np.random.default_rng(perturbs)
    g = 40
    v = rng.normal(0, 50, (g, perturbs)).astype(np.float32)
    # many ties and zeros (+ 0.0 turns -0.0 into +0.0)
    v[: g // 2] = np.round(v[: g // 2] / 16) + np.float32(0.0)
    v[g // 2: 3 * g // 4, ::3] = 0.0
    v = torch.from_numpy(v)
    want = pupil_dense.median_vote(v, v, v, perturbs)[0]
    assert torch.equal(rank_vote(v, perturbs).view(torch.int32),
                       want.view(torch.int32))
    keys = order_keys(torch.tensor([0.0, -0.0, -1.0, 1.0, -2.0]))
    assert keys[0] == keys[1] and keys[4] < keys[2] < keys[0] < keys[3]


def test_every_walk_kernel_keeps_its_name():
    """Each __global__ kernel of csrc/pupil_walk.cu (the plain walk and
    the ensemble) is named with pupil_walk_kernel: the benchmark finds
    kernel C's launches in a device trace by that key."""
    with open(os.path.join(ROOT, "pigo_tpu_torch", "csrc",
                           "pupil_walk.cu")) as fh:
        src = fh.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s*)?(\w+)\(", src)
    assert sorted(names) == ["pupil_walk_kernel",
                             "pupil_walk_kernel_ensemble"]
