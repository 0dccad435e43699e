"""What decides `correct`: the program's answers against the reference's.

Every answer of the window has its faces (row, col, scale, q) held to the
reference's faces of its frame, exactly; a sample of the window's answers,
drawn from the seed and holding the answer with the most faces, also has
its eyes and landmark points held to the reference's, worked out with the
request's own jitter. Each number compared has the limit 0: the
configuration states bit-equal results.
"""

from __future__ import annotations

import sys

import numpy as np

from pigobench.reference import pico

LIMITS = {"answers_missing": 0, "faces_wrong": 0, "points_wrong": 0}


def faces_of(results) -> tuple:
    """The program's answer -> ((row, col, scale, q), ...)."""
    return tuple((r.face.row, r.face.col, r.face.scale, r.face.q)
                 for r in results)


def full_of(results) -> list:
    """The program's answer -> [(row, col, scale, q, eyes, points)]."""
    return [(r.face.row, r.face.col, r.face.scale, float(r.face.q),
             tuple((e.row, e.col, float(e.scale)) for e in r.eyes),
             tuple((p.row, p.col, float(p.scale)) for p in r.landmarks))
            for r in results]


def normal(answer) -> list:
    """A reference answer in full_of's types."""
    return [(int(f[0]), int(f[1]), int(f[2]), float(f[3]), f[4], f[5])
            for f in answer]


class Keep:
    """Which request indices keep their whole answer for the sampled
    check: a share of them, drawn from the seed block by block."""

    BLOCK = 4096

    def __init__(self, seed: int, share: float):
        self.seed, self.share = seed, share
        self._blocks: dict[int, np.ndarray] = {}

    def __call__(self, i: int) -> bool:
        b = i // self.BLOCK
        mask = self._blocks.get(b)
        if mask is None:
            mask = np.random.default_rng([self.seed, 1, b]).random(
                self.BLOCK) < self.share
            self._blocks[b] = mask
        return bool(mask[i % self.BLOCK])


def sample(seed: int, kept: dict, n: int) -> list[int]:
    """n of the kept request indices drawn from the seed, with the one
    whose answer holds the most faces (the longest) among them."""
    idx = sorted(kept)
    if not idx:
        return []
    longest = max(idx, key=lambda i: (len(kept[i]), -i))
    rng = np.random.default_rng([seed, 2])
    pick = set(rng.choice(idx, min(n, len(idx)), replace=False).tolist())
    pick.add(longest)
    return sorted(pick)


def compare(ref_faces: dict, window: list, kept: dict, checked: list[int],
            ref_answers: list, order, missing: int) -> dict:
    """The numbers compared: answers missing, window answers whose faces
    differ from their frame's (ref_faces: pool frame -> faces), and sampled
    answers whose eyes or points (or faces) differ. `window` holds (index,
    faces_of answer)."""
    want = {k: tuple((int(f[0]), int(f[1]), int(f[2]), float(f[3]))
                     for f in fs) for k, fs in ref_faces.items()}
    faces_wrong = sum(got != want[order[i]] for i, got in window)
    points_wrong = sum(full_of(kept[i]) != normal(a)
                       for i, a in zip(checked, ref_answers))
    return {"answers_missing": missing, "faces_wrong": faces_wrong,
            "points_wrong": points_wrong}


def report(numbers: dict) -> dict:
    """Print each number beside its limit on stderr; return the result
    line's `checks` entry."""
    out = {}
    for name, value in numbers.items():
        print(f"check {name} {value} limit {LIMITS[name]}", file=sys.stderr)
        out[name] = {"value": value, "limit": LIMITS[name]}
    return out


def passed(numbers: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in numbers.items())


def requests(seed: int, order, indices: list[int]) -> list:
    """The reference's requests for request indices: the pool frame and
    the jitter seed of each."""
    return [pico.Request(order[i], seed + i) for i in indices]
