"""The frames a cell sends: a fixed pool, served in an order drawn from the seed.

A configuration names the source image and the frame shape; the traffic
mix names how many distinct frames its pool holds and how they differ
from the source: a roll of up to `roll_rows` rows either way and of any
column (the sample tiles seamlessly across columns, so every face stays
whole), then noise of up to `noise` grey levels either way. The pool is
drawn from the mix's own `pool_seed`, so every run serves the same set of
frames and the same work; `--seed` draws the order, a new permutation of
the pool on each pass, and each request's jitter (request i draws from
seed + i, as the program's engines do).
"""

from __future__ import annotations

import os

import numpy as np


def source_frame(root: str, config: dict) -> np.ndarray:
    """The configuration's image, tiled to its frame shape, uint8
    [rows, cols]."""
    img = np.load(os.path.join(root, config["image"]))
    rows, cols = config["frame"]
    reps = (-(-rows // img.shape[0]), -(-cols // img.shape[1]))
    return np.ascontiguousarray(np.tile(img, reps)[:rows, :cols])


def make_pool(root: str, config: dict, pool: dict) -> np.ndarray:
    """The pool, uint8 [frames, rows, cols]."""
    src = source_frame(root, config).astype(np.int16)
    rows, cols = src.shape
    out = np.empty((pool["frames"], rows, cols), np.uint8)
    for k in range(pool["frames"]):
        rng = np.random.default_rng([pool["pool_seed"], k])
        dr = int(rng.integers(-pool["roll_rows"], pool["roll_rows"] + 1))
        dc = int(rng.integers(0, cols))
        f = np.roll(src, (dr, dc), (0, 1))
        n = pool["noise"]
        if n:
            f = f + rng.integers(-n, n + 1, f.shape, dtype=np.int16)
        out[k] = np.clip(f, 0, 255)
    return out


class Order:
    """Which pool frame request i gets: pass i // K of the pool is a
    permutation drawn from (seed, pass)."""

    def __init__(self, seed: int, frames: int):
        self.seed, self.k = seed, frames
        self._perms: dict[int, np.ndarray] = {}

    def __getitem__(self, i: int) -> int:
        p = i // self.k
        perm = self._perms.get(p)
        if perm is None:
            perm = np.random.default_rng([self.seed, p]).permutation(self.k)
            self._perms[p] = perm
        return int(perm[i % self.k])
