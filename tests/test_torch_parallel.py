"""Multi-GPU detection of the port (pigo_tpu_torch.parallel) on the CPU.

Window sharding: every rank's band of an n-rank mesh (n = 1, 2, 3, 8),
run in one process with device="cpu" (the kernels' plain versions) and
merged, equals the single-device FaceCascade.sparse_hits bit for bit, on
the two-face frame of tests/test_parallel.py at its CFG and on the sample
frame at the golden corpus's configuration, upright and at angle 0.07, in
the default, tree-prefix and host-tail routings; and equals the JAX
package's ShardedFaceCascade on its 8-device virtual mesh. A hit capacity
of 1 forces the exact re-read. Frame data parallelism equals per-frame
results. `band_cut` partitions a routed plan. Two processes joined over
gloo (this file run as a script, one per rank) agree with each other and
with sparse_hits. Exact equality is the tolerance throughout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pigo_tpu_torch import FaceCascade
from pigo_tpu_torch.ops import face_cuda
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.ops.windows import build_window_plan
from pigo_tpu_torch.parallel import (Mesh, ShardedFaceCascade,
                                     init_distributed, make_mesh)
from pigo_tpu_torch.parallel.sharded import band_cut

if __name__ != "__main__":  # a worker rank needs no JAX test helpers
    from test_torch_face_kernel import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_parallel.py's configuration for its two-face frame, and the
# golden corpus's for the sample frame (tests/golden/sample.json)
CFG = dict(min_size=20, max_size=100, shift_factor=0.1, scale_factor=1.3)
REF = dict(min_size=20, max_size=1000, shift_factor=0.2, scale_factor=1.1)
MODES = {"default": {}, "prefix": {"prefix": True},
         "host_tail": {"host_tail": True}}


def tiny_faces_frame() -> np.ndarray:
    """tests/test_parallel.py's frame: the sample, resized to 18x22 with
    Pillow, pasted twice into a flat 96x88 frame."""
    from PIL import Image

    gray = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                "sample_gray.npy"))
    tiny = np.asarray(Image.fromarray(gray).resize((18, 22)), np.uint8)
    frame = np.full((96, 88), 200, np.uint8)
    for r0, c0 in ((12, 14), (58, 52)):
        frame[r0:r0 + 22, c0:c0 + 18] = tiny
    return frame


@pytest.fixture(scope="module")
def frames(sample_gray):
    return {"tiny": (tiny_faces_frame(), CFG), "sample": (sample_gray, REF)}


@pytest.fixture(scope="module")
def cascades():
    return {mode: FaceCascade(device="cpu", **kw)
            for mode, kw in MODES.items()}


@pytest.fixture(scope="module")
def singles(cascades, frames):
    """FaceCascade.sparse_hits of each (mode, frame, angle), computed once."""
    cache = {}

    def get(mode, name, angle):
        key = (mode, name, angle)
        if key not in cache:
            frame, cfg = frames[name]
            cache[key] = cascades[mode].sparse_hits(
                frame, *frame.shape, angle=angle, **cfg)
        return cache[key]

    return get


def local_mesh(size=1):
    """A mesh of this process alone; size > 1 only for argument checks
    that raise before any collective."""
    return Mesh("window", size, 0, torch.device("cpu"))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name,angle", [("tiny", 0.0), ("sample", 0.0),
                                        ("sample", 0.07)])
def test_bands_merged_equal_sparse_hits(cascades, frames, singles, name,
                                        angle, mode, n):
    """Every band of an n-rank mesh, run here and merged, equals
    sparse_hits bit for bit (row, col, scale, f32 q)."""
    frame, cfg = frames[name]
    want = singles(mode, name, angle)
    assert want.shape[0] >= 2
    sh = ShardedFaceCascade(local_mesh(), cascades[mode])
    got = sh.window_bands_hits(frame, *frame.shape, n, angle=angle, **cfg)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_window_sharded_hits_on_one_process(cascades, frames, singles):
    """window_sharded_hits on a mesh of this process alone (no
    collective) and detect, which clusters its hits."""
    frame, cfg = frames["sample"]
    sh = ShardedFaceCascade(make_mesh(1, device="cpu"), cascades["default"])
    want = singles("default", "sample", 0.0)
    assert np.array_equal(sh.window_sharded_hits(frame, *frame.shape, **cfg),
                          want)
    for iou in (0.1, 0.2):
        assert np.array_equal(
            sh.detect(frame, *frame.shape, iou_threshold=iou, **cfg),
            cluster_detections(want, iou))


@pytest.mark.parametrize("mode", ["default", "prefix"])
def test_hit_capacity_one_rereads_exactly(cascades, frames, singles, mode):
    """A rank's list of 1 overflows on the sample's hits: the exact dense
    re-read gives sparse_hits, with 1 band and with 3."""
    frame, cfg = frames["sample"]
    sh = ShardedFaceCascade(local_mesh(), cascades[mode], hit_capacity=1)
    want = singles(mode, "sample", 0.0)
    for n in (1, 3):
        assert np.array_equal(
            sh.window_bands_hits(frame, *frame.shape, n, **cfg), want)


@pytest.mark.parametrize("kw", [dict(prefix=True),
                                dict(prefix=False, tree_cap=32,
                                     host_tail=True)])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_band_cut_partitions_the_plan(kw, n):
    """The bands of n ranks hold every launched window once, each cut in
    its segment's kernel and tree limit, and a band's finish range holds
    exactly its windows inside the plan's finish range (here tree-capped
    dense segments around host scales, and prefix ones)."""
    plan = build_window_plan(400, 320, **REF)
    routed = face_cuda.route_plan(plan, 468, **kw)
    assert routed.finish is not None
    launched = np.concatenate([np.arange(s.lo, s.hi)
                               for s in routed.segments])
    seen = []
    for rank in range(n):
        band = band_cut(routed, rank, n)
        assert [s.lo for s in band.segments] == sorted(
            s.lo for s in band.segments)
        pos = 0
        for s in band.segments:
            assert s.lo == pos and s.hi > s.lo
            glob = band.index[s.lo:s.hi]
            owner = [g for g in routed.segments
                     if g.lo <= glob[0] and glob[-1] < g.hi]
            assert len(owner) == 1 and np.array_equal(
                glob, np.arange(glob[0], glob[-1] + 1))
            assert (owner[0].prefix, owner[0].t_limit) == (s.prefix,
                                                           s.t_limit)
            pos = s.hi
        assert pos == band.index.size
        lo, hi = routed.finish
        inside = np.flatnonzero((band.index >= lo) & (band.index < hi))
        assert band.finish == (inside[0], inside[-1] + 1)
        assert inside.size == inside[-1] + 1 - inside[0]
        seen.append(band.index)
    seen = np.concatenate(seen)
    assert np.array_equal(np.sort(seen), np.sort(launched))
    with pytest.raises(ValueError, match="outside a mesh"):
        band_cut(routed, n, n)


def test_batch_hits_equal_per_frame(cascades, frames):
    """Frame data parallelism on one process: every frame's hits equal
    sparse_hits, and the total is the sum of the raw counts."""
    frame, cfg = frames["tiny"]
    fc = cascades["default"]
    batch = np.stack([np.roll(frame, i, axis=1) for i in range(8)])
    sh = ShardedFaceCascade(local_mesh(), fc)
    dets, total = sh.batch_hits(batch, *frame.shape, **cfg)
    wants = [fc.sparse_hits(f, *frame.shape, **cfg) for f in batch]
    assert len(dets) == 8
    assert all(np.array_equal(d, w) for d, w in zip(dets, wants))
    assert total == sum(w.shape[0] for w in wants) >= 8


def test_batch_hits_host_tail_and_overflow(frames, monkeypatch):
    """batch_hits with the host tail merges every frame's host scales, and
    a packed list of 1 re-reads each frame exactly."""
    frame, cfg = frames["sample"]
    monkeypatch.setattr(FaceCascade, "HIT_CAPACITY", 1)
    batch = np.stack([np.roll(frame, 3 * i, axis=1) for i in range(2)])
    for kw in ({"host_tail": True}, {}):
        fc = FaceCascade(device="cpu", **kw)
        dets, _ = ShardedFaceCascade(local_mesh(), fc).batch_hits(
            batch, *frame.shape, **cfg)
        for d, f in zip(dets, batch):
            assert np.array_equal(d, fc.sparse_hits(f, *frame.shape, **cfg))
            assert d.shape[0] >= 2


def test_batch_not_divisible_raises(cascades, frames):
    frame, cfg = frames["tiny"]
    sh = ShardedFaceCascade(local_mesh(2), cascades["default"])
    batch = np.broadcast_to(frame, (3, *frame.shape))
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh "
                                         "size 2"):
        sh.batch_hits(batch, *frame.shape, **cfg)


def test_matches_jax_sharded_on_eight_devices(cascades, frames,
                                              monkeypatch):
    """The two-face frame: the port's 8 bands (default routing and the
    host tail at the same tail cutoff) equal the JAX package's
    ShardedFaceCascade on its 8-device virtual mesh, with its tail cutoff
    lowered to 512 windows as tests/test_parallel.py lowers it."""
    import jax

    from pigo_tpu.cascade.assets import asset_path
    from pigo_tpu.models.face import FaceCascade as JaxFaceCascade
    from pigo_tpu.ops import face_pallas
    from pigo_tpu.parallel import ShardedFaceCascade as JaxSharded
    from pigo_tpu.parallel import make_mesh as jax_make_mesh

    assert len(jax.devices()) >= 8
    monkeypatch.setattr(face_pallas, "TAIL_MIN_WINDOWS", 512)
    monkeypatch.setattr(face_cuda, "TAIL_MIN_WINDOWS", 512)
    frame, cfg = frames["tiny"]
    with open(asset_path("cascade", "facefinder"), "rb") as fh:
        jfc = JaxFaceCascade.from_bytes(fh.read())
    want = JaxSharded(jax_make_mesh(8, "window"), jfc).window_sharded_hits(
        frame, *frame.shape, **cfg)
    assert want.shape[0] >= 2
    for fc in (cascades["default"], FaceCascade(device="cpu",
                                                host_tail=True)):
        got = ShardedFaceCascade(local_mesh(), fc).window_bands_hits(
            frame, *frame.shape, 8, **cfg)
        assert np.array_equal(got, want)


def test_init_distributed_without_arguments_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == 1
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)


def test_nccl_request_without_cuda_raises():
    """An explicit request that cannot be met raises before joining: NCCL
    on the CPU, and a card (NCCL's default) on a machine without one."""
    with pytest.raises(RuntimeError, match="NCCL needs a card"):
        init_distributed("127.0.0.1:1", 1, 0, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="num_processes"):
        init_distributed("127.0.0.1:1", device="cpu")
    assert not torch.distributed.is_initialized()


# ----------------------------------------------------------- two processes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(join: str, frames_path: str, port: int = 0, rank: int = 0,
            world: int = 2) -> int:
    """One rank of the multi-process run: joins over gloo, explicitly
    (`join` "explicit": coordinator, world size, rank) or from torchrun's
    environment ("env"), and prints one JSON line of its results."""
    torch.set_num_threads(1)
    batch = np.load(frames_path)
    sample = np.load(os.path.join(ROOT, "pigo_tpu_torch", "assets",
                                  "sample_gray.npy"))
    fc = FaceCascade(device="cpu")
    if join == "explicit":
        got = init_distributed(f"127.0.0.1:{port}", world, rank,
                               device="cpu")
    else:
        got = init_distributed(device="cpu")
        world = int(os.environ["WORLD_SIZE"])
    assert got == world == torch.distributed.get_world_size()
    mesh = make_mesh()
    sh = ShardedFaceCascade(mesh, fc)
    torch.distributed.barrier()
    out = {
        "rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
        "window": sh.window_sharded_hits(sample, *sample.shape,
                                         **REF).tolist(),
        "window_rotated": sh.window_sharded_hits(
            sample, *sample.shape, angle=0.07, **REF).tolist(),
        "window_cap1": ShardedFaceCascade(mesh, fc, hit_capacity=1)
        .window_sharded_hits(sample, *sample.shape, **REF).tolist(),
        "band": int(band_cut(sh._window_plan(*sample.shape, REF)[0],
                             mesh.rank, mesh.size).index.size),
    }
    dets, total = sh.batch_hits(batch, *batch.shape[1:], **CFG)
    out.update(batch=[d.tolist() for d in dets], total=total)
    # a mesh of the first rank only: a subgroup, which every rank creates
    first = make_mesh(1)
    if first.rank == 0:
        out["first"] = ShardedFaceCascade(first, fc).window_sharded_hits(
            sample, *sample.shape, **REF).tolist()
    else:
        try:
            ShardedFaceCascade(first, fc)
        except ValueError as e:
            out["first"] = str(e)
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def _run_ranks(join, path, world=2):
    """Start `world` ranks of this file as a script and return each one's
    (stdout, stderr, exit code). A rank that could not bind the port
    (the probe socket closes before the ranks bind it, so another process
    can take it) makes the run start again on a fresh port."""
    for attempt in range(3):
        port = _free_port()
        procs = []
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=ROOT)
            argv = [sys.executable, os.path.abspath(__file__), join,
                    str(path)]
            if join == "explicit":
                argv += [str(port), str(rank), str(world)]
            else:  # as torchrun --nproc-per-node sets it
                env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        try:
            results = [p.communicate(timeout=240) + (p.returncode,)
                       for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if all(rc == 0 for _, _, rc in results):
            return results
        bind_race = any("address" in err.lower() for _, err, rc in results
                        if rc != 0)
        if not bind_race or attempt == 2:
            out, err, _ = next(r for r in results if r[2] != 0)
            raise AssertionError(f"rank failed:\n{out}\n{err[-3000:]}")


@pytest.mark.parametrize("join", ["explicit", "env"])
def test_two_process_gloo(frames, singles, cascades, tmp_path, join):
    """Two ranks over gloo on the CPU, joined with an explicit coordinator
    or from torchrun's environment: window_sharded_hits (upright, at 0.07
    and through the overflow re-read) and batch_hits agree between the
    ranks and with the single-process results; the ranks' bands split the
    windows; a mesh of the first rank runs on rank 0 alone and refuses
    rank 1."""
    frame, cfg = frames["tiny"]
    batch = np.stack([np.roll(frame, i, axis=1) for i in range(8)])
    path = tmp_path / "batch.npy"
    np.save(path, batch)
    outs = []
    for out, _, _ in _run_ranks(join, path):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == 1, out
        outs.append(json.loads(lines[0][7:]))
    a, b = outs
    assert [(o["rank"], o["size"], o["backend"]) for o in outs] == [
        (0, 2, "gloo"), (1, 2, "gloo")]
    for key in ("window", "window_rotated", "window_cap1", "batch", "total"):
        assert a[key] == b[key], key
    sample, ref = frames["sample"]

    def same(got, want):
        got = np.asarray(got, np.float64).reshape(-1, 4)
        return np.array_equal(got, want)

    want = singles("default", "sample", 0.0)
    assert same(a["window"], want) and same(a["window_cap1"], want)
    assert same(a["first"], want) and "outside the mesh" in b["first"]
    assert same(a["window_rotated"], singles("default", "sample", 0.07))
    fc = cascades["default"]
    wants = [fc.sparse_hits(f, *frame.shape, **cfg) for f in batch]
    assert all(same(g, w) for g, w in zip(a["batch"], wants))
    assert a["total"] == sum(w.shape[0] for w in wants)
    plan = build_window_plan(*sample.shape, **ref)
    assert a["band"] + b["band"] == plan.num_windows
    assert abs(a["band"] - b["band"]) <= 64  # a cut per scale, each halved


if __name__ == "__main__":
    join, path, *rest = sys.argv[1:]
    sys.exit(_worker(join, path, *map(int, rest)))
