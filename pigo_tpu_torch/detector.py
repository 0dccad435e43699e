"""FaceDetector on PyTorch: the face -> pupils -> landmarks pipeline.

Mirrors pigo_tpu/detector.py's host pipeline and the reference CLI
(cmd/pigo/main.go):
  - RunCascade + ClusterDetections with the CLI defaults,
  - per-face eye anchors (main.go:416-421, :454-458):
        left  = (row - 0.075*s, col - 0.175*s), scale 0.25*s
        right = (row - 0.075*s, col + 0.185*s), scale 0.25*s
    gated on face.Q > 5.0 and face.Scale > 50 (main.go:360, :404),
  - the 15-point landmark schedule (5 eye cascades x2 flips, 4 mouth,
    lp84 as nose via flipV; main.go:493-564),
  - JSON export schema {face:{x,y,size}, eyes:[...], landmark_points:[...]}
    (main.go:89-100), where x is the image column and y the row.

Per frame the card runs one face-cascade launch, then, for a frame with a
qualifying face, one regression-walk launch for all eyes and one for all
landmark points of all faces (ops/pupil_cuda.py); the landmark anchors come
from the eyes' medians on the card, and one download brings back every
eye and point. Each face reports only its own points by default;
`accumulate_json_payload` reproduces the reference CLI's cross-face
accumulation.

Jitter: `detect` draws its uniforms from a `torch.Generator` on the host
(seed 0 when none is given) or takes them as `uniforms=(u_eyes, u_lmk)`;
frame i of `detect_stream(frames, seed=s)` draws from a generator seeded
with s + i.

Device-resident stream (`detect_stream_device`, the counterpart of
pigo_tpu/detector.py:762-998): per frame the face stage stops at its
packed hit list on the card, and one frame program (`device_detect`)
decodes it, clusters it with the cluster kernel (ops/cluster_device.py),
gates the faces into a fixed number of slots, and runs the two walks over
them, so the host waits once per frame, for one flat vector. With the
host tail (`FaceDetector(host_tail=True)`) the engine's hits of the frame
go up through pinned memory beside it, and the program merges them with
the card's hits into `detect`'s scan order before clustering (the JAX
package's tail merge, pigo_tpu/detector.py:469-477, :848-858). Its jitter is
one flat draw per frame from the frame's generator, gathered by each eyed
face's rank on the card, so frame i equals `detect` with the generator
seeded seed + i, bit for bit. A frame that overflows the program's caps
climbs a ladder (more face slots, more hits, then `detect` on the card).
On a card the stream's face stage and frame program are each captured
once per key as a CUDA graph and replayed for every frame (`_Graph`,
`_StageGraphs`): the same hand-written kernels with the same arguments,
enqueued by two replays instead of some eighty calls; the host stages the
frame, the draw and the tail into static device buffers before them. The
graphs belong to the FaceDetector, so every stream of one detector shares
them; off the card the stream runs op by op, as `detect` always does.

Rotation: `angle` > 0 runs the face stage rotated (models/face.py) and
the eye walks rotated at the same angle; the landmark walks stay upright,
as in pigo_tpu/detector.py:187-216. A tall strided frame keeps its row
stride for the face stage (models/face.keeps_stride), and the walks read
the same device frame through the stride (they clamp columns at cols-1,
so the pad is never read), as pigo_tpu/detector.py:626-647 does.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from pigo_tpu_torch.convert import PupilTensors
from pigo_tpu_torch.models.face import (
    FaceCascade,
    _Slot,
    angle_index,
    destride,
    keeps_stride,
)
from pigo_tpu_torch.models.landmark import LandmarkLocalizer
from pigo_tpu_torch.models.pupil import (
    PupilLocalizer,
    Puploc,
    ensemble_medians,
    to_device,
)
from pigo_tpu_torch.ops import pupil_cuda, pupil_dense
from pigo_tpu_torch.ops.cluster import cluster_detections
from pigo_tpu_torch.ops.cluster_device import MAX_CAPACITY, cluster_device
from pigo_tpu_torch.utils import build, profiling
from pigo_tpu_torch.utils.device import resolve_device

# CLI constants (cmd/pigo/main.go:54, :360, :404)
PERTURBS = 63
Q_THRESH = 5.0
MIN_EYE_FACE_SCALE = 50

# Capacities of the device frame program (`device_detect`), the
# counterparts of pigo_tpu/detector.py:434-437, as (dense_cap, tail_cap,
# max_faces). The JAX package caps the hits at 256 because its XLA
# program's cost grows with the capacity. The cluster kernel's cost follows
# the hit count it reads on the card, so a cap below the face stage's own
# hit list only adds round trips (a 1080p frame has 312 hits): the dense
# cap is FaceCascade.HIT_CAPACITY. The tail cap bounds the host tail's
# hits (FaceDetector(host_tail=True)): the JAX package's 64 and 128 would
# overflow on every 1080p frame, whose ~312 raw hits all lie in host
# scales (the headline pyramid's 22 do too), so the first rung holds 512
# and the top rung HIT_CAPACITY; dense plus tail stays within the cluster
# kernel's MAX_CAPACITY. The post stage walks every face slot, filled or
# not, so the default is 2 slots, and a stream follows its recent face
# counts; a frame with more faces escalates. The top rung holds 32 faces,
# not the JAX package's 16: the rolled frames of the 1080p tiling hold 12
# to 24, and a slot costs the walk kernel a few microseconds, far less
# than the round trip of a frame handed to `detect`.
DEV_DENSE_CAP = FaceCascade.HIT_CAPACITY
DEV_TAIL_CAP = 512
DEV_MAX_FACES = 2
DEV_CAPS_ESCALATED = (FaceCascade.HIT_CAPACITY, FaceCascade.HIT_CAPACITY, 32)

# Face-stage keys whose CUDA graphs a FaceDetector keeps on a card (the
# device stream's, `_stage_graphs`); the least recently used goes, with
# its frame programs' graphs, so a caller that meets many frame sizes (the
# serving engine) holds a bounded amount of device memory.
GRAPH_KEYS = 8


@dataclasses.dataclass(frozen=True)
class ImageParams:
    """Grayscale frame (reference core/pigo.go:29-34). Accepted by
    FaceDetector.detect/detect_faces in place of (gray, rows, cols)."""

    pixels: np.ndarray  # flat uint8 [rows*dim]
    rows: int
    cols: int
    dim: int


def _coerce_image(gray, rows, cols):
    """(gray, rows, cols) or an ImageParams -> (pixels, rows, cols, dim)."""
    if isinstance(gray, ImageParams):
        return gray.pixels, gray.rows, gray.cols, gray.dim
    return gray, rows, cols, None


@dataclasses.dataclass(frozen=True)
class CascadeParams:
    """Detection parameters (reference core/pigo.go:16-22; CLI defaults
    main.go:105-119)."""

    min_size: int = 20
    max_size: int = 1000
    shift_factor: float = 0.15
    scale_factor: float = 1.15


@dataclasses.dataclass(frozen=True)
class Detection:
    """One clustered face detection (reference core/pigo.go:195-200)."""

    row: int
    col: int
    scale: int
    q: float


@dataclasses.dataclass
class FaceResult:
    """Full per-face result: detection + eyes + landmark points."""

    face: Detection
    eyes: list[Puploc] = dataclasses.field(default_factory=list)
    landmarks: list[Puploc] = dataclasses.field(default_factory=list)

    def to_json_dict(self) -> dict:
        """Reference JSON schema (main.go:89-100, 394-398, 446-450):
        x = image column, y = image row; zero-valued fields are dropped to
        match Go's `omitempty` marshaling."""

        def drop_zero(d: dict) -> dict:
            return {k: v for k, v in d.items() if v != 0}

        out: dict = {
            "face": drop_zero(
                {
                    "x": self.face.col - self.face.scale // 2,
                    "y": self.face.row - self.face.scale // 2,
                    "size": self.face.scale,
                }
            )
        }
        if self.eyes:
            out["eyes"] = [
                drop_zero({"x": e.col, "y": e.row, "size": int(e.scale)})
                for e in self.eyes
            ]
        if self.landmarks:
            out["landmark_points"] = [
                drop_zero({"x": p.col, "y": p.row, "size": int(p.scale)})
                for p in self.landmarks
            ]
        return out


def accumulate_json_payload(payload: list[dict]) -> list[dict]:
    """Reproduce the reference CLI's cross-face accumulation quirk
    bug-for-bug: `drawFaces` allocates one eyesCoords/landmarkCoords slice
    for the whole image and never resets them between faces
    (cmd/pigo/main.go:363-365), and each face's detection struct snapshots
    the grown slice (main.go:568-572), so face i's JSON carries every eye
    and landmark point found for faces 0..i. A face with no eyes of its own
    still reports all earlier ones."""
    eyes: list[dict] = []
    lms: list[dict] = []
    out: list[dict] = []
    for d in payload:
        d = dict(d)
        eyes.extend(d.pop("eyes", []))
        lms.extend(d.pop("landmark_points", []))
        if eyes:
            d["eyes"] = list(eyes)
        if lms:
            d["landmark_points"] = list(lms)
        out.append(d)
    return out


def _eye_anchor_offsets(s: int) -> tuple[int, int, int]:
    """Reference eye-anchor offsets for face scale s, computed in float32
    exactly like Go (cmd/pigo/main.go:417-458): `int(0.075*float32(s))`
    multiplies in f32 (the untyped constant adopts float32), then truncates.
    f64 would differ by one pixel at s in {360, 680, 720}."""
    f = np.float32
    return (int(f(0.075) * f(s)), int(f(0.175) * f(s)), int(f(0.185) * f(s)))


def eye_anchors(faces: list[Detection]) -> np.ndarray:
    """The reference CLI's eye anchors (row, col, scale) f32 [2F, 3] of F
    faces, left then right eye per face (main.go:416-421, :454-458)."""
    anchors = []
    for d in faces:
        o_row, o_l, o_r = _eye_anchor_offsets(d.scale)
        s = float(d.scale) * 0.25
        anchors += [(d.row - o_row, d.col - o_l, s),
                    (d.row - o_row, d.col + o_r, s)]
    return np.array(anchors, np.float32).reshape(-1, 3)


def _attach_post(res, eyes, lmk, i, npts, perturbs):
    """Attach face i's voted eyes and landmark points to a FaceResult,
    applying the reference validity gates (eye coords > 0 before landmarks
    count, cmd/pigo/main.go:422-470)."""
    left = Puploc(row=int(eyes[0, 2 * i]), col=int(eyes[1, 2 * i]),
                  scale=float(eyes[2, 2 * i]), perturbs=perturbs)
    right = Puploc(row=int(eyes[0, 2 * i + 1]),
                   col=int(eyes[1, 2 * i + 1]),
                   scale=float(eyes[2, 2 * i + 1]), perturbs=perturbs)
    if left.row > 0 and left.col > 0:
        res.eyes.append(left)
    if right.row > 0 and right.col > 0:
        res.eyes.append(right)
    if left.row > 0 and left.col > 0 and right.row > 0 and right.col > 0:
        res.landmarks = [
            p for p in (
                Puploc(row=int(lmk[0, i, j]), col=int(lmk[1, i, j]),
                       scale=float(lmk[2, i, j]), perturbs=perturbs)
                for j in range(npts)
            )
            if p.row > 0 and p.col > 0
        ]


def landmark_anchors(eyes: torch.Tensor):
    """Landmark anchors (row, col, scale) f32 [F] from the voted eyes
    [3, 2F] (left, right per face), in f32 where the eyes live
    (pigo_tpu/detector.py:199-207, core/flploc.go:37-43): the medians are
    truncated like the host's Puploc(int(row), int(col)) first."""
    f32 = pupil_dense.f32_scalar
    ler, lec = torch.trunc(eyes[0, 0::2]), torch.trunc(eyes[1, 0::2])
    rer, rec = torch.trunc(eyes[0, 1::2]), torch.trunc(eyes[1, 1::2])
    d = ler - rer
    e = lec - rec
    dist = torch.sqrt(d * d + e * e)
    arow = torch.trunc((ler + rer) / f32(2.0) + f32(0.25) * dist)
    acol = torch.trunc((lec + rec) / f32(2.0) + f32(0.15) * dist)
    return arow, acol, f32(3.0) * dist


def fused_post(erow, ecol, escale, pixels, pupil: PupilTensors,
               landmarks: PupilTensors | None, u_eyes, u_lmk, lmk_cids,
               lmk_flips, *, rows: int, cols: int, dim: int,
               angle: float = 0.0, u_rows=None) -> torch.Tensor:
    """Eyes + landmarks for F faces, on the pixels' device, with no host
    synchronisation: what pigo_tpu.detector._fused_post_impl computes,
    with its uniforms passed in.

    erow/ecol/escale f32 [2F] eye anchors; pixels uint8 [rows*dim];
    u_eyes f32 [2F, P, 3]; u_lmk f32 [F*npts, P, 3]; lmk_cids int32 and
    lmk_flips bool [F*npts]. `u_rows` = (eye_rows int64 [2F], lmk_rows
    int64 [F*npts]) makes u_eyes and u_lmk tables of rows [R, P, 3]:
    eye group g draws row eye_rows[g] of u_eyes, landmark group g row
    lmk_rows[g] of u_lmk (the stream's flat draw, `device_detect`). The
    eyes walk rotated at `angle`, the landmarks upright, anchored on the
    eyes' medians. Returns [3, 2F + F*npts] f32 medians (row, col,
    scale); with `landmarks=None` the eyes alone.

    On the card: two launches of kernel C's ensemble mode
    (ops/pupil_cuda.pupil_ensemble), eyes then landmarks, each with its
    jitter and median vote, into one output. On the CPU, or beyond
    pupil_cuda.MAX_PERTURBS walkers a group, `composed_post`, which it
    equals bit for bit."""
    if (pixels.device.type != "cuda"
            or u_eyes.shape[1] > pupil_cuda.MAX_PERTURBS):
        return composed_post(erow, ecol, escale, pixels, pupil, landmarks,
                             u_eyes, u_lmk, lmk_cids, lmk_flips, rows=rows,
                             cols=cols, dim=dim, angle=angle, u_rows=u_rows)
    f2 = erow.shape[0]
    n_lmk = 0 if landmarks is None else lmk_cids.shape[0]
    eye_rows, lmk_rows = (None, None) if u_rows is None else u_rows
    out = torch.empty((3, f2 + n_lmk), dtype=torch.float32,
                      device=pixels.device)
    kw = dict(nrows=rows, ncols=cols, dim=dim)
    pupil_cuda.pupil_ensemble(
        pupil.codes, pupil.preds, out, u_eyes, pixels, col0=0,
        anchors=(erow, ecol, escale), u_rows=eye_rows,
        scale_mult=pupil.scale_mult, rotated=angle > 0.0,
        angle_idx=pupil_dense.angle_index(angle), **kw)
    if landmarks is not None:
        pupil_cuda.pupil_ensemble(
            landmarks.codes, landmarks.preds, out, u_lmk, pixels, col0=f2,
            npts=n_lmk // (f2 // 2), casc_id=lmk_cids, flips=lmk_flips,
            u_rows=lmk_rows, scale_mult=landmarks.scale_mult, **kw)
    profiling.count("post.fused")
    return out


def composed_post(erow, ecol, escale, pixels, pupil: PupilTensors,
                  landmarks: PupilTensors | None, u_eyes, u_lmk, lmk_cids,
                  lmk_flips, *, rows: int, cols: int, dim: int,
                  angle: float = 0.0, u_rows=None) -> torch.Tensor:
    """`fused_post` composed of tensor operations around two pupil_walk
    calls (jitter, walk, sort-based median, landmark anchors): its plain
    route, and on the card the composition the ensemble launches are
    held to."""
    if u_rows is not None:
        u_eyes = u_eyes[u_rows[0]]
        u_lmk = None if landmarks is None else u_lmk[u_rows[1]]
    f2 = erow.shape[0]
    zeros = torch.zeros(f2, dtype=torch.int32, device=erow.device)
    eyes = ensemble_medians(pupil, zeros, erow, ecol, escale, zeros.bool(),
                            u_eyes, pixels, rows, cols, dim, angle)
    if landmarks is None:
        return eyes
    npts = lmk_cids.shape[0] // (f2 // 2)
    arow, acol, ascale = landmark_anchors(eyes)
    lmk = ensemble_medians(
        landmarks, lmk_cids, pupil_dense.repeat_each(arow, npts),
        pupil_dense.repeat_each(acol, npts),
        pupil_dense.repeat_each(ascale, npts),
        lmk_flips, u_lmk, pixels, rows, cols, dim)
    return torch.cat([eyes, lmk], dim=1)


def _device_eye_anchors(frows, fcols, fscales):
    """Eye anchors (row, col, scale) f32 [2F] of F faces, left then right
    eye per face, computed where the faces live (pigo_tpu/detector.py:
    152-166): trunc(f32(0.175) * f32(s)) in f32 is the reference's
    arithmetic (cmd/pigo/main.go:416-458) and `_eye_anchor_offsets`'."""
    f32 = pupil_dense.f32_scalar
    s = fscales.to(torch.float32)
    rows, cols = frows.to(torch.float32), fcols.to(torch.float32)
    erow = pupil_dense.repeat_each(rows - torch.trunc(f32(0.075) * s), 2)
    ecol = torch.stack([cols - torch.trunc(f32(0.175) * s),
                        cols + torch.trunc(f32(0.185) * s)], dim=1)
    return erow, ecol.reshape(-1), pupil_dense.repeat_each(s * f32(0.25), 2)


def merge_tail(dets, valid, tail, tail_cap: int, rows: int, cols: int):
    """The card's decoded hits (dets f32 [D, 4], valid bool [D], in scan
    order) and the host tail's (tail f32 [1 + 4*tail_cap]: the count, then
    tail_cap rows (row, col, scale, q) in scan order) as one list in
    reference scan order, valid entries first: what `detect`'s host merge
    (models/face.merge_scan_order) gives, on the card and without a host
    synchronisation. A stable sort on the window key (scale, row, col),
    invalid entries last. Returns (dets [D + tail_cap, 4], valid, the
    tail's count f32 [1])."""
    tail_n = tail[:1]
    trows = tail[1:].reshape(tail_cap, 4)
    tvalid = torch.arange(tail_cap, device=tail.device) < tail_n
    dets = torch.cat([dets, trows])
    valid = torch.cat([valid, tvalid])
    r, c, s = dets[:, :3].to(torch.int64).unbind(1)
    key = torch.where(valid, (s * rows + r) * cols + c,
                      torch.iinfo(torch.int64).max)
    order = torch.sort(key, stable=True).indices
    return dets[order], valid[order], tail_n


def device_detect(packed, coords, pixels, pupil: PupilTensors,
                  landmarks: PupilTensors, u, lmk_cids, lmk_flips, *,
                  hit_cap: int, dense_cap: int, max_faces: int,
                  iou_threshold: float, perturbs: int, rows: int, cols: int,
                  dim: int, angle: float = 0.0, tail=None,
                  tail_cap: int = 0) -> torch.Tensor:
    """One frame's program after the face stage, on the packed list's
    device with no host synchronisation: the counterpart of
    pigo_tpu/detector.py::_device_detect_impl.

    packed f32 [1 + 2*hit_cap] (models/face.compact_hits); coords f32
    [W, 3] the plan's window (row, col, scale); pixels uint8 [rows*dim];
    u f32 [(2S + S*npts) * P * 3] the frame's flat draw; lmk_cids int32
    and lmk_flips bool [S*npts], with S = max_faces slots; tail (host tail
    only) f32 [1 + 4*tail_cap], the host engine's hits (`merge_tail`).
    Steps: decode the first dense_cap hits; merge the tail's first
    tail_cap into scan order; cluster them (ops/cluster_device.py); gate
    the faces (q > Q_THRESH) into S slots in cluster order by a cumsum;
    mark the eyed ones (scale > MIN_EYE_FACE_SCALE); give eyed face k, of
    rank j among n_eyed, the rows 2j, 2j+1 of u for its eyes and
    2*n_eyed + j*npts + m for its point m (the rows `detect` draws for it,
    eyes first, from the same generator); run `fused_post` over every
    slot. Returns f32 [2 + 6S + 3*(2S + S*npts)]: hit overflow (1 for
    count > dense_cap, plus 2 for a tail count > tail_cap), n_faces,
    faces [S, 4], fvalid [S], eyed [S], post."""
    dev = packed.device
    s = max_faces
    count = packed[:1]
    idx = packed[1:1 + dense_cap]
    qv = packed[1 + hit_cap:1 + hit_cap + dense_cap]
    dets = torch.cat([coords[idx.clamp(min=0).to(torch.int64)], qv[:, None]],
                     dim=1)
    valid = idx >= 0
    overflow = (count > dense_cap).to(torch.float32)
    n = count.to(torch.int32)
    if tail is not None:
        dets, valid, tail_n = merge_tail(dets, valid, tail, tail_cap, rows,
                                         cols)
        overflow = overflow + 2.0 * (tail_n > tail_cap)
        n = valid.sum(dtype=torch.int32).reshape(1)
    cc = dets.shape[0]
    clusters, cvalid = cluster_device(dets, valid, n, iou_threshold,
                                      capacity=cc)
    keep = cvalid & (clusters[:, 3] > Q_THRESH)
    pos = torch.cumsum(keep, 0, dtype=torch.int64)
    n_faces = pos[-1:]
    src = torch.zeros(s + 1, dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(keep & (pos <= s), pos - 1, s),
                 torch.arange(cc, device=dev))
    fvalid = torch.arange(s, device=dev) < n_faces
    faces = torch.where(fvalid[:, None], clusters[src[:s]], 0.0)
    eyed = fvalid & (faces[:, 2] > MIN_EYE_FACE_SCALE)
    erow, ecol, escale = _device_eye_anchors(
        faces[:, 0], faces[:, 1],
        torch.where(eyed, faces[:, 2], 100.0))  # a safe pad anchor
    npts = lmk_cids.shape[0] // s
    epos = torch.cumsum(eyed, 0, dtype=torch.int64)
    rank = torch.where(eyed, epos - 1, 0)[:, None]
    table = u.reshape(-1, perturbs, 3)
    eye_rows = 2 * rank + torch.arange(2, device=dev)
    lmk_rows = 2 * epos[-1:] + rank * npts + torch.arange(npts, device=dev)
    post = fused_post(erow, ecol, escale, pixels, pupil, landmarks, table,
                      table, lmk_cids, lmk_flips, rows=rows, cols=cols,
                      dim=dim, angle=angle,
                      u_rows=(eye_rows.reshape(-1), lmk_rows.reshape(-1)))
    flags = torch.cat([overflow, n_faces.to(torch.float32)])
    return torch.cat([flags, faces.reshape(-1), fvalid.to(torch.float32),
                      eyed.to(torch.float32), post.reshape(-1)])


@dataclasses.dataclass
class _DeviceSlot:
    """Host staging of one in-flight device frame: the face stage's upload
    slot, the frame's flat uniforms, its host tail list and the program's
    output, pinned on a card. A slot is reused only after its frame's
    event was waited on."""

    face: _Slot
    key: tuple | None = None
    uniforms: torch.Tensor | None = None
    out: torch.Tensor | None = None
    tail: torch.Tensor | None = None

    def buffers(self, n_uniforms: int, n_out: int, tail_cap: int):
        if self.key != (n_uniforms, n_out, tail_cap):
            pin = self.face.device.type == "cuda"
            self.uniforms, self.out, self.tail = (
                torch.empty(n, dtype=torch.float32, pin_memory=pin)
                for n in (n_uniforms, n_out, 1 + 4 * tail_cap))
            self.key = (n_uniforms, n_out, tail_cap)
        return self.uniforms, self.out, self.tail


@dataclasses.dataclass
class _FrameTicket:
    """One dispatched device frame: what a re-dispatch or `detect` needs
    (the frame, its (params, angle, iou_threshold, perturbs), its seed, its
    caps and slot), and the program's output with its event (None: the
    frame has no window)."""

    frame: np.ndarray
    args: tuple
    seed: int
    caps: tuple
    slot: _DeviceSlot
    npts: int
    out: torch.Tensor | None = None
    event: object = None


class _Graph:
    """One call's card work as a CUDA graph (the device stream on a card):
    captured at the first `run(fn)`, then replayed at each run, which
    returns fn's outputs as captured, rewritten by the replay. fn reads
    static buffers that the caller fills before each run; the graph keeps
    fn, and with it every tensor fn reads, alive. Each replay adds the
    kernel launches its capture recorded to build.LAUNCHES, so that it
    counts what ran; the capture and its warm-up run add none."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = None
        self.fn = None
        self.out = None
        self.launches: collections.Counter = collections.Counter()

    def run(self, fn):
        if self.graph is None:
            self._capture(fn)
        self.graph.replay()
        for kernel, n in self.launches.items():
            build.count(kernel, n)
        return self.out

    def _capture(self, fn) -> None:
        """fn once on a side stream, as torch.cuda.graphs asks (its
        one-time set-up, such as the kernels' cudaFuncSetAttribute, so
        runs outside the capture), then its capture, thread-local so that
        another thread's CUDA calls (the serving engine's) cannot break
        it. torch.cuda.graph synchronises the device before it captures.
        Both count their launches into recorders of this thread
        (build.recording), the warm-up's thrown away."""
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), build.recording():
                fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with build.recording() as launches, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                out = fn()
        self.graph, self.fn, self.out, self.launches = graph, fn, out, launches
        profiling.count("stream.graph_captures")


class _StageGraphs:
    """The CUDA graphs of one face-stage key (`FaceDetector._stage_graphs`):
    the face stage's, over the static frame buffer `frames` (the graph
    protocol of FaceCascade._dispatch), and a frame program's per program
    key, each with its static uniforms and host tail buffers (`program`).
    Every frame of the key shares them, and stream order alone keeps that
    safe at any depth: frame i's download of the program's output is
    enqueued on the stream before frame i+1's uploads and replays."""

    def __init__(self, shape: tuple, device: torch.device):
        self.frames = torch.empty(shape, dtype=torch.uint8, device=device)
        self.face = _Graph(device)
        self.programs: dict[tuple, tuple] = {}

    def run(self, fn):
        return self.face.run(fn)

    def program(self, key: tuple, n_uniforms: int, tail_cap: int | None):
        """(graph, uniforms, tail or None) of frame-program key `key`."""
        hit = self.programs.get(key)
        if hit is None:
            dev = self.frames.device
            hit = self.programs[key] = (
                _Graph(dev),
                torch.empty(n_uniforms, dtype=torch.float32, device=dev),
                None if tail_cap is None else torch.empty(
                    1 + 4 * tail_cap, dtype=torch.float32, device=dev))
        return hit


class DeviceStream:
    """The device-resident stream's frames in flight, fed one frame at a
    time (detect_stream_device, the serving engine). It owns `depth`
    staging slots: a frame holds one from `submit` until `collect_oldest`
    answers it (the ladder re-dispatches into that same slot). The first
    frame is collected before a second is submitted, so that its face
    count sizes the face slots of the frames behind it (`full`). Each
    frame's results equal `detect(frame, generator=manual_seed(seed))` bit
    for bit. A frame whose dispatch or collection raises trades its slot,
    which may hold a half-enqueued upload, for a new one, and the error
    goes to the caller."""

    def __init__(self, det: "FaceDetector", args: tuple, depth: int):
        self.det = det
        self.args = args  # (params, angle, iou_threshold, perturbs)
        self.depth = max(1, int(depth))
        self._free = [self._new_slot() for _ in range(self.depth)]
        self._inflight: collections.deque = collections.deque()
        self._primed = False  # a frame was collected

    def __len__(self) -> int:
        return len(self._inflight)

    @property
    def full(self) -> bool:
        """True when the oldest frame must be collected before another is
        submitted."""
        return len(self._inflight) >= self.depth or (
            bool(self._inflight) and not self._primed)

    def _new_slot(self) -> _DeviceSlot:
        return _DeviceSlot(_Slot(self.det.device))

    def submit(self, frame, seed: int) -> None:
        """Enqueue `frame` [rows, cols] uint8 with its jitter seed."""
        if self.full:
            raise RuntimeError("DeviceStream is full: collect the oldest "
                               "frame first")
        slot = self._free.pop()
        try:
            ticket = self.det._dispatch_frame_device(frame, self.args, seed,
                                                     slot)
        except BaseException:
            self._free.append(self._new_slot())
            raise
        self._inflight.append(ticket)

    def collect_oldest(self) -> list[FaceResult]:
        """Wait for the oldest frame in flight and return its results."""
        ticket = self._inflight.popleft()
        try:
            results = self.det._collect_frame_device(ticket)
        except BaseException:
            self._free.append(self._new_slot())
            raise
        self._free.append(ticket.slot)
        self._primed = True
        return results


@dataclasses.dataclass
class _PostTicket:
    """One dispatched post stage: the faces it serves, the [3, 2F + F*npts]
    medians (on a card in `staging`, its host buffer, pinned) and its
    event; `staging` goes back to `pool` once collected."""

    eyed: list
    npts: int
    perturbs: int
    out: torch.Tensor
    staging: torch.Tensor
    pool: list
    event: object = None


class FaceDetector:
    """End-to-end detector; loads the bundled cascades by default.
    `device=None` means the CUDA card and raises without one;
    `device="cpu"` runs the kernels' plain PyTorch versions (tests).
    `host_tail=True` (with `host_threads` for the engine's scan) builds the
    default FaceCascade with the host tail engine (models/face.py), so
    `detect`, `detect_faces`, `detect_stream` and `detect_stream_device`
    route the sparse tail scales through it; a `face` passed in keeps its
    own routing, and host_tail=True then needs one built with it."""

    def __init__(self, face: FaceCascade | None = None,
                 pupil: PupilLocalizer | None = None,
                 landmarks: LandmarkLocalizer | None = None, *,
                 with_pupils: bool = True, with_landmarks: bool = True,
                 device_caps: tuple[int, int, int] | None = None,
                 device: str | torch.device | None = None,
                 host_tail: bool = False, host_threads: int | None = None):
        self.device = resolve_device(device)
        # (dense_cap, tail_cap, max_faces) of detect_stream_device's frame
        # program; frames that exceed them escalate. Without explicit caps
        # the face slots follow the largest face count of the last 8
        # frames with half of it again as headroom, in power-of-two
        # buckets: a bucket that only just holds the faces makes the next
        # frame with a few more escalate (the 1080p tiling's rolled frames
        # go 15, 24, 12), and a pad slot costs less than a round trip.
        caps = (DEV_DENSE_CAP, DEV_TAIL_CAP, DEV_MAX_FACES
                ) if device_caps is None else tuple(device_caps)
        if not (len(caps) == 3 and 1 <= caps[0] <= FaceCascade.HIT_CAPACITY
                and 0 <= caps[1] <= MAX_CAPACITY - caps[0]
                and caps[2] >= 1):
            raise ValueError(f"device_caps must be (dense_cap in [1, "
                             f"{FaceCascade.HIT_CAPACITY}], tail_cap >= 0 "
                             f"with dense_cap + tail_cap <= {MAX_CAPACITY}, "
                             f"max_faces >= 1), got {device_caps}")
        self.device_caps = caps
        self._auto_caps = device_caps is None
        # the device stream's ladder and host waits, counted (always on,
        # read by the tests and chip_smoke.py; clear() it to reset): a
        # re-dispatch with more face slots ("face_slot_escalations"), one
        # with larger hit caps ("hit_cap_escalations"; of those, each whose
        # host tail overflowed its cap adds to "tail_cap_escalations"), a
        # frame handed to `detect` ("detect_fallbacks"), and each wait for
        # a frame program's download ("device_frame_waits")
        self.ladder: collections.Counter = collections.Counter()
        self._recent_face_counts: collections.deque = collections.deque(
            maxlen=8)
        self._lmk_tables: dict[int, tuple] = {}
        # the device stream's CUDA graphs by face-stage key, least recently
        # used first (_stage_graphs)
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        # the post stage's host staging buffers not in flight (_staging)
        self._post_staging: list[torch.Tensor] = []
        if face is not None and host_tail and not face.host_tail:
            raise ValueError("host_tail=True with a FaceCascade built "
                             "without it: pass host_tail to the FaceCascade")
        self.face = face if face is not None else FaceCascade(
            device=self.device, host_tail=host_tail,
            host_threads=host_threads)
        self.pupil = pupil if pupil is not None else (
            PupilLocalizer(device=self.device)
            if (with_pupils or with_landmarks) else None)
        self.landmarks = landmarks if landmarks is not None else (
            LandmarkLocalizer(device=self.device) if with_landmarks
            else None)
        for part in (self.face, self.pupil, self.landmarks):
            if part is not None and part.device != self.device:
                raise ValueError(f"{type(part).__name__} is on "
                                 f"{part.device}, the detector on "
                                 f"{self.device}")

    # ------------------------------------------------------- face stage

    @staticmethod
    def _frames(gray, rows, cols, angle: float = 0.0):
        """A frame (or ImageParams) -> ([1, rows, dim] frames, cols). A row
        stride dim > cols is removed exactly first (models/face.destride:
        no window or walk probe reads past cols), unless the rotated face
        stage must read through it (models/face.keeps_stride)."""
        pixels, rows, cols, dim = _coerce_image(gray, rows, cols)
        if dim is None or dim == cols:
            dim = cols
        elif not keeps_stride(rows, cols, dim, angle_index(angle)):
            pixels, dim = destride(pixels, rows, cols, dim), cols
        return FaceCascade._as_frames(pixels, rows, dim), cols

    @staticmethod
    def _cfg(params: CascadeParams) -> dict:
        return dict(min_size=params.min_size, max_size=params.max_size,
                    shift_factor=params.shift_factor,
                    scale_factor=params.scale_factor)

    def _dispatch_faces(self, frames, slot: _Slot, params: CascadeParams,
                        angle: float, download: bool = True, graph=None):
        """Async face stage of `_frames`'s (frames, cols); without download
        it stops at the packed hit list on the device, with `graph` (from
        `_stage_graphs`) as a replay of its CUDA graph."""
        frames, cols = frames
        return self.face._dispatch(frames, slot, self._cfg(params), angle,
                                   cols, download, graph=graph)

    def _faces(self, ticket, iou_threshold: float) -> list[Detection]:
        """Blocking half of the face stage: hits -> clustered detections."""
        hits = self.face._collect(ticket)[0]
        with profiling.span("cluster.host"):
            clusters = cluster_detections(hits, iou_threshold)
        return [Detection(row=int(r), col=int(c), scale=int(s), q=float(q))
                for r, c, s, q in clusters]

    def _results(self, ticket, iou_threshold: float) -> list[FaceResult]:
        return [FaceResult(face=d) for d in self._faces(ticket, iou_threshold)
                if d.q > Q_THRESH]

    def detect_faces(self, gray, rows: int | None = None,
                     cols: int | None = None,
                     params: CascadeParams = CascadeParams(),
                     angle: float = 0.0,
                     iou_threshold: float = 0.15) -> list[Detection]:
        """RunCascade + ClusterDetections (main.go:350-353)."""
        frames = self._frames(gray, rows, cols, angle)
        return self._faces(self._dispatch_faces(
            frames, self.face._single, params, angle), iou_threshold)

    # ------------------------------------------------------- post stage

    def _uniforms(self, f: int, perturbs: int, generator, uniforms,
                  out=None):
        """(u_eyes [2F, P, 3], u_lmk [F*npts, P, 3] or None) on the host,
        drawn eyes first (or `uniforms` checked); into the host tensors
        `out` = (eyes, landmarks or None) when given."""
        shapes = [(2 * f, perturbs, 3)]
        if self.landmarks is not None:
            shapes.append((f * len(self.landmarks.point_schedule), perturbs,
                           3))
        if out is None:
            out = [torch.empty(shape, dtype=torch.float32)
                   for shape in shapes]
        if uniforms is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            for u in out[:len(shapes)]:
                torch.rand(u.shape, generator=generator, out=u)
        else:
            got = [np.asarray(u, np.float32) for u in uniforms[:len(shapes)]]
            if [u.shape for u in got] != shapes:
                raise ValueError(f"uniforms must be shaped {shapes}, got "
                                 f"{[u.shape for u in got]}")
            for u, g in zip(out, got):
                u.numpy()[...] = g
        return out[0], (out[1] if len(shapes) > 1 else None)

    def _staging(self, n: int) -> torch.Tensor:
        """A host buffer of at least n f32 (pinned on a card) from the post
        stage's pool; `_collect_post` gives it back."""
        try:
            buf = self._post_staging.pop()
        except IndexError:
            buf = None
        if buf is None or buf.numel() < n:
            buf = torch.empty(1 << (n - 1).bit_length(), dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
        return buf

    def _dispatch_post(self, results: list[FaceResult], face_ticket,
                       perturbs: int, generator, uniforms,
                       angle: float = 0.0):
        """Async half: the eyes (rotated at `angle`) and landmark walks of
        every qualifying face of a frame and the download of their
        medians, enqueued without waiting for the device: one upload of
        the eye anchors and uniforms, packed in a staging buffer, then
        `fused_post` and one download into the same buffer. The walks read
        the frame the face stage uploaded. None when no face qualifies."""
        with profiling.span("post.dispatch"):
            eyed = [r for r in results
                    if r.face.scale > MIN_EYE_FACE_SCALE]
            if self.pupil is None or not eyed:
                return None
            f = len(eyed)
            profiling.count("post.slots", f)
            dev = self.device
            frame = face_ticket.frames[0]
            rows, dim = frame.shape
            lmk = self.landmarks
            npts = 0 if lmk is None else len(lmk.point_schedule)
            # staging: [erow, ecol, escale (2F each), u_eyes, u_lmk |
            # medians], the part before the bar uploaded at once
            n_eye = 2 * f * perturbs * 3
            n_up = 6 * f + n_eye + f * npts * perturbs * 3

            def parts(buf):
                return (buf[:2 * f], buf[2 * f:4 * f], buf[4 * f:6 * f],
                        buf[6 * f:6 * f + n_eye].view(2 * f, perturbs, 3),
                        buf[6 * f + n_eye:n_up].view(f * npts, perturbs, 3))

            staging = self._staging(n_up + 3 * (2 * f + f * npts))
            staging.numpy()[:6 * f].reshape(3, 2 * f)[...] = eye_anchors(
                [r.face for r in eyed]).T
            self._uniforms(f, perturbs, generator, uniforms,
                           out=parts(staging)[3:])
            up = staging[:n_up]
            if dev.type == "cuda":
                up = up.to(dev, non_blocking=True)
            cids, flips = (None, None) if lmk is None else \
                self._device_tables(f)
            out = fused_post(
                *parts(up)[:3], frame.reshape(-1), self.pupil.tensors,
                None if lmk is None else lmk.tensors, *parts(up)[3:], cids,
                flips, rows=rows, cols=face_ticket.cols, dim=dim,
                angle=angle)
            ticket = _PostTicket(eyed=eyed, perturbs=perturbs, out=out,
                                 npts=npts, staging=staging,
                                 pool=self._post_staging)
            if dev.type == "cuda":
                ticket.out = staging[n_up:n_up + out.numel()].view(
                    out.shape).copy_(out, non_blocking=True)
                ticket.event = torch.cuda.Event()
                ticket.event.record(torch.cuda.current_stream(dev))
            return ticket

    @staticmethod
    def _collect_post(ticket: _PostTicket | None) -> None:
        """Blocking half: wait for the medians and attach them; the
        staging buffer goes back to its pool."""
        with profiling.span("post.collect"):
            if ticket is None:
                return
            with profiling.span("post.wait"):
                if ticket.event is not None:
                    ticket.event.synchronize()
            out = ticket.out.numpy()
            f = len(ticket.eyed)
            profiling.count("post.faces", f)
            eyes = out[:, :2 * f]
            lmk = out[:, 2 * f:].reshape(3, f, ticket.npts)
            for i, res in enumerate(ticket.eyed):
                _attach_post(res, eyes, lmk, i, ticket.npts,
                             ticket.perturbs)
            ticket.pool.append(ticket.staging)

    # ------------------------------------------------------- entry points

    def detect(self, gray, rows: int | None = None, cols: int | None = None,
               params: CascadeParams = CascadeParams(), angle: float = 0.0,
               iou_threshold: float = 0.15, perturbs: int = PERTURBS,
               generator: torch.Generator | None = None,
               uniforms=None) -> list[FaceResult]:
        """Full pipeline: faces, then eyes + landmarks per qualifying face.

        All eye anchors of the frame are refined in one kernel walk, then
        all landmark points of all faces in another (the reference makes
        2 + 15 sequential RunDetector calls per face,
        cmd/pigo/main.go:422-564). `uniforms=(u_eyes [2F, P, 3],
        u_lmk [15F, P, 3])` replaces the generator's draws."""
        with profiling.span("detect"):
            frames = self._frames(gray, rows, cols, angle)
            ticket = self._dispatch_faces(frames, self.face._single,
                                          params, angle)
            results = self._results(ticket, iou_threshold)
            self._collect_post(self._dispatch_post(
                results, ticket, perturbs, generator, uniforms, angle))
            return results

    def detect_stream(self, frames, params: CascadeParams = CascadeParams(),
                      angle: float = 0.0, iou_threshold: float = 0.15,
                      perturbs: int = PERTURBS, seed: int = 0,
                      depth: int = 4):
        """Streaming full pipeline over [rows, cols] uint8 frames: the face
        stage of frame i+1 is enqueued before frame i's hits are
        collected, and up to `depth` post stages stay in flight while the
        host clusters later frames. Yields the per-frame list[FaceResult]
        in input order. Frame i's results equal
        `detect(frame_i, generator=torch.Generator().manual_seed(seed + i))`.
        """
        depth = max(1, int(depth))
        # frame k's face stage reuses the staging slot of frame k - 2,
        # which has been collected by then
        ring = [_Slot(self.device) for _ in range(2)]
        faceq: collections.deque = collections.deque()
        postq: collections.deque = collections.deque()

        def advance():
            j, ticket = faceq.popleft()
            results = self._results(ticket, iou_threshold)
            postq.append((results, self._dispatch_post(
                results, ticket, perturbs,
                torch.Generator().manual_seed(seed + j), None, angle)))

        for i, frame in enumerate(frames):
            fr = self._frames(frame, frame.shape[-2], frame.shape[-1],
                              angle)
            faceq.append((i, self._dispatch_faces(fr, ring[i % 2], params,
                                                  angle)))
            if len(faceq) >= 2:
                advance()
            if len(postq) >= depth:
                results, post = postq.popleft()
                self._collect_post(post)
                yield results
        while faceq:
            advance()
        while postq:
            results, post = postq.popleft()
            self._collect_post(post)
            yield results

    # ------------------------------------------- device-resident stream

    def detect_stream_device(self, frames,
                             params: CascadeParams = CascadeParams(),
                             angle: float = 0.0, iou_threshold: float = 0.15,
                             perturbs: int = PERTURBS, seed: int = 0,
                             depth: int = 4):
        """Device-resident streaming pipeline over [rows, cols] uint8
        frames: per frame the face stage, the clustering, the face gating
        and both walks are enqueued with no host synchronisation, and the
        host waits once, for the frame program's flat result, `depth`
        frames later. Yields the per-frame list[FaceResult] in input
        order; frame i's results equal `detect(frame_i,
        generator=torch.Generator().manual_seed(seed + i))` bit for bit,
        through every rung of the ladder (`_collect_frame_device`).
        The first frame is collected before the second is dispatched, so
        that the frames behind it are sized by its face count (one
        escalation at most at a stream's start, not one per frame in
        flight). A detector without pupils or landmarks runs
        `detect_stream`."""
        if self.pupil is None or self.landmarks is None:
            yield from self.detect_stream(frames, params, angle,
                                          iou_threshold, perturbs, seed,
                                          depth)
            return
        stream = DeviceStream(self, (params, angle, iou_threshold, perturbs),
                              depth)
        for i, frame in enumerate(frames):
            stream.submit(frame, seed + i)
            if stream.full:
                yield stream.collect_oldest()
        while len(stream):
            yield stream.collect_oldest()

    def _stage_graphs(self, frames, params: CascadeParams,
                      angle: float) -> _StageGraphs:
        """The CUDA graphs of the face-stage key of `_frames`'s (frames,
        cols): the plan's key (geometry, angle, routing) and the row
        stride. A new key drops the least recently used beyond GRAPH_KEYS;
        a graph dropped while a replay of it is in flight is freed when
        that replay completes (cudaGraphExecDestroy), and its buffers go
        back to the stream's allocator, whose next user is enqueued after
        that replay."""
        frames, cols = frames
        _, rows, dim = frames.shape
        key = (self.face._plan_key(rows, cols, **self._cfg(params),
                                   angle_idx=angle_index(angle)), dim)
        hit = self._graphs.get(key)
        if hit is None:
            hit = self._graphs[key] = _StageGraphs((1, rows, dim),
                                                   self.device)
            while len(self._graphs) > GRAPH_KEYS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        return hit

    def _device_tables(self, slots: int):
        """The landmark schedule's cascade ids and flips over `slots` face
        slots (or faces), on the device, uploaded once per count."""
        hit = self._lmk_tables.get(slots)
        if hit is None:
            cids, flips = self.landmarks.schedule_arrays(slots)
            hit = (to_device(cids, self.device, torch.int32),
                   to_device(flips, self.device, torch.bool))
            self._lmk_tables[slots] = hit
        return hit

    def _dispatch_frame_device(self, frame, args: tuple, seed: int,
                               slot: _DeviceSlot,
                               caps: tuple | None = None) -> _FrameTicket:
        """Async half: the frame's upload, face stage, jitter draw and
        upload, frame program and the download of its result, enqueued
        without waiting for the device. On a card the face stage and the
        frame program are replays of their CUDA graphs (`_stage_graphs`):
        the same kernels with the same arguments, enqueued by two calls
        instead of one per op; elsewhere they run op by op."""
        with profiling.span("stream.dispatch"):
            params, angle = args[:2]
            if caps is None:
                caps = self.device_caps
                if self._auto_caps and self._recent_face_counts:
                    most = max(self._recent_face_counts)
                    want = max(1, most + most // 2)
                    caps = (caps[0], caps[1],
                            min(1 << (want - 1).bit_length(),
                                DEV_CAPS_ESCALATED[2]))
            ticket = _FrameTicket(
                frame=frame, args=args, seed=seed, caps=tuple(caps),
                slot=slot, npts=len(self.landmarks.point_schedule))
            frames = self._frames(frame, frame.shape[-2], frame.shape[-1],
                                  angle)
            graphs = (self._stage_graphs(frames, params, angle)
                      if self.device.type == "cuda" else None)
            face = self._dispatch_faces(frames, slot.face, params, angle,
                                        download=False, graph=graphs)
            if face.q is None:  # frame smaller than the smallest face
                return ticket
            with profiling.span("post.dispatch"):
                self._dispatch_frame_post(ticket, face, graphs)
            return ticket

    def _dispatch_frame_post(self, ticket: _FrameTicket, face,
                             graphs: _StageGraphs | None = None) -> None:
        """The frame's jitter draw and upload, its host tail's staging,
        the frame program over the face stage's packed list `face` and the
        download of its result, into `ticket`; with `graphs`, the program
        as a replay of the graph of its key (caps, perturbs, IoU
        threshold, angle, points, host tail), over static uniforms and
        tail buffers."""
        _, angle, iou_threshold, perturbs = ticket.args
        dense_cap, tail_cap, s = ticket.caps
        npts, slot = ticket.npts, ticket.slot
        profiling.count("post.slots", s)
        profiling.count("stream.dispatches")
        n_uniforms = (2 * s + s * npts) * perturbs * 3
        u_host, out_host, tail_host = slot.buffers(
            n_uniforms, 2 + 6 * s + 3 * (2 * s + s * npts), tail_cap)
        torch.rand(n_uniforms,
                   generator=torch.Generator().manual_seed(ticket.seed),
                   out=u_host)
        host_tail = face.tail is not None
        if host_tail:  # the host tail's hits, then zero rows
            hits = face.tail[0]
            t = tail_host.numpy()
            t[0] = hits.shape[0]
            t[1:] = 0.0
            t[1:1 + 4 * min(hits.shape[0], tail_cap)] = \
                hits[:tail_cap].reshape(-1)
        cids, flips = self._device_tables(s)
        _, rows, dim = face.frames.shape

        def program(u, tail):
            return device_detect(
                face.packed[0], face.coords, face.frames[0].reshape(-1),
                self.pupil.tensors, self.landmarks.tensors, u, cids, flips,
                hit_cap=face.cap, dense_cap=dense_cap, max_faces=s,
                iou_threshold=iou_threshold, perturbs=perturbs, rows=rows,
                cols=face.cols, dim=dim, angle=angle, tail=tail,
                tail_cap=tail_cap)

        if graphs is None:
            tail = (tail_host.to(self.device, non_blocking=True)
                    if host_tail else None)
            out = program(u_host.to(self.device, non_blocking=True), tail)
        else:
            graph, u, tail = graphs.program(
                (ticket.caps, perturbs, iou_threshold, angle, npts,
                 host_tail), n_uniforms, tail_cap if host_tail else None)
            if host_tail:
                tail.copy_(tail_host, non_blocking=True)
            u.copy_(u_host, non_blocking=True)
            out = graph.run(functools.partial(program, u, tail))
            profiling.count("stream.graph_replays")
        if self.device.type == "cuda":
            ticket.out = out_host.copy_(out, non_blocking=True)
            ticket.event = torch.cuda.Event()
            ticket.event.record(torch.cuda.current_stream(self.device))
        else:
            ticket.out = out

    def _collect_frame_device(self, ticket: _FrameTicket) -> list[FaceResult]:
        """Blocking half: one wait for the frame program's result, then the
        ladder (pigo_tpu/detector.py:931-998): a hit overflow (card or host
        tail) re-dispatches with DEV_CAPS_ESCALATED's hit caps, a face-slot
        overflow with the
        power-of-two slots that hold the frame's faces; a frame beyond the
        top rung runs `detect` on this detector's device with the frame's
        generator. Each rung is counted in `ladder`."""
        with profiling.span("stream.collect"):
            if ticket.out is None:
                return []
            with profiling.span("stream.wait"):
                if ticket.event is not None:
                    ticket.event.synchronize()
            self.ladder["device_frame_waits"] += 1
            out = ticket.out.numpy()
            caps = list(ticket.caps)
            s, npts = caps[2], ticket.npts
            n_faces = int(out[1])
            hit_ovf = out[0] > 0.0  # then n_faces is of a cut list
            face_ovf = not hit_ovf and n_faces > s
            if hit_ovf:
                caps[0] = max(DEV_CAPS_ESCALATED[0], caps[0])
                caps[1] = max(DEV_CAPS_ESCALATED[1], caps[1])
            elif face_ovf:
                self._recent_face_counts.append(n_faces)
                slots = 1 << (n_faces - 1).bit_length()
                if slots <= DEV_CAPS_ESCALATED[2]:
                    caps[2] = slots
            if hit_ovf or face_ovf:
                if tuple(caps) == ticket.caps:  # beyond the top rung
                    self.ladder["detect_fallbacks"] += 1
                    params, angle, iou_threshold, perturbs = ticket.args
                    frame = ticket.frame
                    gen = torch.Generator().manual_seed(ticket.seed)
                    return self.detect(
                        frame, frame.shape[-2], frame.shape[-1], params,
                        angle, iou_threshold, perturbs, generator=gen)
                if hit_ovf:
                    self.ladder["hit_cap_escalations"] += 1
                    self.ladder["tail_cap_escalations"] += int(out[0]) >> 1
                else:
                    self.ladder["face_slot_escalations"] += 1
                return self._collect_frame_device(
                    self._dispatch_frame_device(
                        ticket.frame, ticket.args, ticket.seed, ticket.slot,
                        tuple(caps)))
            faces = out[2:2 + 4 * s].reshape(s, 4)
            fvalid = out[2 + 4 * s:2 + 5 * s] > 0.0
            eyed = out[2 + 5 * s:2 + 6 * s] > 0.0
            post = out[2 + 6 * s:].reshape(3, 2 * s + s * npts)
            eyes = post[:, :2 * s]
            lmk = post[:, 2 * s:].reshape(3, s, npts)
            profiling.count("post.faces", int(eyed[fvalid].sum()))
            results = []
            for i in np.flatnonzero(fvalid):
                res = FaceResult(face=Detection(
                    row=int(faces[i, 0]), col=int(faces[i, 1]),
                    scale=int(faces[i, 2]), q=float(faces[i, 3])))
                if eyed[i]:
                    _attach_post(res, eyes, lmk, i, npts, ticket.args[3])
                results.append(res)
            self._recent_face_counts.append(len(results))
            return results
