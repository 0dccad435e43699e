"""ctypes bindings for the port's host C++ engine (native/pigo_native.cpp).

The counterpart of pigo_tpu/native/__init__.py, with the same names, over
the port's own copy of the engine. It serves three roles:

  1. the host tail engine of the face stage (models/face.FaceCascade with
     host_tail=True scans its sparse tail scales here, overlapped with the
     card),
  2. an independent oracle for the card's kernels (a second implementation
     of the scalar semantics, bit for bit),
  3. host-side clustering (`native_cluster`) and grayscale conversion.

The shared object is built with g++ at first use into build/pigo_tpu_torch/
(utils/build.build_native), never into the repository's native/. The scan
pool's thread count and the AVX-512 paths are arguments (`threads=`,
`simd=`), not environment variables. Every failure to build or load
raises NativeUnavailable: nothing in the port switches paths quietly when
the engine is missing.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from pigo_tpu_torch.utils import build

# Loaded engines by build configuration (the only module state): a process
# builds and loads the engine once, not once per call of native_cluster.
_libs: dict[tuple, ctypes.CDLL] = {}
_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    """Raised when the native engine cannot be built or loaded."""


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i, i64, d = ctypes.c_int, ctypes.c_int64, ctypes.c_double

    lib.pigo_face_new.restype = ctypes.c_void_p
    lib.pigo_face_new.argtypes = [u8p, i64, i, ctypes.c_char_p, i64]
    lib.pigo_face_free.argtypes = [ctypes.c_void_p]
    lib.pigo_face_depth.restype = i
    lib.pigo_face_depth.argtypes = [ctypes.c_void_p]
    lib.pigo_face_trees.restype = i
    lib.pigo_face_trees.argtypes = [ctypes.c_void_p]
    lib.pigo_classify_region.restype = ctypes.c_float
    lib.pigo_classify_region.argtypes = [
        ctypes.c_void_p, i, i, i, u8p, i, i, d]
    lib.pigo_face_run.restype = i64
    lib.pigo_face_run.argtypes = [
        ctypes.c_void_p, u8p, i, i, i, i, i, d, d, d, i, f64p, i64]
    lib.pigo_face_run_scales.restype = i64
    lib.pigo_face_run_scales.argtypes = [
        ctypes.c_void_p, u8p, i, i, i, i32p, i64, d, d, i, f64p, i64]
    lib.pigo_classify_batch.argtypes = [
        ctypes.c_void_p, u8p, i, i, i32p, i64, d, f32p]
    lib.pigo_face_run_band.restype = i64
    lib.pigo_face_run_band.argtypes = [
        ctypes.c_void_p, u8p, i, i, i, i32p, i64, d, d, f64p, i64]
    lib.pigo_cluster.restype = i64
    lib.pigo_cluster.argtypes = [f64p, i64, d, f64p, i64]
    lib.pigo_find_faces.restype = i64
    lib.pigo_find_faces.argtypes = [
        ctypes.c_void_p, u8p, i, i, i, i, d, d, d, d, d, i, i64p, i64]
    lib.pigo_pupil_new.restype = ctypes.c_void_p
    lib.pigo_pupil_new.argtypes = [u8p, i64, i, ctypes.c_char_p, i64]
    lib.pigo_pupil_free.argtypes = [ctypes.c_void_p]
    lib.pigo_pupil_stages.restype = i
    lib.pigo_pupil_stages.argtypes = [ctypes.c_void_p]
    lib.pigo_pupil_jitter.argtypes = [d, d, d, i, ctypes.c_uint64, f32p]
    lib.pigo_pupil_run.argtypes = [
        ctypes.c_void_p, f32p, i64, u8p, i, i, i, d, i, f64p]
    lib.pigo_landmark_run.argtypes = [
        ctypes.c_void_p, d, d, d, d, i, ctypes.c_uint64, u8p, i, i, i, d, i,
        f64p]
    lib.pigo_grayscale.argtypes = [u8p, i64, i, u8p]
    lib.pigo_simd_available.restype = i
    lib.pigo_version.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the engine. Thread-safe, cached.

    Raises NativeUnavailable on every failure (no compiler, a failed
    build, a library that does not load)."""
    key = (build.NATIVE_SOURCE, build.BUILD_DIR, build.GXX,
           tuple(build.NATIVE_FLAGS))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            try:
                path = build.build_native()
            except (OSError, RuntimeError) as e:
                raise NativeUnavailable(f"native build failed: {e}") from e
            try:
                lib = ctypes.CDLL(path)
                _bind(lib)
            except (OSError, AttributeError) as e:
                raise NativeUnavailable(f"native load failed: {e}") from e
            _libs[key] = lib
        return lib


def simd_available() -> bool:
    """True when the engine's AVX-512 paths can run on this CPU."""
    return bool(load_library().pigo_simd_available())


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _grow(call) -> np.ndarray:
    """Rows (row, col, scale, q) f64 [N, 4] of an entry point that writes
    up to `cap` of them and returns how many it found: retried with a
    buffer that holds them all when it did not."""
    cap = 4096
    while True:
        out = np.empty((cap, 4), dtype=np.float64)
        n = call(_f64ptr(out), cap)
        if n <= cap:
            return out[:n].copy()
        cap = int(n)


def _asset(name: str) -> bytes:
    from pigo_tpu_torch.cascade.assets import asset_path

    with open(asset_path("cascade", name), "rb") as fh:
        return fh.read()


class NativeFaceCascade:
    """Host CPU face detector over the frozen cascade binaries.

    Mirrors models.face.FaceCascade's run_cascade/detect surface. `threads`
    bounds the scan pool of run_cascade, run_scales and find_faces (None:
    min(hardware threads, 16)); `simd=False` keeps every call on the scalar
    paths (the AVX-512 paths also need a CPU that has them)."""

    def __init__(self, data: bytes | None = None, *,
                 threads: int | None = None, simd: bool = True):
        self._lib = load_library()
        if data is None:
            data = _asset("facefinder")
        if threads is not None and threads < 1:
            raise ValueError(f"threads must be >= 1 or None, got {threads}")
        self.threads = 0 if threads is None else int(threads)
        self.simd = bool(simd)
        buf = np.frombuffer(data, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.pigo_face_new(_u8ptr(buf), buf.size,
                                          int(self.simd), err, 256)
        if not self._h:
            raise ValueError(err.value.decode() or "invalid face cascade")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pigo_face_free(h)
            self._h = None

    @property
    def depth(self) -> int:
        return self._lib.pigo_face_depth(self._h)

    @property
    def num_trees(self) -> int:
        return self._lib.pigo_face_trees(self._h)

    @property
    def simd_active(self) -> bool:
        """True when this cascade's scans take the AVX-512 paths."""
        return self.simd and bool(self._lib.pigo_simd_available())

    def classify_region(self, row: int, col: int, scale: int,
                        pixels: np.ndarray, nrows: int, dim: int,
                        angle: float = 0.0) -> float:
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        return float(self._lib.pigo_classify_region(
            self._h, row, col, scale, _u8ptr(pix), nrows, dim, angle))

    def run_cascade(self, pixels: np.ndarray, rows: int, cols: int,
                    dim: int | None = None, *, min_size: int = 20,
                    max_size: int = 1000, shift_factor: float = 0.1,
                    scale_factor: float = 1.1,
                    angle: float = 0.0) -> np.ndarray:
        dim = cols if dim is None else dim
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        return _grow(lambda out, cap: self._lib.pigo_face_run(
            self._h, _u8ptr(pix), rows, cols, dim, min_size, max_size,
            shift_factor, scale_factor, angle, self.threads, out, cap))

    def run_scales(self, pixels: np.ndarray, rows: int, cols: int,
                   scales: np.ndarray, *, dim: int | None = None,
                   shift_factor: float = 0.1,
                   angle: float = 0.0) -> np.ndarray:
        """Scan an explicit scale list -> [N, 4] (row, col, scale, q)."""
        dim = cols if dim is None else dim
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        sc = np.ascontiguousarray(scales, dtype=np.int32)
        return _grow(lambda out, cap: self._lib.pigo_face_run_scales(
            self._h, _u8ptr(pix), rows, cols, dim,
            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), sc.size,
            shift_factor, angle, self.threads, out, cap))

    def classify_batch(self, pixels: np.ndarray, rows: int, dim: int,
                       windows: np.ndarray, angle: float = 0.0) -> np.ndarray:
        """Exact scores f32 [N] for windows int32 [N, 3] (row, col, scale)."""
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        w = np.ascontiguousarray(windows, dtype=np.int32).reshape(-1, 3)
        out = np.empty(w.shape[0], dtype=np.float32)
        self._lib.pigo_classify_batch(
            self._h, _u8ptr(pix), rows, dim,
            w.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), w.shape[0],
            angle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def run_band(self, pixels: np.ndarray, rows: int, cols: int,
                 bands: np.ndarray, *, dim: int | None = None,
                 shift_factor: float = 0.1,
                 angle: float = 0.0) -> np.ndarray:
        """Scan border bands: int32 [B, 5] rows (scale, r_lo, r_hi, c_lo,
        c_hi) — each scale's full grid excluding the inclusive interior
        window rectangle. -> [N, 4] (row, col, scale, q)."""
        dim = cols if dim is None else dim
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        bd = np.ascontiguousarray(bands, dtype=np.int32).reshape(-1, 5)
        return _grow(lambda out, cap: self._lib.pigo_face_run_band(
            self._h, _u8ptr(pix), rows, cols, dim,
            bd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), bd.shape[0],
            shift_factor, angle, out, cap))

    def detect(self, pixels: np.ndarray, rows: int, cols: int,
               dim: int | None = None, *, iou_threshold: float = 0.2,
               **kw) -> np.ndarray:
        dets = self.run_cascade(pixels, rows, cols, dim, **kw)
        return native_cluster(dets, iou_threshold)

    def find_faces(self, pixels: np.ndarray, rows: int, cols: int, *,
                   min_size: int = 20, max_size: int = 1000,
                   shift_factor: float = 0.1, scale_factor: float = 1.1,
                   angle: float = 0.0, iou_threshold: float = 0.2,
                   q_thresh: float = 5.0) -> np.ndarray:
        """cgo-bridge-shaped one-call pipeline -> int64 [N, 3]
        (row, col, scale)."""
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        faces = 1024
        while True:
            cap = 1 + 3 * faces
            out = np.zeros(cap, dtype=np.int64)
            n = int(self._lib.pigo_find_faces(
                self._h, _u8ptr(pix), rows, cols, min_size, max_size,
                shift_factor, scale_factor, angle, iou_threshold, q_thresh,
                self.threads,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap))
            if n <= faces:
                return out[1:1 + 3 * n].reshape(n, 3).copy()
            faces = n


class NativePupilLocalizer:
    """Host CPU pupil/landmark localizer (regression forest ensemble);
    `simd=False` keeps its walks on the scalar path."""

    def __init__(self, data: bytes | None = None, *, simd: bool = True):
        self._lib = load_library()
        if data is None:
            data = _asset("puploc")
        self.simd = bool(simd)
        buf = np.frombuffer(data, dtype=np.uint8)
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.pigo_pupil_new(_u8ptr(buf), buf.size,
                                           int(self.simd), err, 256)
        if not self._h:
            raise ValueError(err.value.decode() or "invalid pupil cascade")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pigo_pupil_free(h)
            self._h = None

    @property
    def stages(self) -> int:
        return self._lib.pigo_pupil_stages(self._h)

    def jitter(self, row: float, col: float, scale: float, perturbs: int,
               seed: int = 0) -> np.ndarray:
        starts = np.empty((perturbs, 3), dtype=np.float32)
        self._lib.pigo_pupil_jitter(
            row, col, scale, perturbs, seed,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return starts

    def run_detector(self, starts: np.ndarray, pixels: np.ndarray,
                     nrows: int, ncols: int, dim: int | None = None, *,
                     angle: float = 0.0,
                     flip_v: bool = False) -> tuple[int, int, float]:
        """Ensemble walk + median vote from explicit [P, 3] start triples."""
        dim = ncols if dim is None else dim
        starts = np.ascontiguousarray(starts, dtype=np.float32)
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        out3 = np.zeros(3, dtype=np.float64)
        self._lib.pigo_pupil_run(
            self._h,
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            starts.shape[0], _u8ptr(pix), nrows, ncols, dim, angle,
            1 if flip_v else 0, _f64ptr(out3))
        return int(out3[0]), int(out3[1]), float(out3[2])

    def landmark(self, left: tuple[float, float], right: tuple[float, float],
                 pixels: np.ndarray, nrows: int, ncols: int,
                 dim: int | None = None, *, perturbs: int = 63,
                 seed: int = 0, angle: float = 0.0,
                 flip_v: bool = False) -> tuple[int, int, float]:
        """Landmark anchor geometry from the two pupils + ensemble vote."""
        dim = ncols if dim is None else dim
        pix = np.ascontiguousarray(pixels, dtype=np.uint8).ravel()
        out3 = np.zeros(3, dtype=np.float64)
        self._lib.pigo_landmark_run(
            self._h, left[0], left[1], right[0], right[1], perturbs, seed,
            _u8ptr(pix), nrows, ncols, dim, angle, 1 if flip_v else 0,
            _f64ptr(out3))
        return int(out3[0]), int(out3[1]), float(out3[2])


def native_cluster(dets: np.ndarray, iou_threshold: float) -> np.ndarray:
    """IoU clustering on host (reference core/pigo.go:262-308 semantics):
    the same clusters, bit for bit, as ops/cluster.cluster_detections."""
    lib = load_library()
    d = np.ascontiguousarray(dets, dtype=np.float64).reshape(-1, 4)
    out = np.empty_like(d)
    m = lib.pigo_cluster(_f64ptr(d), d.shape[0], iou_threshold, _f64ptr(out),
                         d.shape[0])
    return out[:m].copy()


def native_grayscale(img: np.ndarray) -> np.ndarray:
    """Exact reference grayscale conversion -> flat uint8 [H*W]."""
    lib = load_library()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        return img.ravel().copy()
    channels = img.shape[-1]
    npix = img.size // channels
    out = np.empty(npix, dtype=np.uint8)
    lib.pigo_grayscale(_u8ptr(img.reshape(-1)), npix, channels, _u8ptr(out))
    return out
