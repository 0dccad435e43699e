"""Build-on-first-use for the port's CUDA kernels and its host engine.

Each CUDA library compiles with nvcc from `csrc/<name>.cu` (and the further
sources SOURCES lists for it) into a shared library with a plain C
interface and loads with ctypes (no PyTorch headers, so a build takes
seconds). Target `sm_90a` (Hopper). `--fmad=false` keeps every f32 product
and sum rounded separately, as the reference does.

Libraries go to `build/pigo_tpu_torch/` beside the package, named by a hash
of the sources, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header never loads a stale build. The
compiler's `-Xptxas -v` report (registers, spills) is kept beside each
library as `<name>.ptxas.txt`.

The host C++ engine (`native/pigo_native.cpp`) compiles with g++ and
NATIVE_FLAGS, the flags of the JAX package's native/Makefile, into the
same directory, named by a hash of its source and the flags
(`build_native`). `-ffp-contract=off` keeps its f32 products and sums
rounded separately, as the reference does. It never builds into the
repository's `native/`, where the JAX package builds and loads its own
library.

Every kernel goes through `launch`, which counts it in LAUNCHES by kernel
name; a thread inside `recording()` counts into its recorder instead (a
CUDA graph's capture, whose replays then add what it recorded).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "pigo_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# The host engine: its source, the compiler and its flags (native/Makefile).
NATIVE_SOURCE = os.path.join(PKG_DIR, "native", "pigo_native.cpp")
GXX = "g++"
NATIVE_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
                "-pthread", "-ffp-contract=off"]

# Libraries built from more than one source: name -> sources. The face
# kernels' entry points share one library and one binder (ops/face_cuda.py).
SOURCES = {"face_cascade": ("face_cascade.cu", "face_prefix.cu")}

# Loaded kernel libraries by name, and the launches made on the card by
# kernel name (always on, read by the tests and chip_smoke.py; clear() it
# to reset), both under _lock.
_libs: dict[str, ctypes.CDLL] = {}
LAUNCHES: collections.Counter = collections.Counter()
_lock = threading.Lock()
_local = threading.local()  # .recorder: this thread's open `recording`


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def sources(name: str) -> tuple[str, ...]:
    """The csrc/ files library `name` compiles."""
    return SOURCES.get(name, (name + ".cu",))


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [*sources(name), *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
            digest.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile library `name` unless a build of these exact sources exists.
    Returns the library path; raises RuntimeError with the compiler's
    output when nvcc fails."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    report = compile_library(
        [os.path.join(CSRC_DIR, f) for f in sources(name)], so)
    with open(os.path.join(BUILD_DIR, name + ".ptxas.txt"), "w") as fh:
        fh.write(report)
    return so


def compile_library(paths: list[str], so: str) -> str:
    """nvcc `paths` into the shared library `so` with NVCC_FLAGS; returns
    the compiler's report (stderr). Raises RuntimeError with it when nvcc
    fails."""
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {so}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return proc.stderr


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` output of the last build of library `name`."""
    with open(os.path.join(BUILD_DIR, name + ".ptxas.txt")) as fh:
        return fh.read()


def bind_library(lib: ctypes.CDLL, bind) -> ctypes.CDLL:
    """Set the argtypes and restypes of lib's pigo_cuda_error_string,
    which every kernel library has, then `bind(lib)` sets its own
    functions'. Returns lib."""
    lib.pigo_cuda_error_string.restype = ctypes.c_char_p
    lib.pigo_cuda_error_string.argtypes = [ctypes.c_int]
    bind(lib)
    return lib


def load(name: str, bind) -> ctypes.CDLL:
    """Build (at first use), load and bind library `name` (`bind_library`);
    cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = bind_library(ctypes.CDLL(build(name)), bind)
        return lib


def launch(lib: ctypes.CDLL, entry: str, args: tuple, device: torch.device,
           kernel: str) -> None:
    """lib.<entry>(*args, stream) on `device`'s current stream, counted as
    one launch of `kernel`; raises RuntimeError, named after the entry
    point without its `pigo_`, when it returns an error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.pigo_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"{entry.removeprefix('pigo_')} launch failed: {msg} ({rc})")
    count(kernel)


def count(kernel: str, n: int = 1) -> None:
    """Add n launches of `kernel` to this thread's open recording, or else
    to LAUNCHES."""
    recorder = getattr(_local, "recorder", None)
    if recorder is not None:
        recorder[kernel] += n
        return
    with _lock:
        LAUNCHES[kernel] += n


@contextlib.contextmanager
def recording():
    """Within it, this thread's launches count into the Counter it yields,
    not into LAUNCHES; other threads' count as before."""
    outer = getattr(_local, "recorder", None)
    _local.recorder = collections.Counter()
    try:
        yield _local.recorder
    finally:
        _local.recorder = outer


def native_library_path() -> str:
    digest = hashlib.sha256(" ".join(NATIVE_FLAGS).encode())
    with open(NATIVE_SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libpigo_native-{digest.hexdigest()[:12]}.so")


def build_native() -> str:
    """Compile the host engine with GXX unless a build of this exact source
    exists. Returns the library path; raises RuntimeError with the
    compiler's output when the compiler is missing or fails."""
    so = native_library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([GXX, *NATIVE_FLAGS, "-o", tmp, NATIVE_SOURCE],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{GXX} could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{GXX} failed for {so}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so
