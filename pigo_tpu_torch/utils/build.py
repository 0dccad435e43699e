"""Build-on-first-use for the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface and loads with ctypes (no PyTorch headers, so a build takes
seconds). Target `sm_90a` (Hopper). `--fmad=false` keeps every f32 product
and sum rounded separately, as the reference does.

Libraries go to `build/pigo_tpu_torch/` beside the package, named by a hash
of the source and flags, so an edited source never loads a stale build. The
compiler's `-Xptxas -v` report (registers, spills) is kept beside each
library as `<name>.ptxas.txt`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "pigo_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Loaded kernel libraries by source name (the only module state).
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless a build of this exact source exists.
    Returns the library path; raises RuntimeError with the compiler's
    output when nvcc fails."""
    so = library_path(name)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    with open(os.path.join(BUILD_DIR, name + ".ptxas.txt"), "w") as fh:
        fh.write(proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` output of the last build of csrc/<name>.cu."""
    with open(os.path.join(BUILD_DIR, name + ".ptxas.txt")) as fh:
        return fh.read()


def load(name: str, bind) -> ctypes.CDLL:
    """Build (at first use) and load csrc/<name>.cu, then `bind(lib)` sets
    its functions' argtypes and restypes; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
        return lib
