"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of the package into one shared
library with a plain C interface, under ``pose3d_tpu_torch/_build/``,
named by a hash of the sources and flags: a changed source builds anew,
an unchanged one loads the library already built. Nothing is downloaded;
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_NVCC_TIMEOUT_S = 600


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "kernels of pose3d_tpu_torch cannot be built")


@functools.cache
def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libpose3d_kernels-{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the library's build, or '' where it was built by another process run."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=_NVCC_TIMEOUT_S)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first where it is missing."""
    so = library_path()
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lifter_trunk_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.lifter_trunk_launch.restype = i
    lib.pose3d_cuda_error_string.argtypes = [i]
    lib.pose3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().pose3d_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
