"""Build the port's CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source and all at once, and links them into one shared library with a
plain C interface, under ``pose3d_tpu_torch/_build/``, named by a hash of
the sources and flags: a changed source builds anew, an unchanged one
loads the library already built. Nothing is downloaded; a missing
``nvcc`` or a failed build raises.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


def _run(cmds: list[list[str]]) -> str:
    """Runs the commands side by side; returns their output, or raises
    with the first failure's."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd in cmds]
    try:
        outs = [p.communicate(timeout=_NVCC_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()  # no-op for a process that has ended
            p.wait()
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {p.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    sources = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)])
        log += _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built first where it is missing."""
    so = library_path()
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("lifter_trunk_launch", [p] * 7 + [i, i, i, i, p]),
                       ("attention_launch", [p, p, i, i, i, i, p]),
                       ("stblock_temporal_launch", [p, p, p, p, p, p, i, i, i, p]),
                       ("stblock_sequences_launch", [p, p, p, p, p, p, i, i, i, p]),
                       ("stblock_train_bwd_launch", [p] * 8 + [i, i, i, i, p]),
                       ("martinez_launch", [p, p, p, p, p, p, p, p, p, i, i, p]),
                       ("softargmax_nhwc_launch", [p, i, p, p, p] + [i] * 6 + [p]),
                       ("softargmax_nhwc_bwd_launch", [p, i, p, p, p, p] + [i] * 6 + [p]),
                       ("softargmax_volume_launch", [p, i, p, p] + [i] * 5 + [p]),
                       ("conv_decode_launch", [p] * 6 + [i] * 7 + [p]),
                       ("conv_decode_bwd_launch", [p] * 10 + [i] * 8 + [p]),
                       ("flash_fwd_launch", [p] * 3 + [ll] * 4 + [p, p] + [i] * 5 + [p]),
                       ("flash_bwd_dq_launch", [p] * 3 + [ll] * 4 + [p] * 5 + [i] * 5 + [p]),
                       ("flash_bwd_dkv_launch", [p] * 3 + [ll] * 4 + [p] * 5 + [i] * 5 + [p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i
    lib.stblock_train_bwd_workspace.argtypes = [i, i]
    lib.stblock_train_bwd_workspace.restype = ctypes.c_longlong
    lib.pose3d_cuda_error_string.argtypes = [i]
    lib.pose3d_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code other than 0."""
    if err != 0:
        msg = library().pose3d_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
