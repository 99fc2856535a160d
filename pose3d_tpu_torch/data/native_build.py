"""Explicit build of the port's native C++ libraries: the port's copy of
the JAX package's ``data/native_build.py``, building
``pose3d_tpu_torch/native/`` into that directory.

The bindings (``data/native_loader.py``, ``data/native_video.py``) only
``CDLL`` a library that already exists and otherwise fall back to cv2 with
a one-time warning: they never run the compiler as a side effect of a
decode call (a slow or broken toolchain would make the first call
unpredictable). Build explicitly instead:

    python -m pose3d_tpu_torch.data.native_build

or from code and test fixtures with :func:`ensure_built`. The JPEG loader
needs g++ and libjpeg; the video decoder also needs OpenCV's C++ headers
and may be absent.
"""

from __future__ import annotations

import pathlib
import subprocess

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
LIBRARIES = ("libposeloader.so", "libposevideo.so")


def ensure_built(force: bool = False) -> bool:
    """Run ``native/build.sh`` unless both libraries exist (or ``force``).
    Returns whether the loader library exists afterwards; raises
    RuntimeError with the compiler's output when the build fails."""
    have = [(NATIVE_DIR / name).exists() for name in LIBRARIES]
    if all(have) and not force:
        return True
    proc = subprocess.run(["sh", str(NATIVE_DIR / "build.sh")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed (rc={proc.returncode}):\n{proc.stderr}")
    return (NATIVE_DIR / LIBRARIES[0]).exists()


if __name__ == "__main__":
    ok = ensure_built(force=True)
    for name in LIBRARIES:
        print(f"{name}: {'built' if (NATIVE_DIR / name).exists() else 'MISSING'}")
    raise SystemExit(0 if ok else 1)
