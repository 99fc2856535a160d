"""ctypes bindings for the port's C++ video decoder
(``pose3d_tpu_torch/native/video.cc``): the port's copy of the JAX
package's ``data/native_video.py``, on the port's own library.

The native side decodes a video container straight into the caller's
batch buffer: centre-crop square, resize, RGB, uint8 or /256 float32.
Where the library is not built (``python -m
pose3d_tpu_torch.data.native_build``) or does not load, the same functions
decode with python cv2, which uses the same codec and resize, so both
give the same pixels. cv2 is imported inside the functions that use it.
"""

from __future__ import annotations

import ctypes
import logging
import pathlib

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "libposevideo.so"
_lib = None
_log = logging.getLogger(__name__)


def _load_library():
    """CDLL the built library, once; never builds. A missing or unloadable
    library is logged once and gives None (the cv2 fallback)."""
    global _lib
    if _lib is not None:
        return _lib or None  # False: failed before; never retried per call
    if not _SO_PATH.exists():
        _lib = False
        _log.warning("native video library %s not built; falling back to python cv2 "
                     "(run `python -m pose3d_tpu_torch.data.native_build` to build it)",
                     _SO_PATH)
        return None
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError as e:
        _lib = False
        _log.warning("native video library failed to load (%s); falling back to python cv2", e)
        return None
    lib.vd_open.restype = ctypes.c_void_p
    lib.vd_open.argtypes = [ctypes.c_char_p]
    lib.vd_close.argtypes = [ctypes.c_void_p]
    lib.vd_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
    ]
    lib.vd_read_frames_u8.restype = ctypes.c_int
    lib.vd_read_frames_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vd_read_frames_f32.restype = ctypes.c_int
    lib.vd_read_frames_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.vd_extract_jpegs.restype = ctypes.c_int
    lib.vd_extract_jpegs.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_double]
    lib.vd_fps.restype = ctypes.c_double
    lib.vd_fps.argtypes = [ctypes.c_char_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_library() is not None


def _native_read(lib, handle, size: int, stride: int, want: int, dtype) -> np.ndarray:
    """Up to ``want`` frames from an open decoder: (n, size, size, 3), n <
    want only at the end of the video."""
    if dtype == np.uint8:
        buf = np.empty((want, size, size, 3), np.uint8)
        n = lib.vd_read_frames_u8(handle, size, stride, want,
                                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    else:
        buf = np.empty((want, size, size, 3), np.float32)
        n = lib.vd_read_frames_f32(handle, size, stride, want,
                                   buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return buf[:max(n, 0)]


def _cv2_frames(path: str, size: int, stride: int, dtype):
    """The python fallback: every ``stride``-th frame, centre-cropped
    square, resized to ``size`` (bilinear), RGB, uint8 or /256 float32."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path}")
    idx = 0
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                return
            idx += 1
            if (idx - 1) % stride:
                continue
            hh, ww = bgr.shape[:2]
            side = min(hh, ww)
            y0, x0 = (hh - side) // 2, (ww - side) // 2
            crop = bgr[y0:y0 + side, x0:x0 + side]
            if side != size:
                crop = cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
            rgb = cv2.cvtColor(crop, cv2.COLOR_BGR2RGB)
            yield rgb if dtype == np.uint8 else rgb.astype(np.float32) / 256.0
    finally:
        cap.release()


def stream_video_frames(path, size: int = 256, chunk: int = 64, stride: int = 1,
                        dtype=np.uint8):
    """Generator of (n, size, size, 3) frame chunks, n <= ``chunk`` (the
    last may be short): ``read_video_frames``' pixels, yielded as the
    decoder produces them, so that a caller can overlap decode with device
    work."""
    path = str(path)
    lib = _load_library()
    if lib is None:
        frames = []
        for frame in _cv2_frames(path, size, stride, dtype):
            frames.append(frame)
            if len(frames) == chunk:
                yield np.stack(frames)
                frames = []
        if frames:
            yield np.stack(frames)
        return
    h = lib.vd_open(path.encode())
    if not h:
        raise FileNotFoundError(f"cannot open video {path}")
    try:
        while True:
            buf = _native_read(lib, h, size, stride, chunk, dtype)
            if len(buf):
                yield buf
            if len(buf) < chunk:
                return
    finally:
        lib.vd_close(h)


def read_video_frames(path, size: int = 256, stride: int = 1, max_frames: int | None = None,
                      dtype=np.uint8) -> np.ndarray:
    """Decode a video to (N, size, size, 3) centre-cropped RGB frames,
    uint8 (normalised on the device) or float32 in [0, 1) (the /256
    convention); every ``stride``-th frame, at most ``max_frames``."""
    path = str(path)
    lib = _load_library()
    if lib is None:
        frames = []
        for frame in _cv2_frames(path, size, stride, dtype):
            if max_frames is not None and len(frames) >= max_frames:
                break
            frames.append(frame)
        return np.stack(frames) if frames else np.empty((0, size, size, 3), dtype)
    # chunked reads: container frame counts lie both ways (0 for some
    # encoders, too few for others), so they never size the allocation
    h = lib.vd_open(path.encode())
    if not h:
        raise FileNotFoundError(f"cannot open video {path}")
    chunks, total = [], 0
    try:
        while max_frames is None or total < max_frames:
            want = 256 if max_frames is None else min(256, max_frames - total)
            buf = _native_read(lib, h, size, stride, want, dtype)
            if len(buf):
                chunks.append(buf.copy() if len(buf) < want else buf)
                total += len(buf)
            if len(buf) < want:
                break
    finally:
        lib.vd_close(h)
    if not chunks:
        return np.empty((0, size, size, 3), dtype)
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


def extract_jpegs(path, out_dir, fps: float | None = None, quality: int = 95) -> int:
    """Dump fps-resampled frames as ``<out_dir>/%04d.jpg`` (1-based, the
    reference's ``run_ffmpeg`` layout; fps None keeps every frame); returns
    the frame count. Native only: ``pipeline.video.extract_frames`` falls
    back to cv2 where the library is absent."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native video library unavailable")
    step = 1.0
    if fps is not None:
        native_fps = lib.vd_fps(str(path).encode())
        if native_fps <= 0:
            native_fps = 30.0
        step = max(native_fps / fps, 1.0)
    n = lib.vd_extract_jpegs(str(path).encode(), str(out_dir).encode(), quality, step)
    if n < 0:
        raise FileNotFoundError(f"cannot open video {path}")
    return n
