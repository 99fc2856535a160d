"""ctypes bindings for the port's C++ image loader
(``pose3d_tpu_torch/native/loader.cc``): the port's copy of the JAX
package's ``data/native_loader.py``, on the port's own library.

The native side decodes JPEGs on a pool of threads and resizes them
(bilinear) straight into the batch buffer, as uint8 or /256 float32, with
no Python in the decode path. Where the library is not built (``python -m
pose3d_tpu_torch.data.native_build``) or does not load, ``decode_batch``
decodes with cv2 (``cv2.resize``: the same convention, not the same
interpolation to the bit) and ``parallel_gather`` with numpy. cv2 is
imported inside the function that uses it.
"""

from __future__ import annotations

import ctypes
import logging
import pathlib

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_SO_PATH = _NATIVE_DIR / "libposeloader.so"
_lib = None
_log = logging.getLogger(__name__)


def _load_library():
    """CDLL the built library, once; never builds. A missing or unloadable
    library is logged once and gives None (the fallbacks)."""
    global _lib
    if _lib is not None:
        return _lib or None
    if not _SO_PATH.exists():
        _lib = False
        _log.warning("native loader library %s not built; falling back to cv2 "
                     "(run `python -m pose3d_tpu_torch.data.native_build` to build it)",
                     _SO_PATH)
        return None
    try:
        lib = ctypes.CDLL(str(_SO_PATH))
    except OSError as e:
        _lib = False
        _log.warning("native loader library failed to load (%s); falling back to cv2", e)
        return None
    lib.pl_create.restype = ctypes.c_void_p
    lib.pl_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pl_destroy.argtypes = [ctypes.c_void_p]
    lib.pl_decode_batch.restype = ctypes.c_int
    lib.pl_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.pl_decode_batch_u8.restype = ctypes.c_int
    lib.pl_decode_batch_u8.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pl_gather_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_library() is not None


class NativeImageLoader:
    """JPEG files -> (N, S, S, 3) batches, decoded on ``n_threads`` threads
    (0: one a core)."""

    def __init__(self, image_size: int = 256, n_threads: int = 0):
        self.image_size = image_size
        self._lib = _load_library()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.pl_create(image_size, n_threads)

    def decode_batch(self, paths, dtype=np.float32) -> np.ndarray:
        """dtype float32: resized frames in [0, 1) (the /256 convention);
        dtype uint8: the resized pixels, normalised on the device. A file
        that does not decode gives a zero frame."""
        n, s = len(paths), self.image_size
        as_u8 = np.dtype(dtype) == np.uint8
        out = np.empty((n, s, s, 3), np.uint8 if as_u8 else np.float32)
        if self._handle is not None:
            arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
            if as_u8:
                self._lib.pl_decode_batch_u8(
                    self._handle, arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            else:
                self._lib.pl_decode_batch(
                    self._handle, arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            return out
        import cv2

        for i, p in enumerate(paths):
            img = cv2.imread(str(p))
            if img is None:
                out[i] = 0
                continue
            resized = cv2.resize(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), (s, s))
            out[i] = resized if as_u8 else resized.astype(np.float32) / 256.0
        return out

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            self._lib.pl_destroy(self._handle)
            self._handle = None


def parallel_gather(src: np.ndarray, indices: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """``src[indices]`` as float32, copied row by row on ``n_threads``
    threads (numpy where the library is absent)."""
    lib = _load_library()
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    if lib is None:
        return src[idx]
    row = int(np.prod(src.shape[1:]))
    dst = np.empty((len(idx),) + src.shape[1:], np.float32)
    lib.pl_gather_f32(src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx), row,
                      dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    return dst
