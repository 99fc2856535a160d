"""The keypoint and pose file formats of ``pose3d_tpu/pipeline/keypoints.py``.

Copies, not imports: that module pulls in ``pose3d_tpu.core``, which
imports JAX. The consolidated video JSON is a list of per-frame records
``{"image_id", "category_id", "keypoints": (17, 3) nested list of x, y,
confidence, "score"}``; the MotionBERT interchange format is a (T, 17, 3)
float32 ``.npy``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np


def load_video_json(path):
    """Consolidated video JSON -> ((T,17,2) keypoints px, (T,17) conf,
    (T,) scores)."""
    with open(path) as fh:
        records = json.load(fh)
    kp = np.asarray([r["keypoints"] for r in records], dtype=np.float32)
    scores = np.asarray([r["score"] for r in records], dtype=np.float32)
    return kp[..., :2], kp[..., 2], scores


def save_mb_npy(poses, out_path):
    """(T,17,3) float32 npy — the MotionBERT interchange format."""
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, np.asarray(poses, dtype=np.float32))


def load_mb_npy(path):
    """A (T,17,3) npy as float32; any other shape raises ValueError."""
    arr = np.load(path)
    if arr.ndim != 3 or arr.shape[1:] != (17, 3):
        raise ValueError(f"{path}: shape {arr.shape}, expected (T, 17, 3)")
    return arr.astype(np.float32)
