"""Detection-JSON merge, the COCO -> H36M remap and the pose file formats:
the port of ``pose3d_tpu/pipeline/keypoints.py``.

Copies, not imports: that module pulls in ``pose3d_tpu.core``, which
imports JAX. The reference's ``save_to_json`` (``phase2_opp_mb/run.py:
60-110``) takes, for each per-frame detector JSON, the person of highest
score, remaps its keypoints COCO -> H36M, and appends ``{"image_id": <file
name>, "category_id": 1, "keypoints": (17, 3) nested list of x, y,
confidence, "score"}``: one consolidated JSON a video, a frame with no
person giving zero keypoints and score 0. The MotionBERT interchange
format is a (T, 17, 3) float32 ``.npy``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from pose3d_tpu_torch.core.cameras import extrinsics
from pose3d_tpu_torch.core.quaternion import quat_to_rotmat
from pose3d_tpu_torch.core.skeleton import coco_to_h36m


def merge_detections(json_dir, already_h36m: bool = False) -> list[dict]:
    """The per-frame prediction JSONs of ``json_dir``, in name order ->
    the reference's records (``already_h36m``: the keypoints are in H36M
    order already, as ``PoseNet2DDetector`` writes them)."""
    records = []
    for f in sorted(pathlib.Path(json_dir).glob("*.json")):
        with open(f) as fh:
            people = json.load(fh)
        kp = np.zeros((17, 3))
        score = 0.0
        if people:
            best = max(people, key=lambda p: p.get("score", 0.0))
            score = float(best.get("score", 0.0))
            kp = np.asarray(best["keypoints"], dtype=np.float64).reshape(17, 3)
            if not already_h36m:
                kp[:, :2] = coco_to_h36m(kp[:, :2])
        records.append({"image_id": f.name, "category_id": 1, "keypoints": kp.tolist(),
                        "score": score})
    return records


def save_to_json(json_dir, out_path, already_h36m: bool = False) -> list[dict]:
    """``merge_detections`` written to ``out_path`` as one JSON list."""
    records = merge_detections(json_dir, already_h36m)
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(records, fh)
    return records


def load_video_json(path):
    """Consolidated video JSON -> ((T,17,2) keypoints px, (T,17) conf,
    (T,) scores)."""
    with open(path) as fh:
        records = json.load(fh)
    kp = np.asarray([r["keypoints"] for r in records], dtype=np.float32)
    scores = np.asarray([r["score"] for r in records], dtype=np.float32)
    return kp[..., :2], kp[..., 2], scores


def rotate_to_global(poses, subject: str = "S1", camera: int = 2) -> np.ndarray:
    """Camera-frame (T, 17, 3) poses -> the global frame, ``poses @ R.T``
    with R from the H36M camera's orientation quaternion (the reference's
    ``create_3d_mp4``, ``run.py:305-335``); R in f32, as the JAX package
    computes it."""
    q, _ = extrinsics(subject, camera)
    r = quat_to_rotmat(torch.as_tensor(q, dtype=torch.float32)).numpy()
    return np.asarray(poses) @ r.T


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
