"""Synthetic Human3.6M-like poses, the traffic's keypoints: a frozen copy
of the port's ``data/synthetic.py`` (``synthetic_poses_3d``,
``project_to_2d``) with the camera tables it reads (``core/cameras.py``).
Numpy on the host; the same draws from the same seed."""

from __future__ import annotations

import numpy as np

N_JOINTS = 17

# Average Human3.6M bone offsets (metres) from the root, per joint
REST_POSE = np.array(
    [[0.0, 0.0, 0.0], [-0.13, 0.0, 0.0], [-0.14, 0.0, -0.45], [-0.15, 0.0, -0.90],
     [0.13, 0.0, 0.0], [0.14, 0.0, -0.45], [0.15, 0.0, -0.90], [0.0, 0.02, 0.25],
     [0.0, 0.03, 0.50], [0.0, 0.08, 0.60], [0.0, 0.04, 0.70], [0.15, 0.0, 0.47],
     [0.30, 0.02, 0.28], [0.42, 0.05, 0.10], [-0.15, 0.0, 0.47], [-0.30, 0.02, 0.28],
     [-0.42, 0.05, 0.10]], dtype=np.float32)

# Human3.6M's four cameras: principal points and focal lengths (pixels)
CENTER = np.array([[512.54150390625, 515.4514770507812], [508.8486328125, 508.0649108886719],
                   [519.8158569335938, 501.40264892578125],
                   [514.9682006835938, 501.88201904296875]])
FOCAL_LENGTH = np.array([[1145.0494384765625, 1143.7811279296875],
                         [1149.6756591796875, 1147.5916748046875],
                         [1149.1407470703125, 1148.7989501953125],
                         [1145.5113525390625, 1144.77392578125]])


def synthetic_poses_3d(n_frames: int, rng: np.random.Generator,
                       jitter: float = 0.05) -> np.ndarray:
    """(N, 17, 3) float32 camera-frame poses: rest pose + noise + a root
    2.5-5.5 m deep."""
    noise = rng.normal(scale=jitter, size=(n_frames, N_JOINTS, 3)).astype(np.float32)
    root = np.zeros((n_frames, 1, 3), dtype=np.float32)
    root[:, 0, 0] = rng.uniform(-0.5, 0.5, n_frames)
    root[:, 0, 1] = rng.uniform(-0.3, 0.3, n_frames)
    root[:, 0, 2] = rng.uniform(2.5, 5.5, n_frames)
    # camera frame: x right, y down, z forward; the rest pose's up is -y
    pose = REST_POSE[None].copy()
    pose = np.stack([pose[..., 0], -pose[..., 2], pose[..., 1]], axis=-1)
    return (pose + noise + root).astype(np.float32)


def project_to_2d(poses_3d: np.ndarray, camera: int = 0) -> np.ndarray:
    """Pinhole projection of (N, 17, 3) poses through ``camera`` to
    (N, 17, 2) pixels / 1000."""
    xy = poses_3d[..., :2] / np.clip(poses_3d[..., 2:], 1e-6, None)
    return ((xy * FOCAL_LENGTH[camera] + CENTER[camera]) / 1000.0).astype(np.float32)
