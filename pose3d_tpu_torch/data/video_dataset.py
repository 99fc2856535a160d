"""Video-frame dataset with MotionBERT pseudo-ground-truth (phase 4): the
port of ``pose3d_tpu/data/video_dataset.py`` (numpy and OpenCV, no
framework).

Reference contract (``phase4_joined/Custom_Video_dataset.py:32-78``):
frames come from the phase-2 ``ffmpeg_frames/<video>/`` extraction,
labels from the ``MB_npy/<video>.npy`` (T, 17, 3) pseudo-GT; poses are
zero-centred (:55-58); frames get a centre square crop, then a 256^2
resize and /256 (:68-76); items are (zeros(17, 2), pose, frame).
OpenCV is imported by the loader only, so the trainer imports where it
is absent.
"""

from __future__ import annotations

import pathlib

import numpy as np


def load_video_dataset(pipeline_root, video: str, size: int = 256,
                       zero_centre: bool = True):
    """-> (kp2d zeros (N, 17, 2), poses (N, 17, 3), frames (N, size, size,
    3) f32 in [0, 1)), N the fewer of the JPEG frames and the poses."""
    import cv2

    root = pathlib.Path(pipeline_root)
    poses = np.load(root / "MB_npy" / f"{video}.npy").astype(np.float32)
    if zero_centre:
        poses = poses - poses[:, :1]
    files = sorted((root / "ffmpeg_frames" / video).glob("*.jpg"))
    n = min(len(files), len(poses))
    frames = np.zeros((n, size, size, 3), np.float32)
    for i, f in enumerate(files[:n]):
        img = cv2.cvtColor(cv2.imread(str(f)), cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        side = min(h, w)  # centre square crop (Custom_Video_dataset.py:68-72)
        top, left = (h - side) // 2, (w - side) // 2
        img = img[top:top + side, left:left + side]
        frames[i] = cv2.resize(img, (size, size)).astype(np.float32) / 256.0
    return np.zeros((n, 17, 2), np.float32), poses[:n], frames
