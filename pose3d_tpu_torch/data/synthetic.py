"""Synthetic Human3.6M-like poses for tests and runs without the dataset:
the port of ``pose3d_tpu/data/synthetic.py`` (``synthetic_poses_3d``,
``project_to_2d``, ``synthetic_h36m``, ``synthetic_frames``; numpy, the
same draws from the same seed; ``render_pose_frames``, in PyTorch on the
keypoints' device). 3D poses in camera space (metres, root 2.5-5.5 m
deep), 2D poses as pinhole projections divided by the 1000-pixel image
size."""

from __future__ import annotations

import numpy as np
import torch

from pose3d_tpu_torch.core import cameras
from pose3d_tpu_torch.core.skeleton import BONES, NUM_JOINTS

# Average H36M bone offsets (metres) from the root, per joint
_REST_POSE = np.array(
    [
        [0.0, 0.0, 0.0],       # root
        [-0.13, 0.0, 0.0],     # rhip
        [-0.14, 0.0, -0.45],   # rkne
        [-0.15, 0.0, -0.90],   # rank
        [0.13, 0.0, 0.0],      # lhip
        [0.14, 0.0, -0.45],    # lkne
        [0.15, 0.0, -0.90],    # lank
        [0.0, 0.02, 0.25],     # belly
        [0.0, 0.03, 0.50],     # neck
        [0.0, 0.08, 0.60],     # nose
        [0.0, 0.04, 0.70],     # head
        [0.15, 0.0, 0.47],     # lsho
        [0.30, 0.02, 0.28],    # lelb
        [0.42, 0.05, 0.10],    # lwri
        [-0.15, 0.0, 0.47],    # rsho
        [-0.30, 0.02, 0.28],   # relb
        [-0.42, 0.05, 0.10],   # rwri
    ],
    dtype=np.float32,
)


def synthetic_poses_3d(n_frames: int, seed: int = 0, jitter: float = 0.05) -> np.ndarray:
    """(N, 17, 3) float32 camera-frame poses: rest pose + noise + depth."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=jitter, size=(n_frames, NUM_JOINTS, 3)).astype(np.float32)
    root = np.zeros((n_frames, 1, 3), dtype=np.float32)
    root[:, 0, 0] = rng.uniform(-0.5, 0.5, n_frames)
    root[:, 0, 1] = rng.uniform(-0.3, 0.3, n_frames)
    root[:, 0, 2] = rng.uniform(2.5, 5.5, n_frames)
    # camera frame: x right, y down, z forward; the rest pose's up is -y
    pose = _REST_POSE[None].copy()
    pose = np.stack([pose[..., 0], -pose[..., 2], pose[..., 1]], axis=-1)
    return (pose + noise + root).astype(np.float32)


def project_to_2d(poses_3d: np.ndarray, camera: int = 0) -> np.ndarray:
    """Pinhole-project (N, 17, 3) poses with camera ``camera``'s
    intrinsics to (N, 17, 2) pixels / 1000."""
    f = cameras.FOCAL_LENGTH[camera]
    c = cameras.CENTER[camera]
    xy = poses_3d[..., :2] / np.clip(poses_3d[..., 2:], 1e-6, None)
    return ((xy * f + c) / 1000.0).astype(np.float32)


def synthetic_h36m(n_frames: int, seed: int = 0):
    """(kp2d (N, 17, 2), kp3d (N, 17, 3) metres), as the H36M reader
    returns them."""
    kp3d = synthetic_poses_3d(n_frames, seed=seed)
    return project_to_2d(kp3d, camera=seed % 4), kp3d


def synthetic_frames(n_frames: int, size: int = 256, seed: int = 0) -> np.ndarray:
    """(N, size, size, 3) float32 frames in [0, 1), as the reference's
    resized and normalised frames (256 x 256, /256): the same draws from
    the same seed as the JAX package's ``synthetic_frames``."""
    rng = np.random.default_rng(seed)
    return rng.random((n_frames, size, size, 3), dtype=np.float32)


# A fixed colour a joint (17, 3) in [0.35, 1), the JAX package's draws:
# distinct colours tell left from right, as a marker suit does
_JOINT_COLORS = np.random.default_rng(7).uniform(0.35, 1.0, (NUM_JOINTS, 3)).astype(np.float32)
_BONE_POINTS = 6  # interior Gaussian blobs a bone


def render_pose_frames(kp2d, generator: torch.Generator | None = None, size: int = 256,
                       sigma: float = 2.5, noise: float = 0.12) -> torch.Tensor:
    """(B, 17, 2) keypoints in [0, 1] -> (B, size, size, 3) f32 skeleton
    frames in [0, 1], on the keypoints' device: each joint a separable 2D
    Gaussian blob of width ``sigma`` px in its colour, each bone a chain of
    6 interior blobs (width 0.7 sigma, 0.4 x the mean of its joints'
    colours), summed by one einsum, plus ``noise`` x U[0, 1) drawn from
    ``generator`` (on that device), clipped to [0, 1]. The frames a
    detector can learn from, in place of a camera's."""
    kp = torch.as_tensor(kp2d, dtype=torch.float32)
    device, b = kp.device, kp.shape[0]
    a_idx = torch.tensor([e[0] for e in BONES], device=device)
    b_idx = torch.tensor([e[1] for e in BONES], device=device)
    ts = torch.linspace(0.0, 1.0, _BONE_POINTS + 2, device=device)[1:-1]
    pa, pb = kp[:, a_idx], kp[:, b_idx]
    bone_pts = (pa[:, :, None] + ts[None, None, :, None] * (pb - pa)[:, :, None]).reshape(b, -1, 2)
    colors = torch.from_numpy(_JOINT_COLORS).to(device)
    bone_col = (0.4 * (colors[a_idx] + colors[b_idx]) / 2.0).repeat_interleave(_BONE_POINTS, 0)

    pts = torch.cat([kp, bone_pts], dim=1) * size  # pixels
    cols = torch.cat([colors, bone_col], dim=0)     # (P, 3)
    widths = torch.cat([torch.full((kp.shape[1],), sigma, device=device),
                        torch.full((bone_pts.shape[1],), sigma * 0.7, device=device)])
    grid = torch.arange(size, dtype=torch.float32, device=device) + 0.5
    gx = torch.exp(-0.5 * ((grid[None, None] - pts[..., :1]) / widths[None, :, None]) ** 2)
    gy = torch.exp(-0.5 * ((grid[None, None] - pts[..., 1:]) / widths[None, :, None]) ** 2)
    # einsum may return a permuted view; the frames are (B, H, W, 3) in memory
    frames = torch.einsum("bpy,bpx,pc->byxc", gy, gx, cols).contiguous()
    if noise:
        if generator is None:
            raise ValueError("noise needs a torch.Generator on the keypoints' device")
        frames = frames + noise * torch.rand((b, size, size, 3), generator=generator,
                                             device=device)
    return frames.clamp(0.0, 1.0)
