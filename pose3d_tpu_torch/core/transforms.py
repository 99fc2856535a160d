"""Pose-space transforms on torch tensors: the port of
``pose3d_tpu/core/transforms.py``.

- ``flip_pose``: a horizontal flip; 2D poses live in [0, 1] image
  coordinates, so x' = 1 - x, 3D poses are metric, so x' = -x; then the
  left and right joints swap.
- ``world_to_camera``: subtract the camera position (mm -> m), rotate by
  the camera's orientation quaternion.
- ``zero_centre``: every joint minus the root.
- ``flip_heatmap``, ``flip_xyz_joints``, ``flip_thetas``, ``flip_twist``:
  the flips of the reference's HybrIK utilities, with their joint pairs.
- ``camera_projection``: a pinhole projection to pixels.

Every function works over any leading batch axes, on any device.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.core.quaternion import qv_mult
from pose3d_tpu_torch.core.skeleton import FLIP_PERMUTATION


def _swap(n: int, pairs, offset: int = 0) -> list[int]:
    perm = list(range(n))
    for a, b in pairs:
        perm[a - offset], perm[b - offset] = perm[b - offset], perm[a - offset]
    return perm


def _take(x: torch.Tensor, perm, dim: int) -> torch.Tensor:
    return x.index_select(dim, torch.as_tensor(perm, device=x.device))


def flip_pose(pose: torch.Tensor) -> torch.Tensor:
    """Horizontally flip (..., 17, 2) or (..., 17, 3) poses."""
    dim = pose.shape[-1]
    if dim == 2:
        x = 1.0 - pose[..., :1]
    elif dim == 3:
        x = -pose[..., :1]
    else:
        raise ValueError(f"expected last dim 2 or 3, got {dim}")
    return _take(torch.cat([x, pose[..., 1:]], dim=-1), FLIP_PERMUTATION, -2)


def world_to_camera(points: torch.Tensor, orientation: torch.Tensor,
                    translation_mm: torch.Tensor) -> torch.Tensor:
    """World-frame (..., 3) points -> the camera frame: ``orientation``
    (..., 4) scalar-first quaternions, ``translation_mm`` (..., 3) camera
    positions in millimetres (divided by 1000 as the reference does)."""
    return qv_mult(orientation, points - translation_mm / 1000.0)


def zero_centre(pose: torch.Tensor) -> torch.Tensor:
    """Root-centre (..., 17, D) poses: every joint minus the root (which
    becomes 0)."""
    return pose - pose[..., :1, :]


def flip_heatmap(heatmap: torch.Tensor, pairs, shift: bool = False) -> torch.Tensor:
    """Horizontally flip (..., J, H, W) heatmaps and swap the joint channels
    of ``pairs``; ``shift`` rolls the flipped map right by one pixel."""
    out = _take(heatmap.flip(-1), _swap(heatmap.shape[-3], pairs), -3)
    return torch.roll(out, 1, dims=-1) if shift else out


def flip_xyz_joints(xyz: torch.Tensor, pairs) -> torch.Tensor:
    """Flip metric (..., J, 3) joints: negate x, swap ``pairs``."""
    out = xyz * xyz.new_tensor([-1.0, 1.0, 1.0])
    return _take(out, _swap(xyz.shape[-2], pairs), -2)


def flip_thetas(thetas: torch.Tensor, pairs) -> torch.Tensor:
    """Flip (..., J, 3) axis-angle rotations: negate y and z, swap ``pairs``."""
    out = thetas * thetas.new_tensor([1.0, -1.0, -1.0])
    return _take(out, _swap(thetas.shape[-2], pairs), -2)


def flip_twist(phis: torch.Tensor, pairs) -> torch.Tensor:
    """Flip (..., 23, 2) twists (cos, sin): negate sin, swap ``pairs``,
    which count from joint 1."""
    out = phis * phis.new_tensor([1.0, -1.0])
    return _take(out, _swap(phis.shape[-2], pairs, offset=1), -2)


def camera_projection(points_cam: torch.Tensor, focal: torch.Tensor,
                      center: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame (..., 3) points to pixels;
    ``focal`` and ``center`` (..., 2)."""
    xy = points_cam[..., :2] / points_cam[..., 2:].clamp_min(1e-6)
    return xy * focal + center
