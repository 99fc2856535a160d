"""Quaternion math on torch tensors: the port of
``pose3d_tpu/core/quaternion.py``.

Scalar-first (w, x, y, z) Hamilton quaternions, batched over every
leading axis; a vector rotates as q * (0, v) * q^-1 (the reference's
``q_conjugate``, ``q_mult``, ``qv_mult``).
"""

from __future__ import annotations

import torch


def q_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of (..., 4) scalar-first quaternions."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def q_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
    ], dim=-1)


def qv_mult(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) quaternions, broadcast over the
    leading axes."""
    qv = torch.cat([v.new_zeros(v.shape[:-1] + (1,)), v], dim=-1)
    return q_mult(q_mult(q, qv), q_conjugate(q))[..., 1:]


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions -> (..., 3, 3) rotation matrices."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * w * y + 2 * x * z,
        2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x,
        2 * x * z - 2 * w * y, 2 * w * x + 2 * y * z, 1 - 2 * x * x - 2 * y * y,
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))
