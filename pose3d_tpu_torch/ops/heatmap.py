"""Volumetric soft-argmax decodes: the port of ``soft_argmax_3d`` and
``soft_argmax_3d_nhwc`` of ``pose3d_tpu/ops/heatmap.py``, in plain
PyTorch (the JAX package leaves them to XLA).

Both take a softmax over one joint's D x H x W volume of logits, with the
maximum subtracted first and in at least f32, and return the expected
index along each axis, rescaled as the reference does (``Model.py``
175-177): x over W and y over H to ``(E / n - 0.5) * xy_scale``, z over D
to ``(E / D - 0.5) * z_scale``. Coordinates come out (B, J*3) as
[x, y, z] per joint. Both are differentiable: the training route of
``PoseNet3D`` decodes through ``soft_argmax_3d_nhwc``.

``heatmap_targets``, ``soft_argmax_2d``, ``hard_argmax_2d`` and
``norm_heatmap`` come with the slices that read them.
"""

from __future__ import annotations

import torch

GRID = 64


def coords_from_expectations(e: torch.Tensor, height: int, width: int, depth: int,
                             z_scale: float = 2.5, xy_scale: float = 2.0) -> torch.Tensor:
    """(B, J, 3) raw index expectations [Ex, Ey, Ez] -> (B, J*3) coordinates
    with the reference scaling."""
    cx = (e[..., 0] / width - 0.5) * xy_scale
    cy = (e[..., 1] / height - 0.5) * xy_scale
    cz = (e[..., 2] / depth - 0.5) * z_scale
    return torch.stack([cx, cy, cz], dim=-1).reshape(e.shape[0], -1)


def nhwc_expectations(logits_nhwc: torch.Tensor, num_joints: int,
                      depth: int) -> torch.Tensor:
    """(B, H, W, J*D) logits, channel ``j*D + d`` -> (B, J, 3) f32 index
    expectations [Ex over W, Ey over H, Ez over D] of each joint's softmax,
    maximum subtracted, in at least f32."""
    b, h, w, c = logits_nhwc.shape
    if c != num_joints * depth:
        raise ValueError(f"{c} channels are not {num_joints} joints x depth {depth}")
    acc = torch.promote_types(logits_nhwc.dtype, torch.float32)
    x = logits_nhwc.reshape(b, h * w, num_joints, depth).to(acc)
    p = torch.exp(x - x.amax(dim=(1, 3), keepdim=True))
    per_pixel = p.sum(dim=3)                       # (B, H*W, J)
    per_depth = p.sum(dim=1)                       # (B, J, D)
    s = per_depth.sum(dim=2)
    idx = torch.arange(h * w, device=x.device)
    xi = (idx % w).to(acc)
    yi = (idx // w).to(acc)
    di = torch.arange(depth, device=x.device, dtype=acc)
    ex = torch.einsum("bpj,p->bj", per_pixel, xi)
    ey = torch.einsum("bpj,p->bj", per_pixel, yi)
    ez = per_depth @ di
    return torch.stack([ex, ey, ez], dim=-1) / s[..., None]


def soft_argmax_3d_nhwc(logits_nhwc: torch.Tensor, num_joints: int = 17,
                        depth: int = GRID, z_scale: float = 2.5,
                        xy_scale: float = 2.0) -> torch.Tensor:
    """Volumetric soft-argmax straight off the conv head's (B, H, W, J*D)
    output, without the (B, J, D, H, W) transpose: (B, J*3) coordinates."""
    _, h, w, _ = logits_nhwc.shape
    e = nhwc_expectations(logits_nhwc, num_joints, depth)
    return coords_from_expectations(e, h, w, depth, z_scale, xy_scale)


def soft_argmax_3d(logits: torch.Tensor, num_joints: int = 17, depth: int = GRID,
                   height: int = GRID, width: int = GRID, z_scale: float = 2.5,
                   xy_scale: float = 2.0, return_heatmap: bool = True):
    """Volumetric soft-argmax (the reference ``Model_3D`` decode).

    logits: (B, J*D, H, W) or (B, J, D, H, W). Returns (coords (B, J*3),
    the normalised heatmap (B, J, D, H, W) in at least f32, or None)."""
    b = logits.shape[0]
    hm = logits.reshape(b, num_joints, depth * height * width)
    acc = torch.promote_types(hm.dtype, torch.float32)
    p = torch.exp(hm.to(acc) - hm.amax(dim=-1, keepdim=True).to(acc))
    p = p / p.sum(dim=-1, keepdim=True)
    p5 = p.reshape(b, num_joints, depth, height, width)
    ex = p5.sum(dim=(2, 3)) @ torch.arange(width, device=p.device, dtype=acc)
    ey = p5.sum(dim=(2, 4)) @ torch.arange(height, device=p.device, dtype=acc)
    ez = p5.sum(dim=(3, 4)) @ torch.arange(depth, device=p.device, dtype=acc)
    coords = coords_from_expectations(torch.stack([ex, ey, ez], dim=-1), height, width,
                                      depth, z_scale, xy_scale)
    return coords, (p5 if return_heatmap else None)
