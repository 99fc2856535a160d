"""Volumetric soft-argmax decodes: the port of ``soft_argmax_3d`` and
``soft_argmax_3d_nhwc`` of ``pose3d_tpu/ops/heatmap.py``, in plain
PyTorch (the JAX package leaves them to XLA).

Both take a softmax over one joint's D x H x W volume of logits, with the
maximum subtracted first and in at least f32, and return the expected
index along each axis, rescaled as the reference does (``Model.py``
175-177): x over W and y over H to ``(E / n - 0.5) * xy_scale``, z over D
to ``(E / D - 0.5) * z_scale``. Coordinates come out (B, J*3) as
[x, y, z] per joint. Both are differentiable: the training route of
``PoseNet3D`` decodes through ``soft_argmax_3d_nhwc``. Both compute in
f32 (or wider) under ``torch.autocast`` too (``f32_math``), as the JAX
decodes compute in f32 in a bf16 model.

``heatmap_targets`` (with ``xyz_to_uvw``, ``uvw_to_xyz`` and
``gaussian_heatmap_3d``) synthesises the heatmap loss's Gaussian targets
(``H36_dataset.py:148-202``). The 2D half: ``soft_argmax_2d`` (the
``PoseNet2D`` decode, ``Model_2d.py:96-134``), ``hard_argmax_2d``,
``gaussian_heatmap_2d`` and ``norm_heatmap``, in f32 as the JAX package
computes them; no kernel serves them there, and none here.
"""

from __future__ import annotations

import functools
import math

import torch

GRID = 64
SIGMA = 0.5


def f32_math(fn):
    """Runs ``fn(x, ...)`` with autocast off on x's device, so that its
    products stay in the dtype it computes in."""
    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        with torch.autocast(x.device.type, enabled=False):
            return fn(x, *args, **kwargs)

    return wrapped


def xyz_to_uvw(kp: torch.Tensor) -> torch.Tensor:
    """Axis remap for heatmap storage (``H36_dataset.py:143-144``): (x, y,
    z) -> (-y, -z, x). kp: (..., 3)."""
    return torch.stack([-kp[..., 1], -kp[..., 2], kp[..., 0]], dim=-1)


def uvw_to_xyz(kp: torch.Tensor) -> torch.Tensor:
    """The inverse remap (``Model.py:129-130``): (u, v, w) -> (w, -u, -v)."""
    return torch.stack([kp[..., 2], -kp[..., 0], -kp[..., 1]], dim=-1)


def _axis_profile(k: torch.Tensor, grid: int, sigma: float) -> torch.Tensor:
    """Windowed 1-D Gaussian: exp(-(i - k)^2 / 2 sigma^2) on the reference's
    integer window |i - rint(k)| <= size // 2, zero elsewhere. k: (...,) ->
    (..., grid)."""
    size = int(math.ceil(6 * sigma))
    if size % 2 == 0:
        size += 1
    idx = torch.arange(grid, device=k.device, dtype=k.dtype)
    k = k[..., None]
    g = torch.exp(-(idx - k).square() / (2.0 * sigma * sigma))
    return torch.where((idx - torch.round(k)).abs() <= size // 2, g, torch.zeros_like(g))


@f32_math
def gaussian_heatmap_3d(kp_uvw: torch.Tensor, grid=GRID, sigma: float = SIGMA) -> torch.Tensor:
    """(..., 3) uvw keypoints in [-1, 1] -> (..., gu, gv, gw) heatmaps
    (``_keypoint_to_heatmap_3D``, ``H36_dataset.py:148-194``): each axis
    scaled to (g / 2 - 0.5) * (1 + k), a separable Gaussian on the odd
    window around rint(k). ``grid`` is an int (cubic) or a (gu, gv, gw)
    tuple."""
    sizes = (grid,) * 3 if isinstance(grid, int) else tuple(grid)
    gu, gv, gw = (_axis_profile((g / 2.0 - 0.5) * (1.0 + kp_uvw[..., axis]), g, sigma)
                  for axis, g in enumerate(sizes))
    return torch.einsum("...u,...v,...w->...uvw", gu, gv, gw)


def heatmap_targets(kp3d: torch.Tensor, grid=GRID, sigma: float = SIGMA) -> torch.Tensor:
    """(B, J, 3) xyz keypoints in [-1, 1] -> (B, J, gu, gv, gw) targets,
    with the reference's xyz -> uvw storage remap applied."""
    return gaussian_heatmap_3d(xyz_to_uvw(kp3d), grid, sigma)


def coords_from_expectations(e: torch.Tensor, height: int, width: int, depth: int,
                             z_scale: float = 2.5, xy_scale: float = 2.0) -> torch.Tensor:
    """(B, J, 3) raw index expectations [Ex, Ey, Ez] -> (B, J*3) coordinates
    with the reference scaling."""
    cx = (e[..., 0] / width - 0.5) * xy_scale
    cy = (e[..., 1] / height - 0.5) * xy_scale
    cz = (e[..., 2] / depth - 0.5) * z_scale
    return torch.stack([cx, cy, cz], dim=-1).reshape(e.shape[0], -1)


@f32_math
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


@f32_math
def volume_expectations(volumes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D, H, W) logits, W contiguous -> ((N, 3) index expectations [Ex
    over W, Ey over H, Ez over D], the normalised softmax (N, D, H, W)) of
    each volume, maximum subtracted, in at least f32 (the JAX package's
    ``_expectations_xla``)."""
    n, depth, height, width = volumes.shape
    flat = volumes.reshape(n, depth * height * width)
    acc = torch.promote_types(flat.dtype, torch.float32)
    p = torch.exp(flat.to(acc) - flat.amax(dim=-1, keepdim=True).to(acc))
    p = (p / p.sum(dim=-1, keepdim=True)).view(n, depth, height, width)
    ex = p.sum(dim=(1, 2)) @ torch.arange(width, device=p.device, dtype=acc)
    ey = p.sum(dim=(1, 3)) @ torch.arange(height, device=p.device, dtype=acc)
    ez = p.sum(dim=(2, 3)) @ torch.arange(depth, device=p.device, dtype=acc)
    return torch.stack([ex, ey, ez], dim=-1), p


def soft_argmax_3d(logits: torch.Tensor, num_joints: int = 17, depth: int = GRID,
                   height: int = GRID, width: int = GRID, z_scale: float = 2.5,
                   xy_scale: float = 2.0, return_heatmap: bool = True):
    """Volumetric soft-argmax (the reference ``Model_3D`` decode).

    logits: (B, J*D, H, W) or (B, J, D, H, W). Returns (coords (B, J*3),
    the normalised heatmap (B, J, D, H, W) in at least f32, or None)."""
    b = logits.shape[0]
    e, p = volume_expectations(logits.reshape(b * num_joints, depth, height, width))
    coords = coords_from_expectations(e.view(b, num_joints, 3), height, width, depth,
                                      z_scale, xy_scale)
    return coords, (p.view(b, num_joints, depth, height, width) if return_heatmap else None)


@f32_math
def gaussian_heatmap_2d(pt: torch.Tensor, shape=(64, 64), sigma: float = 2.0) -> torch.Tensor:
    """(..., 2) (x, y) pixel points -> (..., H, W) Gaussians of centre value
    1 (``hybrik_utils.py:464-509`` ``drawGaussian``): centred on floor(pt),
    zero outside the window |i - floor(pt)| <= int(3 sigma)."""
    h, w = shape
    tmp = int(3 * sigma)
    px = torch.floor(pt[..., 0])[..., None]
    py = torch.floor(pt[..., 1])[..., None]
    xs = torch.arange(w, dtype=torch.float32, device=pt.device)
    ys = torch.arange(h, dtype=torch.float32, device=pt.device)
    gx = torch.exp(-(xs - px).square() / (2 * sigma * sigma))
    gy = torch.exp(-(ys - py).square() / (2 * sigma * sigma))
    gx = torch.where((xs - px).abs() <= tmp, gx, torch.zeros_like(gx))
    gy = torch.where((ys - py).abs() <= tmp, gy, torch.zeros_like(gy))
    return torch.einsum("...y,...x->...yx", gy, gx)


def norm_heatmap(norm_type: str, heatmap: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) heatmaps normalised over each (n, c) map
    (``hybrik_utils.py:1159-1178``): "softmax" (maximum subtracted),
    "sigmoid" or "divide_sum"; in the input's dtype with autocast off."""
    shape = heatmap.shape
    with torch.autocast(heatmap.device.type, enabled=False):
        if norm_type == "softmax":
            return torch.softmax(heatmap.reshape(shape[0], shape[1], -1), dim=2).reshape(shape)
        if norm_type == "sigmoid":
            return torch.sigmoid(heatmap)
        if norm_type == "divide_sum":
            flat = heatmap.reshape(shape[0], shape[1], -1)
            return (flat / flat.sum(dim=2, keepdim=True)).reshape(shape)
    raise NotImplementedError(norm_type)


def hard_argmax_2d(heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, J, H, W) -> ((B, J, 2) f32 (x, y) of each map's first maximum,
    (0, 0) where that maximum is not positive; (B, J) the maxima)
    (``hybrik_utils.py:1267-1311`` ``get_max_pred_batch``)."""
    b, j, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, j, -1)
    maxvals = flat.amax(dim=-1)
    idx = flat.argmax(dim=-1)  # the first maximum, as jnp.argmax
    coords = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    return torch.where(maxvals[..., None] > 0, coords, torch.zeros_like(coords)), maxvals


@f32_math
def soft_argmax_2d(logits: torch.Tensor, num_joints: int = 17, height: int = GRID,
                   width: int = GRID) -> torch.Tensor:
    """(B, J, H, W) logits (or (B, J*H*W)) -> (B, J*2) [x, y] per joint in
    [0, 1): each map's softmax, maximum subtracted, in at least f32, and
    its expected column / W and row / H (``Model_2d.py:96-134``)."""
    b = logits.shape[0]
    hm = logits.reshape(b, num_joints, height * width)
    acc = torch.promote_types(hm.dtype, torch.float32)
    p = torch.exp(hm.to(acc) - hm.amax(dim=-1, keepdim=True).to(acc))
    p = (p / p.sum(dim=-1, keepdim=True)).view(b, num_joints, height, width)
    ex = p.sum(dim=2) @ torch.arange(width, device=p.device, dtype=acc)
    ey = p.sum(dim=3) @ torch.arange(height, device=p.device, dtype=acc)
    return torch.stack([ex / width, ey / height], dim=-1).reshape(b, num_joints * 2)
