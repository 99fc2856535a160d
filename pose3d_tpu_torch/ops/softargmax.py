"""The volumetric soft-argmax straight off NHWC logits: the port of
``soft_argmax_3d_nhwc_pallas`` of ``pose3d_tpu/ops/pallas_softargmax.py``
(kernels 11a, its forward, and 11b, its backward, of PERF.md's table).

``soft_argmax_3d_nhwc_kernel`` decodes the direct model's (B, H, W, J*D)
head output, channel ``j*D + d``, to (B, J*3) coordinates: in the Hopper
kernels of ``csrc/softargmax.cu`` when the logits lie on a CUDA device,
in their plain versions when they lie on the CPU. Both compute the index
expectations [Ex, Ey, Ez] of each joint's softmax (maximum subtracted,
f32) and scale them with ``heatmap.coords_from_expectations``.

It is differentiable, as the JAX ``custom_vjp`` is: an autograd Function
whose forward also keeps each joint's maximum and sum (on the card) and
whose backward is kernel 11b, ``soft_argmax_3d_nhwc_backward``, or on the
CPU its plain version ``soft_argmax_3d_nhwc_backward_reference``:
``dx = (p/s)·(xi·gx + yi·gy + gz·(d − Ez) − gx·Ex − gy·Ey)`` for the
gradient g = [gx, gy, gz] of [Ex, Ey, Ez], in the logits' dtype.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.heatmap import (coords_from_expectations, f32_math, nhwc_expectations,
                                          soft_argmax_3d_nhwc)

TILE_PIXELS = 128  # pixels per CTA: the partials' tile (csrc/softargmax.cu kTilePixels)
_VECTOR_BYTES = 16


# The plain version of ``soft_argmax_3d_nhwc_kernel``, on any device and
# float dtype: the same expectations, in f32 (or wider), the same scaling,
# differentiable by autograd.
soft_argmax_3d_nhwc_reference = soft_argmax_3d_nhwc


@f32_math
def soft_argmax_3d_nhwc_backward_reference(logits_nhwc: torch.Tensor, e: torch.Tensor,
                                           g: torch.Tensor, num_joints: int = 17,
                                           depth: int = 64) -> torch.Tensor:
    """The plain version of kernel 11b: the logits' gradient from the
    gradient g (B, J, 3) of the expectations e (B, J, 3), written as the JAX
    ``_kernel_nhwc_bwd`` (``pallas_softargmax.py:164-180``) writes it, in
    f32 (or wider); returned in the logits' dtype."""
    b, h, w, c = logits_nhwc.shape
    acc = torch.promote_types(logits_nhwc.dtype, torch.float32)
    x = logits_nhwc.reshape(b, h * w, num_joints, depth).to(acc)
    p = torch.exp(x - x.amax(dim=(1, 3), keepdim=True))
    s = p.sum(dim=(1, 3), keepdim=True)
    g = g.to(acc).reshape(b, 1, num_joints, 3, 1)
    e = e.to(acc).reshape(b, 1, num_joints, 3, 1)
    gx, gy, gz = g.unbind(3)
    ex, ey, ez = e.unbind(3)
    idx = torch.arange(h * w, device=x.device)
    xi = (idx % w).to(acc).view(1, h * w, 1, 1)
    yi = (idx // w).to(acc).view(1, h * w, 1, 1)
    di = torch.arange(depth, device=x.device, dtype=acc)
    coef = gz * (di - ez) - gx * ex - gy * ey       # (B, 1, J, D)
    dx = (p / s) * (xi * gx + yi * gy + coef)
    return dx.reshape(b, h, w, c).to(logits_nhwc.dtype)


def _check_kernel_logits(logits_nhwc: torch.Tensor, depth: int) -> None:
    if logits_nhwc.device.type != "cuda":
        raise ValueError(f"no soft-argmax kernel for device {logits_nhwc.device}")
    if logits_nhwc.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the soft-argmax kernel takes bf16 or f32 logits, "
                        f"got {logits_nhwc.dtype}")
    if not logits_nhwc.is_contiguous() or logits_nhwc.data_ptr() % _VECTOR_BYTES:
        raise ValueError("logits must be contiguous in NHWC order and start on a 16-byte "
                         "boundary")
    if (depth * logits_nhwc.element_size()) % _VECTOR_BYTES:
        raise ValueError(f"the soft-argmax kernel takes a depth of whole 16-byte vectors, "
                         f"got {depth} x {logits_nhwc.dtype}")


def soft_argmax_3d_nhwc_expectations(logits_nhwc: torch.Tensor, num_joints: int, depth: int,
                                     with_stats: bool = False):
    """Kernel 11a: (B, H, W, J*D) CUDA logits -> ((B, J, 3) f32 [Ex, Ey,
    Ez], and with ``with_stats`` the (B, J, 2) f32 [maximum, sum] of each
    joint's softmax, else None). Two launches (the tile partials into a
    scratch allocated here, then their merge) on the current stream,
    counted in ``soft_argmax_3d_nhwc_kernel.launches``."""
    _check_kernel_logits(logits_nhwc, depth)
    b, h, w, _ = logits_nhwc.shape
    dev = logits_nhwc.device
    out = torch.empty((b, num_joints, 3), device=dev, dtype=torch.float32)
    stats = torch.empty((b, num_joints, 2), device=dev, dtype=torch.float32) if with_stats else None
    if b == 0:
        return out, stats
    n_tiles = -(-(h * w) // TILE_PIXELS)
    part = torch.empty((b * num_joints, n_tiles, 5), device=dev, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):  # the launch's current device
        err = lib.softargmax_nhwc_launch(
            logits_nhwc.data_ptr(), int(logits_nhwc.dtype == torch.bfloat16), part.data_ptr(),
            out.data_ptr(), 0 if stats is None else stats.data_ptr(), b, h, w, num_joints,
            depth, TILE_PIXELS, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "softargmax_nhwc_launch")
    soft_argmax_3d_nhwc_kernel.launches += 1
    return out, stats


def soft_argmax_3d_nhwc_backward(logits_nhwc: torch.Tensor, e: torch.Tensor, stats: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Kernel 11b: the logits' gradient (their shape, dtype and layout)
    from the forward's expectations e and statistics (B, J, 2) and the
    gradient g (B, J, 3) of e; one launch on the current stream, counted
    in ``soft_argmax_3d_nhwc_backward.launches``. Takes what the forward
    takes (else TypeError or ValueError)."""
    b, h, w, c = logits_nhwc.shape
    num_joints = e.shape[1]
    depth = c // num_joints
    _check_kernel_logits(logits_nhwc, depth)
    dx = torch.empty_like(logits_nhwc, memory_format=torch.contiguous_format)
    if b == 0:
        return dx
    g, e, stats = (t.detach().float().contiguous() for t in (g, e, stats))
    lib = _build.library()
    with torch.cuda.device(logits_nhwc.device):
        err = lib.softargmax_nhwc_bwd_launch(
            logits_nhwc.data_ptr(), int(logits_nhwc.dtype == torch.bfloat16), g.data_ptr(),
            e.data_ptr(), stats.data_ptr(), dx.data_ptr(), b, h, w, num_joints, depth,
            TILE_PIXELS, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "softargmax_nhwc_bwd_launch")
    soft_argmax_3d_nhwc_backward.launches += 1
    return dx


class _Expectations(torch.autograd.Function):
    """(B, H, W, J*D) logits -> (B, J, 3) f32 [Ex, Ey, Ez]: kernels 11a /
    11b on the card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, logits_nhwc, num_joints, depth, with_stats):
        if logits_nhwc.device.type == "cpu":
            e, stats = nhwc_expectations(logits_nhwc, num_joints, depth), None
        else:
            e, stats = soft_argmax_3d_nhwc_expectations(logits_nhwc, num_joints, depth,
                                                        with_stats)
        ctx.save_for_backward(logits_nhwc, e, stats)
        ctx.shape = num_joints, depth
        return e

    @staticmethod
    def backward(ctx, g):
        logits_nhwc, e, stats = ctx.saved_tensors
        if logits_nhwc.device.type == "cpu":
            dx = soft_argmax_3d_nhwc_backward_reference(logits_nhwc, e, g, *ctx.shape)
        else:
            dx = soft_argmax_3d_nhwc_backward(logits_nhwc, e, stats, g)
        return dx, None, None, None


def soft_argmax_3d_nhwc_kernel(logits_nhwc: torch.Tensor, num_joints: int = 17,
                               depth: int = 64, z_scale: float = 2.5,
                               xy_scale: float = 2.0) -> torch.Tensor:
    """(B, H, W, J*D) logits -> (B, J*3) f32 coordinates, differentiable.

    On the CPU this runs the plain versions. On a CUDA device it launches
    kernel 11a (``soft_argmax_3d_nhwc_expectations``) and, in the
    backward, kernel 11b: it takes bf16 or f32 logits (else TypeError)
    that are contiguous in NHWC order and start on a 16-byte boundary,
    with a depth of whole 16-byte vectors (else ValueError); a
    channels_last conv output, ``.permute(0, 2, 3, 1)``, is such a tensor.
    Any other device raises ValueError.
    """
    if logits_nhwc.dim() != 4 or logits_nhwc.shape[3] != num_joints * depth:
        raise ValueError(f"logits must be (B, H, W, {num_joints} x {depth}), "
                         f"got {tuple(logits_nhwc.shape)}")
    if logits_nhwc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no soft-argmax kernel for device {logits_nhwc.device}")
    _, h, w, _ = logits_nhwc.shape
    with_stats = torch.is_grad_enabled() and logits_nhwc.requires_grad
    e = _Expectations.apply(logits_nhwc, num_joints, depth, with_stats)
    return coords_from_expectations(e, h, w, depth, z_scale, xy_scale)


soft_argmax_3d_nhwc_kernel.launches = 0
soft_argmax_3d_nhwc_backward.launches = 0
