"""The volumetric soft-argmax kernels: the port of
``pose3d_tpu/ops/pallas_softargmax.py``'s ``soft_argmax_3d_nhwc_pallas``
(kernels 11a, its forward, and 11b, its backward, of PERF.md's table) and
of its legacy ``soft_argmax_3d_pallas`` (kernel 12) on contiguous (d, h,
w) volumes.

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

``soft_argmax_3d_pallas`` decodes (B, J, D, H, W) logits (any shape that
reshapes to (B·J, D, H, W), W contiguous) in kernel 12 of
``csrc/softargmax.cu`` on the card, in ``soft_argmax_3d_expectations_
reference`` on the CPU. Its backward is the JAX package's XLA formula
(``_vjp_bwd``), ``soft_argmax_3d_backward_reference``, in PyTorch ops on
either device: the JAX package has no kernel for it.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.heatmap import (coords_from_expectations, f32_math, nhwc_expectations,
                                          soft_argmax_3d_nhwc, volume_expectations)

TILE_PIXELS = 128  # pixels of a tile: the partials' tile (csrc/softargmax.cu kTilePixels)
# bytes of a CTA's tile of one (d, h, w) volume (csrc/softargmax.cu kVolumeTileBytes)
VOLUME_TILE_BYTES = 16384
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


def soft_argmax_3d_expectations_reference(logits_flat: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel 12: (N, D, H, W) logits -> (N, 3) [Ex,
    Ey, Ez] in at least f32, the math of JAX's ``_expectations_xla``."""
    return volume_expectations(logits_flat)[0]


@f32_math
def soft_argmax_3d_backward_reference(logits_flat: torch.Tensor, e: torch.Tensor,
                                      g: torch.Tensor) -> torch.Tensor:
    """The backward of the (N, D, H, W) decode, JAX's ``_vjp_bwd``
    (``pallas_softargmax.py:101``): p recomputed in f32 (or wider), dx =
    p·(gx·(wi − Ex) + gy·(hi − Ey) + gz·(di − Ez)) for the gradient g (N,
    3) of the expectations e (N, 3), in the logits' dtype."""
    n, d, h, w = logits_flat.shape
    acc = torch.promote_types(logits_flat.dtype, torch.float32)
    p = torch.softmax(logits_flat.reshape(n, -1).to(acc), dim=-1).view(n, d, h, w)
    g, e = g.to(acc).view(n, 3, 1, 1, 1), e.to(acc).view(n, 3, 1, 1, 1)
    idx = [torch.arange(k, device=p.device, dtype=acc) for k in (w, h, d)]
    term = (g[:, 0] * (idx[0].view(1, 1, 1, w) - e[:, 0])
            + g[:, 1] * (idx[1].view(1, 1, h, 1) - e[:, 1])
            + g[:, 2] * (idx[2].view(1, d, 1, 1) - e[:, 2]))
    return (p * term).to(logits_flat.dtype)


def soft_argmax_3d_volume_expectations(logits_flat: torch.Tensor) -> torch.Tensor:
    """Kernel 12: (N, D, H, W) CUDA logits, bf16 or f32, contiguous, W a
    whole number of 16-byte vectors -> (N, 3) f32 [Ex, Ey, Ez]. Two
    launches (the tile partials into a scratch allocated here, then their
    merge) on the current stream, counted in
    ``soft_argmax_3d_pallas.launches``. Anything else raises (TypeError for
    the dtype, ValueError for the rest)."""
    n, d, h, w = logits_flat.shape
    if logits_flat.device.type != "cuda":
        raise ValueError(f"no soft-argmax kernel for device {logits_flat.device}")
    if logits_flat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the soft-argmax kernel takes bf16 or f32 logits, "
                        f"got {logits_flat.dtype}")
    if not logits_flat.is_contiguous() or logits_flat.data_ptr() % _VECTOR_BYTES:
        raise ValueError("logits must be contiguous volumes that start on a 16-byte boundary")
    if (w * logits_flat.element_size()) % _VECTOR_BYTES:
        raise ValueError(f"the soft-argmax kernel takes a width of whole 16-byte vectors, "
                         f"got {w} x {logits_flat.dtype}")
    out = torch.empty((n, 3), device=logits_flat.device, dtype=torch.float32)
    if n == 0:
        return out
    n_tiles = -(-(d * h * w * logits_flat.element_size()) // VOLUME_TILE_BYTES)
    part = torch.empty((n, n_tiles, 5), device=logits_flat.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(logits_flat.device):  # the launch's current device
        err = lib.softargmax_volume_launch(
            logits_flat.data_ptr(), int(logits_flat.dtype == torch.bfloat16), part.data_ptr(),
            out.data_ptr(), n, d, h, w, VOLUME_TILE_BYTES, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "softargmax_volume_launch")
    soft_argmax_3d_pallas.launches += 1
    return out


class _VolumeExpectations(torch.autograd.Function):
    """(N, D, H, W) logits -> (N, 3) f32 [Ex, Ey, Ez]: kernel 12 on the
    card, its plain version on the CPU; the XLA formula's backward on
    both."""

    @staticmethod
    def forward(ctx, logits_flat):
        if logits_flat.device.type == "cpu":
            e = soft_argmax_3d_expectations_reference(logits_flat)
        else:
            e = soft_argmax_3d_volume_expectations(logits_flat)
        ctx.save_for_backward(logits_flat, e)
        return e

    @staticmethod
    def backward(ctx, g):
        logits_flat, e = ctx.saved_tensors
        return soft_argmax_3d_backward_reference(logits_flat, e, g)


def soft_argmax_3d_pallas(logits: torch.Tensor, num_joints: int = 17, depth: int = 64,
                          height: int = 64, width: int = 64, z_scale: float = 2.5,
                          xy_scale: float = 2.0) -> torch.Tensor:
    """Logits that reshape to (B·J, D, H, W), W contiguous (the reference's
    (B, J, D, H, W) heatmap logits or (B, J·D, H, W)) -> (B, J·3) f32
    coordinates with the reference scaling, differentiable
    (``pallas_softargmax.soft_argmax_3d_pallas``).

    On the CPU this runs the plain version. On a CUDA device it launches
    kernel 12 (``soft_argmax_3d_volume_expectations``: bf16 or f32 logits,
    else TypeError; contiguous, with a width of whole 16-byte vectors,
    else ValueError). Any other device raises ValueError.
    """
    b = logits.shape[0]
    if logits.numel() != b * num_joints * depth * height * width:
        raise ValueError(f"logits {tuple(logits.shape)} do not hold {b} x {num_joints} "
                         f"volumes of {depth} x {height} x {width}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no soft-argmax kernel for device {logits.device}")
    e = _VolumeExpectations.apply(logits.reshape(b * num_joints, depth, height, width))
    return coords_from_expectations(e.view(b, num_joints, 3), height, width, depth, z_scale,
                                    xy_scale)


soft_argmax_3d_pallas.launches = 0
