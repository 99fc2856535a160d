"""The volumetric soft-argmax straight off NHWC logits: the port of
``soft_argmax_3d_nhwc_pallas`` of ``pose3d_tpu/ops/pallas_softargmax.py``
(its forward, kernel 11a of PERF.md's table).

``soft_argmax_3d_nhwc_kernel`` decodes the direct model's (B, H, W, J*D)
head output, channel ``j*D + d``, to (B, J*3) coordinates: in the Hopper
kernel of ``csrc/softargmax.cu`` when the logits lie on a CUDA device, in
its plain version ``soft_argmax_3d_nhwc_reference`` when they lie on the
CPU. Both compute the index expectations [Ex, Ey, Ez] of each joint's
softmax (maximum subtracted, f32) and scale them with
``heatmap.coords_from_expectations``.

Forward only: the JAX ``custom_vjp`` backward (kernel 11b) comes with the
direct-training slice, so where grad mode is on the wrapper refuses
logits that require grad.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.heatmap import coords_from_expectations, soft_argmax_3d_nhwc

TILE_PIXELS = 128  # pixels per CTA: the partials' tile (csrc/softargmax.cu kTilePixels)
_VECTOR_BYTES = 16


# The plain version of ``soft_argmax_3d_nhwc_kernel``, on any device and
# float dtype: the same expectations, in f32 (or wider), the same scaling.
soft_argmax_3d_nhwc_reference = soft_argmax_3d_nhwc


def soft_argmax_3d_nhwc_kernel(logits_nhwc: torch.Tensor, num_joints: int = 17,
                               depth: int = 64, z_scale: float = 2.5,
                               xy_scale: float = 2.0) -> torch.Tensor:
    """(B, H, W, J*D) logits -> (B, J*3) f32 coordinates.

    On the CPU this runs ``soft_argmax_3d_nhwc_reference``. On a CUDA
    device it launches the kernel on the current stream (two launches: the
    tile partials into a scratch allocated here, then their merge) and
    counts the call in ``soft_argmax_3d_nhwc_kernel.launches``: it takes
    bf16 or f32 logits (else TypeError) that are contiguous in NHWC order
    and start on a 16-byte boundary, with a depth of whole 16-byte vectors
    (else ValueError); a channels_last conv output, ``.permute(0, 2, 3,
    1)``, is such a tensor. Any other device raises ValueError, and so do
    logits that require grad where grad mode is on (no backward yet).
    """
    if logits_nhwc.dim() != 4 or logits_nhwc.shape[3] != num_joints * depth:
        raise ValueError(f"logits must be (B, H, W, {num_joints} x {depth}), "
                         f"got {tuple(logits_nhwc.shape)}")
    if torch.is_grad_enabled() and logits_nhwc.requires_grad:
        raise ValueError("soft_argmax_3d_nhwc_kernel has no backward yet: decode "
                         "under torch.no_grad(), or train through heatmap.soft_argmax_3d_nhwc")
    if logits_nhwc.device.type == "cpu":
        return soft_argmax_3d_nhwc_reference(logits_nhwc, num_joints, depth, z_scale, xy_scale)
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
    b, h, w, _ = logits_nhwc.shape
    out = torch.empty((b, num_joints, 3), device=logits_nhwc.device, dtype=torch.float32)
    if b == 0:
        return out.reshape(0, num_joints * 3)
    n_tiles = -(-(h * w) // TILE_PIXELS)
    part = torch.empty((b * num_joints, n_tiles, 5), device=logits_nhwc.device,
                       dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(logits_nhwc.device):  # the launch's current device
        err = lib.softargmax_nhwc_launch(
            logits_nhwc.data_ptr(), int(logits_nhwc.dtype == torch.bfloat16), part.data_ptr(),
            out.data_ptr(), b, h, w, num_joints, depth, TILE_PIXELS,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "softargmax_nhwc_launch")
    soft_argmax_3d_nhwc_kernel.launches += 1
    return coords_from_expectations(out, h, w, depth, z_scale, xy_scale)


soft_argmax_3d_nhwc_kernel.launches = 0
