"""The direct model's final 1x1 conv fused into its volumetric
soft-argmax: the port of ``conv_soft_argmax_3d_fused`` of
``pose3d_tpu/ops/pallas_conv_decode.py`` (its forward, kernel 13a of
PERF.md's table).

``conv_soft_argmax_3d_fused`` takes the deconv head's (B, H, W, C)
features, the conv's (J*D, C) weight (torch's (out, in) layout, the
``final_layer`` weight viewed as a matrix) and its (J*D,) bias, and
returns (B, J*3) f32 coordinates without the (B, H, W, J*D) logits ever
reaching device memory: in the Hopper kernel of ``csrc/conv_decode.cu``
when the operands lie on a CUDA device, in its plain version
``conv_soft_argmax_3d_reference`` when they lie on the CPU. Both compute
the logits in f32 from the operands as given, bias included in f32; a
bf16 model rounds its bias to bf16 first, as the flax head does
(``heads.py``: ``bias.astype(dtype)``).

Forward only: the JAX ``custom_vjp`` backward (kernel 13b) comes with the
direct-training slice, so where grad mode is on the wrapper refuses
operands that require grad.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.heatmap import coords_from_expectations, soft_argmax_3d_nhwc

FEATURES = 256     # C: the deconv head's width (csrc/conv_decode.cu kFeat)
DEPTH = 64         # D: a joint's channels (kDepth)
TILE_PIXELS = 128  # pixels per CTA: the partials' tile (kTilePixels)


def conv_soft_argmax_3d_reference(feats_nhwc, weight, bias, num_joints: int = 17,
                                  depth: int = 64, z_scale: float = 2.5,
                                  xy_scale: float = 2.0) -> torch.Tensor:
    """Plain version of ``conv_soft_argmax_3d_fused``, on any device and
    dtype: the logits ``f32(feats) @ f32(weight)^T + f32(bias)``, then
    ``heatmap.soft_argmax_3d_nhwc``."""
    logits = feats_nhwc.float() @ weight.float().t() + bias.float()
    return soft_argmax_3d_nhwc(logits, num_joints, depth, z_scale, xy_scale)


def _check_operands(feats, weight, bias, num_joints, depth) -> None:
    if feats.dim() != 4:
        raise ValueError(f"feats must be (B, H, W, C), got {tuple(feats.shape)}")
    c = feats.shape[3]
    for name, t, shape in (("weight", weight, (num_joints * depth, c)),
                           ("bias", bias, (num_joints * depth,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")


def conv_soft_argmax_3d_fused(feats_nhwc: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_joints: int = 17, depth: int = 64,
                              z_scale: float = 2.5, xy_scale: float = 2.0) -> torch.Tensor:
    """(B, H, W, C) features, (J*D, C) weight, (J*D,) bias -> (B, J*3) f32
    coordinates of ``soft_argmax_3d_nhwc(feats @ weight^T + bias)``.

    On the CPU this runs ``conv_soft_argmax_3d_reference``. On a CUDA
    device it launches the kernel on the current stream (two launches: the
    tile partials into a scratch allocated here, then their merge) and
    counts the call in ``conv_soft_argmax_3d_fused.launches``: it takes
    feats and weight in bf16 and the bias in f32 (else TypeError), C = 256,
    D = 64 and contiguous operands on 16-byte boundaries (else
    ValueError); the channels_last deconv output, ``.permute(0, 2, 3,
    1)``, is such a feats tensor. Any other device raises ValueError, and
    so do operands that require grad where grad mode is on (no backward
    yet).
    """
    _check_operands(feats_nhwc, weight, bias, num_joints, depth)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (feats_nhwc, weight, bias)):
        raise ValueError("conv_soft_argmax_3d_fused has no backward yet: decode under "
                         "torch.no_grad(), or train through the unfused head")
    if feats_nhwc.device.type == "cpu":
        return conv_soft_argmax_3d_reference(feats_nhwc, weight, bias, num_joints, depth,
                                             z_scale, xy_scale)
    if feats_nhwc.device.type != "cuda":
        raise ValueError(f"no conv-decode kernel for device {feats_nhwc.device}")
    for name, t, want in (("feats", feats_nhwc, torch.bfloat16),
                          ("weight", weight, torch.bfloat16), ("bias", bias, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"the conv-decode kernel takes {name} in {want}, got {t.dtype}")
    if feats_nhwc.shape[3] != FEATURES or depth != DEPTH:
        raise ValueError(f"the conv-decode kernel takes {FEATURES} features and depth "
                         f"{DEPTH}, got {feats_nhwc.shape[3]} and {depth}")
    for name, t in (("feats", feats_nhwc), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous() or t.data_ptr() % 16:  # 16-byte cp.async copies
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    b, h, w, _ = feats_nhwc.shape
    out = torch.empty((b, num_joints, 3), device=feats_nhwc.device, dtype=torch.float32)
    if b == 0:
        return out.reshape(0, num_joints * 3)
    n_tiles = -(-(h * w) // TILE_PIXELS)
    part = torch.empty((b * num_joints, n_tiles, 5), device=feats_nhwc.device,
                       dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(feats_nhwc.device):  # the launch's current device
        err = lib.conv_decode_launch(
            feats_nhwc.data_ptr(), weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
            out.data_ptr(), b, h, w, FEATURES, num_joints, DEPTH, TILE_PIXELS,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv_decode_launch")
    conv_soft_argmax_3d_fused.launches += 1
    return coords_from_expectations(out, h, w, depth, z_scale, xy_scale)


conv_soft_argmax_3d_fused.launches = 0
