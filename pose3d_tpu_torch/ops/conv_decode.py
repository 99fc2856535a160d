"""The direct model's final 1x1 conv fused into its volumetric
soft-argmax: the port of ``conv_soft_argmax_3d_fused`` of
``pose3d_tpu/ops/pallas_conv_decode.py`` (kernels 13a, its forward, and
13b, its backward, of PERF.md's table).

``conv_soft_argmax_3d_fused`` takes the deconv head's (B, H, W, C)
features, the conv's (J*D, C) weight (torch's (out, in) layout, the
``final_layer`` weight viewed as a matrix) and its (J*D,) bias, and
returns (B, J*3) f32 coordinates without the (B, H, W, J*D) logits ever
reaching device memory: in the Hopper kernels of ``csrc/conv_decode.cu``
and ``csrc/conv_decode_bwd.cu`` when the operands lie on a CUDA device,
in their plain versions when they lie on the CPU. Both compute the logits
in f32 from the operands as given, bias included in f32; a bf16 model
rounds its bias to bf16 first, as the flax head does (``heads.py``:
``bias.astype(dtype)``).

It is differentiable, as the JAX ``custom_vjp`` is: an autograd Function
whose backward is kernel 13b, ``conv_soft_argmax_3d_backward``, or on the
CPU its plain version ``conv_soft_argmax_3d_backward_reference``. They
return (dfeats, dW, db) in the dtypes of feats, weight and bias; a bf16
model hands the kernel ``weight.to(bf16)`` and ``bias.to(bf16).float()``,
so that autograd carries dW and db back to f32 master weights through
one bf16 rounding, as the flax head's casts do.
"""

from __future__ import annotations

import functools

import torch

from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.heatmap import coords_from_expectations, f32_math, nhwc_expectations
from pose3d_tpu_torch.ops.softargmax import soft_argmax_3d_nhwc_backward_reference

FEATURES = 256     # C: the deconv head's width (csrc/conv_decode.cuh kFeat)
DEPTH = 64         # D: a joint's channels (kDepth)
TILE_PIXELS = 128  # pixels of a tile: the partials' tile (kTilePixels)
MAX_JOINTS = 128   # the forward's joints: 4 partials a lane (conv_decode.cu kMaxJoints)
CHUNK_PIXELS = 64  # the backward's dW launch: pixels a chunk (conv_decode_bwd.cu kChunkPixels)
DW_WAVES = 4       # the backward's dW launch: about this many waves of (joint, group) CTAs


@f32_math
def _logits(feats_nhwc, weight, bias) -> torch.Tensor:
    acc = torch.promote_types(feats_nhwc.dtype, torch.float32)
    return feats_nhwc.to(acc) @ weight.to(acc).t() + bias.to(acc)


def conv_soft_argmax_3d_expectations_reference(feats_nhwc, weight, bias, num_joints: int = 17,
                                               depth: int = 64) -> torch.Tensor:
    """Plain version of kernel 13a, on any device and dtype: (B, J, 3)
    [Ex, Ey, Ez] of the logits ``f32(feats) @ f32(weight)^T + f32(bias)``
    (or wider), differentiable by autograd."""
    return nhwc_expectations(_logits(feats_nhwc, weight, bias), num_joints, depth)


def conv_soft_argmax_3d_reference(feats_nhwc, weight, bias, num_joints: int = 17,
                                  depth: int = 64, z_scale: float = 2.5,
                                  xy_scale: float = 2.0) -> torch.Tensor:
    """Plain version of ``conv_soft_argmax_3d_fused``, on any device and
    dtype, differentiable by autograd: the coordinates of
    ``conv_soft_argmax_3d_expectations_reference``."""
    _, h, w, _ = feats_nhwc.shape
    e = conv_soft_argmax_3d_expectations_reference(feats_nhwc, weight, bias, num_joints, depth)
    return coords_from_expectations(e, h, w, depth, z_scale, xy_scale)


@f32_math
def conv_soft_argmax_3d_backward_reference(feats_nhwc, weight, bias, e, g,
                                           num_joints: int = 17, depth: int = 64):
    """The plain version of kernel 13b: (dfeats, dW, db) in the dtypes of
    feats, weight and bias, from the gradient g (B, J, 3) of the
    expectations e (B, J, 3). As the JAX ``_bwd_kernel``
    (``pallas_conv_decode.py:124-155``): the logits recomputed in f32 (or
    wider), dslab (the logits' gradient, ``softargmax``'s plain backward),
    dfeats = dslab @ W and dW = dslab^T @ feats summed in f32 (or wider),
    db = dslab summed over the pixels. For operands narrower than f32 the
    products take dslab rounded to the feats' dtype, as the kernel's bf16
    products do (the JAX kernel keeps it f32); db sums it unrounded."""
    b, h, w, c = feats_nhwc.shape
    acc = torch.promote_types(feats_nhwc.dtype, torch.float32)
    logits = _logits(feats_nhwc, weight, bias)
    dslab = soft_argmax_3d_nhwc_backward_reference(logits, e, g, num_joints, depth)
    dslab = dslab.reshape(b * h * w, num_joints * depth)
    db = dslab.sum(0)
    if torch.finfo(feats_nhwc.dtype).bits < 32:
        dslab = dslab.to(feats_nhwc.dtype).to(acc)
    dfeats = dslab @ weight.to(acc)
    dw = dslab.t() @ feats_nhwc.reshape(b * h * w, c).to(acc)
    return (dfeats.reshape(b, h, w, c).to(feats_nhwc.dtype), dw.to(weight.dtype),
            db.to(bias.dtype))


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


def _check_kernel_operands(feats_nhwc, weight, bias, depth) -> None:
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
        if not t.is_contiguous() or t.data_ptr() % 16:  # TMA boxes and 8-byte bias loads
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")


def conv_soft_argmax_3d_expectations(feats_nhwc, weight, bias, num_joints: int,
                                     depth: int = DEPTH, with_stats: bool = False):
    """Kernel 13a: ((B, J, 3) f32 [Ex, Ey, Ez], and with ``with_stats`` the
    (B, J, 2) f32 [maximum, sum] of each joint's softmax, else None). Two
    launches (the tile partials into a scratch allocated here, then their
    merge) on the current stream, counted in
    ``conv_soft_argmax_3d_fused.launches``."""
    _check_kernel_operands(feats_nhwc, weight, bias, depth)
    if num_joints > MAX_JOINTS:
        raise ValueError(f"the conv-decode kernel takes at most {MAX_JOINTS} joints, "
                         f"got {num_joints}")
    b, h, w, _ = feats_nhwc.shape
    dev = feats_nhwc.device
    out = torch.empty((b, num_joints, 3), device=dev, dtype=torch.float32)
    stats = (torch.empty((b, num_joints, 2), device=dev, dtype=torch.float32) if with_stats
             else None)
    if b == 0:
        return out, stats
    n_tiles = -(-(h * w) // TILE_PIXELS)
    part = torch.empty((b * num_joints, n_tiles, 5), device=dev, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):  # the launch's current device
        err = lib.conv_decode_launch(
            feats_nhwc.data_ptr(), weight.data_ptr(), bias.data_ptr(), part.data_ptr(),
            out.data_ptr(), 0 if stats is None else stats.data_ptr(), b, h, w, FEATURES,
            num_joints, DEPTH, TILE_PIXELS, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv_decode_launch")
    conv_soft_argmax_3d_fused.launches += 1
    return out, stats


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv_soft_argmax_3d_backward(feats_nhwc, weight, bias, e, stats, g):
    """Kernel 13b: (dfeats (feats' shape and layout, bf16), dW (weight's
    shape, bf16), db (bias's shape, f32)) from the forward's expectations
    e and statistics (B, J, 2) and the gradient g (B, J, 3) of e; three
    launches on the current stream (dfeats; dW and db partials per group
    of pixel tiles into a scratch allocated here; their fold), counted as
    one in ``conv_soft_argmax_3d_backward.launches``. Takes what the
    forward takes (else TypeError or ValueError)."""
    num_joints = e.shape[1]
    _check_kernel_operands(feats_nhwc, weight, bias, DEPTH)
    b, h, w, c = feats_nhwc.shape
    dev = feats_nhwc.device
    dfeats = torch.empty_like(feats_nhwc, memory_format=torch.contiguous_format)
    dw, db = torch.empty_like(weight), torch.empty_like(bias)
    if b == 0:
        return dfeats, dw.zero_(), db.zero_()
    chunks = b * -(-(h * w) // CHUNK_PIXELS)
    groups = max(1, min(chunks, DW_WAVES * _sm_count(dev.index or 0) // num_joints))
    part = torch.empty((groups, num_joints * DEPTH * (c + 1)), device=dev, dtype=torch.float32)
    g, e, stats = (t.detach().float().contiguous() for t in (g, e, stats))
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.conv_decode_bwd_launch(
            feats_nhwc.data_ptr(), weight.data_ptr(), bias.data_ptr(), g.data_ptr(),
            e.data_ptr(), stats.data_ptr(), dfeats.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr(), groups, b, h, w, FEATURES, num_joints, DEPTH, TILE_PIXELS,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "conv_decode_bwd_launch")
    conv_soft_argmax_3d_backward.launches += 1
    return dfeats, dw, db


class _FusedExpectations(torch.autograd.Function):
    """(feats, weight, bias) -> (B, J, 3) f32 [Ex, Ey, Ez]: kernels 13a /
    13b on the card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, feats_nhwc, weight, bias, num_joints, depth, with_stats):
        if feats_nhwc.device.type == "cpu":
            e = conv_soft_argmax_3d_expectations_reference(feats_nhwc, weight, bias,
                                                           num_joints, depth)
            stats = None
        else:
            e, stats = conv_soft_argmax_3d_expectations(feats_nhwc, weight, bias, num_joints,
                                                        depth, with_stats)
        ctx.save_for_backward(feats_nhwc, weight, bias, e, stats)
        ctx.shape = num_joints, depth
        return e

    @staticmethod
    def backward(ctx, g):
        feats_nhwc, weight, bias, e, stats = ctx.saved_tensors
        if feats_nhwc.device.type == "cpu":
            grads = conv_soft_argmax_3d_backward_reference(feats_nhwc, weight, bias, e, g,
                                                           *ctx.shape)
        else:
            grads = conv_soft_argmax_3d_backward(feats_nhwc, weight, bias, e, stats, g)
        return (*grads, None, None, None)


def conv_soft_argmax_3d_fused(feats_nhwc: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, num_joints: int = 17, depth: int = 64,
                              z_scale: float = 2.5, xy_scale: float = 2.0) -> torch.Tensor:
    """(B, H, W, C) features, (J*D, C) weight, (J*D,) bias -> (B, J*3) f32
    coordinates of ``soft_argmax_3d_nhwc(feats @ weight^T + bias)``,
    differentiable in all three.

    On the CPU this runs the plain versions. On a CUDA device it launches
    kernel 13a (``conv_soft_argmax_3d_expectations``) and, in the
    backward, kernel 13b: it takes feats and weight in bf16 and the bias
    in f32 (else TypeError), C = 256, D = 64, at most ``MAX_JOINTS``
    joints and contiguous operands on 16-byte boundaries (else
    ValueError); the channels_last deconv output,
    ``.permute(0, 2, 3, 1)``, is such a feats tensor. Any other device
    raises ValueError.
    """
    _check_operands(feats_nhwc, weight, bias, num_joints, depth)
    if feats_nhwc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv-decode kernel for device {feats_nhwc.device}")
    _, h, w, _ = feats_nhwc.shape
    with_stats = torch.is_grad_enabled() and any(t.requires_grad
                                                 for t in (feats_nhwc, weight, bias))
    e = _FusedExpectations.apply(feats_nhwc, weight, bias, num_joints, depth, with_stats)
    return coords_from_expectations(e, h, w, depth, z_scale, xy_scale)


conv_soft_argmax_3d_fused.launches = 0
conv_soft_argmax_3d_backward.launches = 0
