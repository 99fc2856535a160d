"""The fused Martinez residual block, and the fused Martinez inference built
on it: the port of ``pose3d_tpu/ops/pallas_martinez.py``.

``fused_residual_block`` computes ``x + relu(s2·(relu(s1·(x@W1)+b1)@W2)+b2)``
per row, BatchNorm folded into per-feature scale and shift (``fold_bn``),
on (B, 1024) bf16 rows with W1, W2 (1024, 1024) bf16 in flax's (in, out)
layout: in the Hopper kernel of ``csrc/martinez.cu`` when its operands lie
on a CUDA device, in its plain version ``fused_residual_block_reference``
when they lie on the CPU. ``martinez_infer_fused`` is a whole
``MartinezLifter`` inference on it; its input and output products stay
``torch.matmul``, as the JAX package leaves them to XLA. Inference only:
the JAX kernel has no backward.

Rounding points, the JAX functions' (``martinez_input``,
``fused_residual_block_reference`` and ``martinez_output`` spell them out):

- input: ``bf16(x) @ w_in`` rounded to bf16, then f32 ``* s_in + h_in``,
  ReLU, rounded to bf16;
- block: ``h = bf16(relu(f32acc(x@W1)*s1 + b1))``, then ``y =
  relu(f32acc(h@W2)*s2 + b2)`` in f32, then ``bf16(f32(x) + y)``, one
  rounding;
- output: ``h @ w_out`` rounded to bf16, then f32 ``+ b_out``.

Unlike the JAX service, which folds the default two stages whatever the
model has (``pallas_martinez.build_fused_params``'s ``num_stages=2``),
``pack_martinez`` reads the stage count from the model.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from pose3d_tpu_torch.models.lifters import MartinezLifter
from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.numerics import dot

WIDTH = 1024  # the kernel's row width: the lifter's hidden size


@dataclass(frozen=True)
class MartinezWeights:
    """A ``MartinezLifter``'s fused inference operands: matrices (in, out)
    in the compute dtype and contiguous, scales and shifts f32.
    ``blocks`` holds one ``(w1, s1, b1, w2, s2, b2)`` per stage, the
    argument order of ``fused_residual_block``."""

    w_in: torch.Tensor
    s_in: torch.Tensor
    h_in: torch.Tensor
    blocks: tuple[tuple[torch.Tensor, ...], ...]
    w_out: torch.Tensor
    b_out: torch.Tensor


def fold_bn(dense_bias: torch.Tensor,
            bn: nn.BatchNorm1d) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold (Linear bias, inference BatchNorm) into f32 per-feature (scale,
    shift): ``scale * (x @ W) + shift == BN(x @ W + bias)``, the JAX
    package's ``fold_bn`` with the module's eps (1e-5 in the lifters)."""
    gamma, beta = bn.weight.float(), bn.bias.float()
    mean, var = bn.running_mean.float(), bn.running_var.float()
    scale = gamma / torch.sqrt(var + bn.eps)
    shift = beta + scale * (dense_bias.float() - mean)
    return scale, shift


def _matrix(linear: nn.Linear, dtype) -> torch.Tensor:
    return linear.weight.detach().t().to(dtype).contiguous()  # (in, out), a copy


@torch.no_grad()
def pack_martinez(model: MartinezLifter, dtype=torch.bfloat16) -> MartinezWeights:
    """A ``MartinezLifter`` with BatchNorm -> its fused operands, on its
    device, for every stage it has; ``dtype`` is the compute dtype (the
    JAX package's ``compute_dtype``). Raises ValueError for a model
    without BatchNorm, which has nothing to fold."""
    if not (isinstance(model, MartinezLifter) and model.use_bn):
        raise ValueError("pack_martinez takes a MartinezLifter with BatchNorm")
    blocks = []
    for stage in model.linear_stages:
        s1, b1 = fold_bn(stage.w1.bias, stage.batch_norm1)
        s2, b2 = fold_bn(stage.w2.bias, stage.batch_norm2)
        blocks.append((_matrix(stage.w1, dtype), s1, b1, _matrix(stage.w2, dtype), s2, b2))
    s_in, h_in = fold_bn(model.w1.bias, model.batch_norm1)
    return MartinezWeights(_matrix(model.w1, dtype), s_in, h_in, tuple(blocks),
                           _matrix(model.w2, dtype),
                           model.w2.bias.detach().to(torch.float32, copy=True))


def fused_residual_block_reference(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """Plain version of ``fused_residual_block``, on any device and dtype;
    rounds to ``x.dtype`` where the JAX kernel rounds."""
    dt = x.dtype
    h = torch.relu(dot(x, w1) * s1 + b1).to(dt)
    y = torch.relu(dot(h, w2) * s2 + b2)
    return (x.float() + y).to(dt)


def _check_operands(x, w1, s1, b1, w2, s2, b2) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (B, F), got {tuple(x.shape)}")
    f = x.shape[1]
    for name, t, shape in (("w1", w1, (f, f)), ("w2", w2, (f, f)), ("s1", s1, (f,)),
                           ("b1", b1, (f,)), ("s2", s2, (f,)), ("b2", b2, (f,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def fused_residual_block(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """One residual block on (B, F) rows, any B >= 0.

    On the CPU this runs ``fused_residual_block_reference``. On a CUDA
    device it launches the kernel on the current stream (two launches: the
    first GEMM into a (B, 1024) bf16 scratch allocated here, then the
    second with the residual) and counts the call in
    ``fused_residual_block.launches``: it takes x, w1, w2 in bf16 (else
    TypeError), the scales and shifts in f32 (else TypeError), F = 1024
    and contiguous operands (else ValueError). Any other device raises
    ValueError.
    """
    _check_operands(x, w1, s1, b1, w2, s2, b2)
    if x.device.type == "cpu":
        return fused_residual_block_reference(x, w1, s1, b1, w2, s2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no Martinez block kernel for device {x.device}")
    for name, t, want in (("x", x, torch.bfloat16), ("w1", w1, torch.bfloat16),
                          ("w2", w2, torch.bfloat16), ("s1", s1, torch.float32),
                          ("b1", b1, torch.float32), ("s2", s2, torch.float32),
                          ("b2", b2, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"the Martinez block kernel takes {name} in {want}, "
                            f"got {t.dtype}")
    if x.shape[1] != WIDTH:
        raise ValueError(f"the Martinez block kernel takes rows of {WIDTH}, "
                         f"got {x.shape[1]}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2), ("s1", s1), ("b1", b1),
                    ("s2", s2), ("b2", b2)):
        if not t.is_contiguous() or t.data_ptr() % 16:  # TMA's 16-byte aligned bases
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    out = torch.empty_like(x)
    n_rows = x.shape[0]
    if n_rows == 0:
        return out
    h = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):  # the launch's current device
        err = lib.martinez_launch(
            x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), h.data_ptr(), out.data_ptr(), n_rows, WIDTH,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "martinez_launch")
    fused_residual_block.launches += 1
    return out


fused_residual_block.launches = 0


def supports(model) -> bool:
    """True iff ``model`` can take the fused route: a ``MartinezLifter``
    with BatchNorm (what folds into scale and shift; the JAX service gates
    on its batch statistics) and hidden 1024, the kernel's width."""
    return isinstance(model, MartinezLifter) and model.use_bn and model.hidden == WIDTH


def martinez_input(fused: MartinezWeights, x: torch.Tensor) -> torch.Tensor:
    """(B, 17, 2) or (B, in_dim) keypoints -> the blocks' (B, hidden) rows:
    ``bf16(relu(f32(bf16(x) @ w_in) * s_in + h_in))``."""
    dt = fused.w_in.dtype
    h = x.reshape(x.shape[0], -1).to(dt) @ fused.w_in
    return torch.relu(h.float() * fused.s_in + fused.h_in).to(dt)


def martinez_output(fused: MartinezWeights, h: torch.Tensor) -> torch.Tensor:
    """The blocks' rows -> (B, out_dim) f32: ``f32(h @ w_out) + b_out``."""
    return (h @ fused.w_out).float() + fused.b_out


def martinez_infer_fused(fused: MartinezWeights, x: torch.Tensor) -> torch.Tensor:
    """Fused Martinez inference: (B, 17, 2) or (B, in_dim) on the weights'
    device -> (B, out_dim) f32, every block through
    ``fused_residual_block``. Its plain version, the yardstick on the
    card, runs ``fused_residual_block_reference`` in the middle."""
    h = martinez_input(fused, x)
    for block in fused.blocks:
        h = fused_residual_block(h, *block)
    return martinez_output(fused, h)
