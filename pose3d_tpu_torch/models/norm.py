"""BatchNorm that stays f32 in a model of a narrower dtype: the port of
``pose3d_tpu/models/norm.py``.

The JAX package's ``BatchNorm`` keeps its scale, bias and running
statistics f32 and normalises in f32 whatever the model's dtype, then
returns the model dtype. torch's BatchNorm has its semantics already
(momentum 0.1 = flax's 0.9, eps 1e-5, the batch normalised by the biased
variance and the running variance updated with the unbiased one), but a
``.to(torch.bfloat16)`` of the model would round its statistics.
``F32BatchNorm1d`` (the lifters) and ``F32BatchNorm2d`` (the ResNet and
the deconv head) refuse that rounding.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch's convention; flax's 0.9 in the JAX package


def keep_f32(fn):
    """``fn``, a tensor map of ``Module._apply``, except that where it would
    narrow a floating tensor below f32 the tensor is only moved, and stays
    f32 (so it is never rounded)."""
    def apply(t):
        out = fn(t)
        if out.is_floating_point() and torch.finfo(out.dtype).bits < 32:
            out = t.to(device=out.device, dtype=torch.float32)
        return out

    return apply


class _F32Norm:
    """The f32 behaviour shared by both BatchNorms.

    ``_apply``, through which ``.to()``, ``.bfloat16()``, ``.half()`` and
    the like cast every module, converts this module's parameters and
    running statistics from their f32 values to f32 wherever the cast
    would make them narrower (so they are never rounded), and ``forward``
    normalises its input in at least f32 and returns it in the input's
    dtype (and memory format). A bf16 or f16 input goes to PyTorch's
    batch norm as it is, with the f32 parameters: its mixed-precision
    kernels compute in f32 and round once to the input's dtype, which is
    the cast to f32 and back (bitwise, on the CPU) without its two
    copies of the activations.
    """

    def _apply(self, fn, recurse=True):
        return super()._apply(keep_f32(fn), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.bfloat16, torch.float16):
            return super().forward(x)
        acc = torch.promote_types(x.dtype, torch.float32)
        return super().forward(x.to(acc)).to(x.dtype)


class F32BatchNorm1d(_F32Norm, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (momentum 0.1, eps 1e-5), f32 inside any model."""

    def __init__(self, num_features: int, *, device):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM,
                         device=device, dtype=torch.float32)


class F32BatchNorm2d(_F32Norm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5), f32 inside any model;
    a ``channels_last`` input comes back ``channels_last``."""

    def __init__(self, num_features: int, *, device):
        super().__init__(num_features, eps=BN_EPS, momentum=BN_MOMENTUM,
                         device=device, dtype=torch.float32)


@torch.no_grad()
def seed_batch_norm(bn: nn.modules.batchnorm._BatchNorm, generator: torch.Generator) -> None:
    """Draws a BatchNorm's scale 1 + N(0, 0.1), shift and running mean
    N(0, 0.1) and running variance U(0.5, 1.5) from ``generator`` (a CPU
    generator): no shift or mean is 0 and no scale or variance 1, so a
    statistic read from the wrong place shows in the output."""
    n = bn.num_features
    bn.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=generator))
    bn.bias.copy_(0.1 * torch.randn(n, generator=generator))
    bn.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
    bn.running_var.copy_(0.5 + torch.rand(n, generator=generator))
