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

Under data parallelism a BatchNorm is local (each rank normalises its
shard with the shard's statistics) unless ``sync_batch_norm(model, mesh)``
binds the model to the data axis' process group, once, where the mesh
meets the model (the trainers bind it beside ``broadcast_parameters`` and
unbind it before the group ends). Then, in train mode over more than one
rank, it normalises with the statistics of the global batch, as the JAX
package's BatchNorm does under GSPMD (``pose3d_tpu/models/norm.py``):
``_GlobalBatchNorm`` all-reduces [Σx, Σx², n] in at least f32, takes
JAX's variance max(E[x²] - E[x]², 0), and updates ``running_var`` with the
unbiased factor of the global count n (JAX's static ``n``). It saves x in
its own dtype and the per-channel mean and 1/σ, as PyTorch's batch norm
does, and normalises with PyTorch's eval-mode batch norm on those
statistics (one pass). Its backward all-reduces [Σdy, Σdy·x̂] (on the
card [Σdy, Σdy·(x - mean)], through ``SyncBatchNorm``'s kernels) and
returns the rank's own weight and bias gradients, the scale
``SyncBatchNorm`` has under DDP: each rank's backward starts from its
local mean loss, and the steps then average the parameter gradients
(``parallel.mesh.pmean_``). Eval mode and a group of one rank run the
module as it is, bitwise. The steps check the model's binding
(``require_batch_norm``) and never change it. ``torch.nn.SyncBatchNorm``
takes no CPU tensor, so the port has its own. On a (data, model) mesh
the bound group is the data axis'; a BatchNorm cut over the model axis
(``parallel/sharding.shard_params``) normalises its channel shard, per
channel as ever, so its running statistics update only its channels.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
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

    process_group = None  # set by sync_batch_norm: the global batch's ranks, if more than one

    def _apply(self, fn, recurse=True):
        return super()._apply(keep_f32(fn), recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.process_group is not None:
            self.num_batches_tracked.add_(1)
            return _GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                          self.running_var, self.momentum, self.eps,
                                          self.process_group)
        if x.dtype in (torch.bfloat16, torch.float16):
            return super().forward(x)
        acc = torch.promote_types(x.dtype, torch.float32)
        return super().forward(x.to(acc)).to(x.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of ``group``'s ranks
    (x: (N, C) or (N, C, ...)), the running statistics updated in place;
    returns x's dtype and memory format.

    On the card the backward runs PyTorch's batch-norm kernels, those of
    ``SyncBatchNorm`` (one reduction pass over x and dy, the all-reduce,
    one elementwise pass): they exist for CUDA only, so on the CPU the
    same sums and input gradient are written out in tensor operations."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, group):
        acc = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        dims = [0, *range(2, x.dim())]
        # one read of x each, no widened copy: Σx, and Σx² as |x|² over dims
        stats = torch.cat([x.sum(dims, dtype=acc),
                           torch.linalg.vector_norm(x, 2, dims, dtype=acc).square_(),
                           x.new_full((1,), x.numel() // c, dtype=acc)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c:]
        mean, ex2 = (stats[:2 * c] / n).view(2, c)
        var = torch.addcmul(ex2, mean, mean, value=-1.0).clamp_min_(0.0)
        invstd = (var + eps).rsqrt_()
        with torch.no_grad():
            running_mean.lerp_(mean, momentum)
            running_var.lerp_(var * (n / (n - 1).clamp_min(1.0)), momentum)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        return F.batch_norm(x, mean, var, weight.to(acc), bias.to(acc), False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c, w = x.shape[1], weight.to(mean.dtype)
        if x.is_cuda:
            if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
                dy = dy.contiguous(memory_format=torch.channels_last)
            else:
                dy = dy.contiguous()
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, w, True, True, True)
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, group=ctx.group)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, w, sums[:c], sums[c:],
                                                 n.to(torch.int32))
        else:
            dims = [0, *range(2, x.dim())]
            shape = (1, c) + (1,) * (x.dim() - 2)
            xhat = (x.to(mean.dtype) - mean.view(shape)) * invstd.view(shape)
            dyf = dy.to(mean.dtype)
            db, dw = dyf.sum(dims), (dyf * xhat).sum(dims)
            sums = torch.cat([db, dw])
            dist.all_reduce(sums, group=ctx.group)
            dx = (w * invstd).view(shape) * (
                dyf - (sums[:c] / n).view(shape) - xhat * (sums[c:] / n).view(shape))
        return (dx.to(dy.dtype), dw.to(weight.dtype), db.to(weight.dtype),
                None, None, None, None, None)


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


def sync_batch_norm(model: nn.Module, mesh) -> nn.Module:
    """Binds every BatchNorm of ``model`` to ``mesh``'s data axis (train
    mode normalises with the global batch's statistics where the axis has
    more than one rank), or local again with ``mesh=None``; returns
    ``model``. Called once where the mesh meets the model, not by a step.
    Raises on a BatchNorm that is not one of this module's (it would stay
    local)."""
    group = None
    if mesh is not None:
        from pose3d_tpu_torch.parallel.mesh import data_group

        group = data_group(mesh)
    per_norm = group if group is not None and dist.get_world_size(group) > 1 else None
    for name, m in model.named_modules():
        if isinstance(m, _F32Norm):
            m.process_group = per_norm
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"{name}: {type(m).__name__} cannot be made global; the port's "
                            "models use F32BatchNorm1d / F32BatchNorm2d")
    model.batch_norm_group = group
    return model


def require_batch_norm(model: nn.Module, mesh) -> None:
    """Raise unless ``model``'s BatchNorms are bound as a step over
    ``mesh`` needs them: global over its data axis (``sync_batch_norm(model,
    mesh)``), or local with ``mesh=None``."""
    want = None
    if mesh is not None:
        from pose3d_tpu_torch.parallel.mesh import data_group

        want = data_group(mesh)
    if getattr(model, "batch_norm_group", None) is not want:
        raise ValueError(f"{type(model).__name__}'s BatchNorms are "
                         + ("local; bind them with sync_batch_norm(model, mesh)"
                            if want is not None else
                            "global; this step wants them local (sync_batch_norm(model, None))"))


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
