"""The 2D -> 3D lifters: the port of ``pose3d_tpu/models/lifters.py``.

``MartinezBlock``, ``MartinezLifter`` and ``AELifter`` are the residual
BatchNorm MLPs of the reference (``LinearModel`` and ``AE``): flat
(B, 34) or (B, 17, 2) keypoints in, (B, out_dim) out, in at least f32.
Their parameter names are the reference's state-dict keys (Martinez:
``w1``, ``batch_norm1``, ``linear_stages.{i}.{w1,batch_norm1,w2,
batch_norm2}``, ``w2``; AE: ``encoder2.{1,2,5,6}``, ``decoder2.{0,1,4}``),
so ``load_state_dict(strict=True)`` takes what ``interop.weights.
martinez_lifter_from_flax`` / ``ae_lifter_from_flax`` return. Dropout is
active in training only, and ``use_bn=False`` drops every BatchNorm of
the Martinez lifter. The AE has no Tanh: it is dead code in the reference.

BatchNorm stays f32 in a model of any narrower dtype (``F32BatchNorm1d``
of ``models/norm.py``),
as the flax ``BatchNorm`` of the JAX package (``models/norm.py``) keeps
its parameters and statistics f32 and normalises in f32 whatever the
model's dtype: a bf16 cast of the running mean and variance would round
them.

``JointAttention``, ``TransformerBlock`` and ``JointTransformerLifter``
are the reference MyViT (17 joint tokens -> Linear to hidden 256
-> fixed sinusoidal PE -> 2 pre-LN blocks with 4 heads -> per-token MLP
256 -> 128 -> out). Its parameter names are the reference's state-dict
keys (``linear_mapper``, ``blocks.{i}.norm1``, ``blocks.{i}.mhsa.{norm,
to_qkv,to_out}``, ``blocks.{i}.norm2``, ``blocks.{i}.mlp.{0,2}``,
``mlp.{0,2}``), so ``load_state_dict(strict=True)`` takes what
``interop.weights.vit_lifter_from_flax`` returns.

Kept for parity with the JAX module:

- every LayerNorm has eps 1e-5;
- the double LN: the block's pre-LN, then the attention's own LN;
- the qkv and output projections have no bias;
- GELU is exact (erf);
- the PE is a fixed, non-persistent buffer.

``dtype`` is both the parameter and the compute dtype (BatchNorm apart);
softmax runs in at least f32, as the flax module's does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pose3d_tpu_torch.models.norm import F32BatchNorm1d, seed_batch_norm
from pose3d_tpu_torch.ops.numerics import LN_EPS


def sinusoidal_positional_embeddings(sequence_length: int, d: int) -> np.ndarray:
    """Fixed PE with the reference's formula (a copy of the JAX package's):
    pe[i, j] = sin(i / 1e4^(j/d)) for even j, cos(i / 1e4^((j-1)/d)) for odd j.
    """
    i = np.arange(sequence_length)[:, None].astype(np.float64)
    j = np.arange(d)[None, :].astype(np.float64)
    angle_even = i / np.power(1e4, j / d)
    angle_odd = i / np.power(1e4, (j - 1) / d)
    pe = np.where(j % 2 == 0, np.sin(angle_even), np.cos(angle_odd))
    return pe.astype(np.float32)


@torch.no_grad()
def _init_linear_bn(module: nn.Module, generator: torch.Generator) -> None:
    """Draws every Linear and BatchNorm of ``module`` from ``generator``:
    Linear weights lecun-normal, biases N(0, 0.1); BatchNorm scales
    1 + N(0, 0.1), shifts and running means N(0, 0.1), running variances
    U(0.5, 1.5). No bias is 0, no scale or variance 1 and no mean 0, so
    folding BatchNorm is tested with real statistics."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            w = torch.randn(m.weight.shape, generator=generator)
            m.weight.copy_(w * m.in_features ** -0.5)
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
        elif isinstance(m, nn.BatchNorm1d):
            seed_batch_norm(m, generator)


class MartinezBlock(nn.Module):
    """Residual block: 2 x (Linear -> BN -> ReLU -> Dropout) + skip
    (reference ``Linear``)."""

    def __init__(self, size: int = 1024, dropout: float = 0.5, use_bn: bool = True,
                 *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.w1 = nn.Linear(size, size, **kw)
        self.batch_norm1 = F32BatchNorm1d(size, device=device) if use_bn else None
        self.w2 = nn.Linear(size, size, **kw)
        self.batch_norm2 = F32BatchNorm1d(size, device=device) if use_bn else None
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for linear, bn in ((self.w1, self.batch_norm1), (self.w2, self.batch_norm2)):
            y = linear(y)
            if bn is not None:
                y = bn(y)
            y = self.dropout(torch.relu(y))
        return x + y


class MartinezLifter(nn.Module):
    """Martinez-style residual-MLP lifter (reference ``LinearModel``):
    Linear(in_dim, hidden) -> BN -> ReLU -> Dropout -> ``num_stages`` x
    ``MartinezBlock`` -> Linear(hidden, out_dim)."""

    def __init__(self, in_dim: int = 34, out_dim: int = 51, hidden: int = 1024,
                 num_stages: int = 2, dropout: float = 0.5, use_bn: bool = True,
                 *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.hidden = hidden
        self.num_stages = num_stages
        self.use_bn = use_bn
        self.w1 = nn.Linear(in_dim, hidden, **kw)
        self.batch_norm1 = F32BatchNorm1d(hidden, device=device) if use_bn else None
        self.dropout = nn.Dropout(dropout)
        self.linear_stages = nn.ModuleList(
            MartinezBlock(hidden, dropout, use_bn, **kw) for _ in range(num_stages))
        self.w2 = nn.Linear(hidden, out_dim, **kw)

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype (of the Linear layers)."""
        return self.w1.weight.dtype

    def init_weights(self, generator: torch.Generator):
        """Draw every parameter and BN statistic from ``generator`` (a CPU
        generator), as ``_init_linear_bn`` says."""
        _init_linear_bn(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 17, 2) or (B, in_dim) -> (B, out_dim) in at least f32."""
        y = self.w1(x.reshape(x.shape[0], -1).to(self.dtype))
        if self.batch_norm1 is not None:
            y = self.batch_norm1(y)
        y = self.dropout(torch.relu(y))
        for stage in self.linear_stages:
            y = stage(y)
        return self.w2(y).to(torch.promote_types(self.dtype, torch.float32))


class AELifter(nn.Module):
    """Autoencoder lifter: the reference ``AE``'s active encoder2/decoder2
    path, Flatten -> [Linear(hidden) BN ReLU Dropout] x 2 -> Linear(hidden)
    BN ReLU Dropout -> Linear(out_dim), with no Tanh."""

    def __init__(self, in_dim: int = 34, out_dim: int = 51, hidden: int = 1024,
                 dropout: float = 0.5, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.hidden = hidden

        def layer(d_in):
            return [nn.Linear(d_in, hidden, **kw), F32BatchNorm1d(hidden, device=device),
                    nn.ReLU(), nn.Dropout(dropout)]

        self.encoder2 = nn.Sequential(nn.Flatten(), *layer(in_dim), *layer(hidden))
        self.decoder2 = nn.Sequential(*layer(hidden), nn.Linear(hidden, out_dim, **kw))

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype (of the Linear layers)."""
        return self.encoder2[1].weight.dtype

    def init_weights(self, generator: torch.Generator):
        """As ``MartinezLifter.init_weights``."""
        _init_linear_bn(self, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 17, 2) or (B, in_dim) -> (B, out_dim) in at least f32."""
        y = self.encoder2(x.reshape(x.shape[0], -1).to(self.dtype))
        return self.decoder2(y).to(torch.promote_types(self.dtype, torch.float32))


class JointAttention(nn.Module):
    """Multi-head self-attention over joint tokens, with the module-local
    LayerNorm of the reference (``mhsa.norm``) and bias-free projections."""

    def __init__(self, dim: int, heads: int, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads = heads
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False, **kw)
        self.to_out = nn.Linear(dim, dim, bias=False, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        dh = dim // self.heads
        qkv = self.to_qkv(self.norm(x))
        # (B, N, 3*H*D) -> 3 x (B, H, N, D)
        q, k, v = qkv.view(b, n, 3, self.heads, dh).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)) * dh ** -0.5
        acc = torch.promote_types(x.dtype, torch.float32)
        a = torch.softmax(s.to(acc), dim=-1).to(x.dtype)
        out = (a @ v).transpose(1, 2).reshape(b, n, dim)
        return self.to_out(out)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHSA(LN(x)); x + MLP(LN(x)) with exact GELU."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, *, device,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.mhsa = JointAttention(dim, heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.mlp = nn.Sequential(
            nn.Linear(dim, mlp_ratio * dim, **kw),
            nn.GELU(approximate="none"),
            nn.Linear(mlp_ratio * dim, dim, **kw),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.mhsa(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class JointTransformerLifter(nn.Module):
    """Joint-token transformer lifter (reference ``MyViT``).

    (B, n_joints, in_dim) -> (B, n_joints, out_dim), returned in f32 (or
    wider). The defaults are the served configuration: 17 tokens, 2
    blocks, hidden 256, 4 heads, out 3. ``in_dim=3, out_dim=2`` is the
    phase-5 projector; ``class_token=True`` the two2three variant.
    """

    def __init__(self, n_joints: int = 17, in_dim: int = 2, out_dim: int = 3,
                 hidden: int = 256, n_blocks: int = 2, heads: int = 4,
                 class_token: bool = False, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.n_joints = n_joints
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.hidden = hidden
        self.n_blocks = n_blocks
        self.heads = heads
        self.class_token = class_token
        self.linear_mapper = nn.Linear(in_dim, hidden, **kw)
        seq = n_joints + (1 if class_token else 0)
        if class_token:
            self.cls_token = nn.Parameter(
                torch.empty(1, 1, hidden, **kw).normal_(std=0.02))
        pe = torch.from_numpy(sinusoidal_positional_embeddings(seq, hidden))
        self.register_buffer("pe", pe.to(**kw), persistent=False)
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden, heads, **kw) for _ in range(n_blocks))
        self.mlp = nn.Sequential(
            nn.Linear(hidden, hidden // 2, **kw),
            nn.ReLU(),
            nn.Linear(hidden // 2, out_dim, **kw),
        )

    @property
    def dtype(self) -> torch.dtype:
        """Parameter and compute dtype."""
        return self.linear_mapper.weight.dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (a CPU generator):
        matrices lecun-normal as in the flax init, LayerNorm scales 1 +
        N(0, 0.1), biases, LayerNorm shifts and the class token N(0, 0.1).
        Unlike the flax init no bias is 0 and no scale 1, so a parameter
        that a kernel reads from the wrong place shows in its output."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                t = torch.randn(p.shape, generator=generator) * p.shape[1] ** -0.5
            elif "norm" in name and name.endswith("weight"):
                t = 1.0 + 0.1 * torch.randn(p.shape, generator=generator)
            else:
                t = 0.1 * torch.randn(p.shape, generator=generator)
            p.copy_(t)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        tokens = self.linear_mapper(x)
        if self.class_token:
            cls = self.cls_token.expand(x.shape[0], 1, self.hidden)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.pe
        for block in self.blocks:
            tokens = block(tokens)
        if self.class_token:
            tokens = tokens[:, 1:]
        y = self.mlp(tokens)
        return y.to(torch.promote_types(self.dtype, torch.float32))
