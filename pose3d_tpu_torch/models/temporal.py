"""Temporal sequence lifter: the port of ``pose3d_tpu/models/temporal.py``
(``_MHSA``, ``_MLP``, ``SpatioTemporalBlock``, ``TemporalLifter``,
``clip_starts``, ``make_clips``).

(B, T, 17, 2) keypoint clips -> (B, T, 17, 3): embed to ``hidden``, add a
learned spatial (per joint) and temporal (per frame) PE, then blocks of
attention over the joints of each frame and over the frames of each
joint, each with a pre-LN GELU MLP, then LN -> hidden/2 -> ReLU -> out.

Kept for parity with the flax module: LayerNorm eps 1e-5, biases on qkv
and projection, exact GELU, softmax in f32 over scores in the module
dtype. ``interop.weights.temporal_lifter_from_flax`` maps the flax param
tree onto these modules' state dict.

``use_kernels`` is the counterpart of ``use_pallas``: the attention of
both halves goes through ``ops.attention.packed_flat_attention`` (L <= 64)
or ``seq_attention`` (longer), on flat ``[q|k|v]`` rows. On a CUDA device
they launch the attention kernel; on the CPU they run its plain version.
Not ported: ``flash`` (the JAX package's stock TPU flash kernel),
``remat`` (training memory) and ``activation_spec`` (sharding
constraints of a TPU mesh).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pose3d_tpu_torch.ops import attention
from pose3d_tpu_torch.ops.numerics import LN_EPS

PACKED_MAX_SEQ = 64  # longest sequence the packed attention form takes


class _MHSA(nn.Module):
    """Multi-head self-attention with biased qkv and output projections."""

    def __init__(self, dim: int, heads: int, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        n, length, dim = x.shape
        if use_kernels:
            qkv = self.qkv(x.reshape(n * length, dim))
            if length <= PACKED_MAX_SEQ:
                out = attention.packed_flat_attention(qkv, length, self.heads)
            else:
                out = attention.seq_attention(
                    qkv.view(n, length, 3 * dim), self.heads).view(n * length, dim)
            return self.proj(out).view(n, length, dim)
        dh = dim // self.heads
        q, k, v = self.qkv(x).view(n, length, 3, self.heads, dh).permute(2, 0, 3, 1, 4)
        s = (q @ k.transpose(-1, -2)) * dh ** -0.5
        acc = torch.promote_types(x.dtype, torch.float32)
        a = torch.softmax(s.to(acc), dim=-1).to(x.dtype)
        return self.proj((a @ v).transpose(1, 2).reshape(n, length, dim))


class _MLP(nn.Module):
    def __init__(self, dim: int, ratio: int = 4, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.fc1 = nn.Linear(dim, ratio * dim, **kw)
        self.fc2 = nn.Linear(ratio * dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(nn.functional.gelu(self.fc1(x), approximate="none"))


class SpatioTemporalBlock(nn.Module):
    """Attention over the joints of each frame, then over the frames of
    each joint; pre-LN residual throughout."""

    def __init__(self, dim: int, heads: int, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.spatial_norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.spatial_attn = _MHSA(dim, heads, **kw)
        self.spatial_norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.spatial_mlp = _MLP(dim, **kw)
        self.temporal_norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.temporal_attn = _MHSA(dim, heads, **kw)
        self.temporal_norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.temporal_mlp = _MLP(dim, **kw)

    def forward(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        b, t, j, c = x.shape
        xs = x.reshape(b * t, j, c)
        xs = xs + self.spatial_attn(self.spatial_norm1(xs), use_kernels)
        xs = xs + self.spatial_mlp(self.spatial_norm2(xs))
        xt = xs.view(b, t, j, c).transpose(1, 2).reshape(b * j, t, c)
        xt = xt + self.temporal_attn(self.temporal_norm1(xt), use_kernels)
        xt = xt + self.temporal_mlp(self.temporal_norm2(xt))
        return xt.view(b, j, t, c).transpose(1, 2)


class TemporalLifter(nn.Module):
    """(B, T, n_joints, in_dim) -> (B, T, n_joints, out_dim) f32, T <=
    ``clip_len``. The defaults are the served configuration: 17 joints,
    hidden 256, 5 blocks, 8 heads, clips of 243 frames."""

    def __init__(self, n_joints: int = 17, in_dim: int = 2, out_dim: int = 3,
                 clip_len: int = 243, hidden: int = 256, n_blocks: int = 5,
                 heads: int = 8, use_kernels: bool = False, *, device,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.n_joints = n_joints
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.clip_len = clip_len
        self.hidden = hidden
        self.n_blocks = n_blocks
        self.heads = heads
        self.use_kernels = use_kernels
        self.embed = nn.Linear(in_dim, hidden, **kw)
        self.spatial_pe = nn.Parameter(torch.empty(1, 1, n_joints, hidden, **kw))
        self.temporal_pe = nn.Parameter(torch.empty(1, clip_len, 1, hidden, **kw))
        with torch.no_grad():
            self.spatial_pe.normal_(std=0.02)
            self.temporal_pe.normal_(std=0.02)
        self.blocks = nn.ModuleList(
            SpatioTemporalBlock(hidden, heads, **kw) for _ in range(n_blocks))
        self.norm = nn.LayerNorm(hidden, eps=LN_EPS, **kw)
        self.head = nn.Sequential(
            nn.Linear(hidden, hidden // 2, **kw),
            nn.ReLU(),
            nn.Linear(hidden // 2, out_dim, **kw),
        )

    @property
    def dtype(self) -> torch.dtype:
        """Parameter and compute dtype."""
        return self.embed.weight.dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (a CPU generator):
        matrices lecun-normal as in the flax init, LayerNorm scales 1 +
        N(0, 0.1), biases, LayerNorm shifts and the PEs N(0, 0.1). Unlike
        the flax init no bias is 0 and no scale 1, so a parameter that a
        kernel reads from the wrong place shows in its output."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                t = torch.randn(p.shape, generator=generator) * p.shape[1] ** -0.5
            elif "norm" in name and name.endswith("weight"):
                t = 1.0 + 0.1 * torch.randn(p.shape, generator=generator)
            else:
                t = 0.1 * torch.randn(p.shape, generator=generator)
            p.copy_(t)
        return self

    def forward(self, x: torch.Tensor, *,
                use_kernels: bool | None = None) -> torch.Tensor:
        """``use_kernels`` None takes the module's own setting."""
        if use_kernels is None:
            use_kernels = self.use_kernels
        t = x.shape[1]
        if t > self.clip_len:
            raise ValueError(f"{t} frames exceed clip_len {self.clip_len}")
        x = self.embed(x.to(self.dtype))
        x = x + self.spatial_pe + self.temporal_pe[:, :t]
        for block in self.blocks:
            x = block(x, use_kernels)
        y = self.head(self.norm(x))
        return y.to(torch.promote_types(self.dtype, torch.float32))


def clip_starts(n: int, clip_len: int, stride: int) -> list:
    """Start offsets of sliding windows covering every frame: the regular
    stride grid plus, when its last window ends before frame n, a final
    window anchored at n - clip_len (a copy of the JAX package's)."""
    starts = list(range(0, max(n - clip_len + 1, 1), stride))
    if starts[-1] + clip_len < n:
        starts.append(max(n - clip_len, 0))
    return starts


def make_clips(sequence, clip_len: int = 243, stride: int | None = None):
    """Host-side: (N, J, D) frame sequence -> (num_clips, clip_len, J, D)
    sliding windows (stride defaults to clip_len). Every frame is covered
    (see ``clip_starts``); a too-short tail clip is padded by repeating
    the last frame."""
    stride = stride or clip_len
    clips = []
    for s in clip_starts(sequence.shape[0], clip_len, stride):
        clip = sequence[s:s + clip_len]
        if len(clip) < clip_len:
            pad = np.repeat(clip[-1:], clip_len - len(clip), axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        clips.append(clip)
    return np.stack(clips, axis=0)
