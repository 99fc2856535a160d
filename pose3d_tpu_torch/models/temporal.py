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

The long-clip options, with JAX's names and defaults (off):

- ``flash``: the attention of the temporal half goes through
  ``ops.flash_attention.flash_attention`` (kernels 14a-14c on a CUDA
  device, bf16 only; the plain version on the CPU), which never forms the
  (L, L) scores; the spatial half keeps its route. ``use_kernels`` takes
  precedence, as ``use_pallas`` does in JAX.
- ``remat``: each block runs under ``torch.utils.checkpoint`` (not
  reentrant) while grad is enabled, so its activations are recomputed in
  the backward; values and gradients are the module's own.
- ``activation_spec``: sequence parallelism. ``("data", "model", None,
  None)`` splits the frame axis of the (B, T, J, C) activations over the
  model axis of a ``parallel.mesh`` mesh, bound once to the model by
  ``parallel.sharding.sequence_parallel``; the data axis is the step's
  batch split. Each model rank embeds its T / n_model frames with its
  slice of ``temporal_pe``, runs the spatial halves, MLPs, LayerNorms and
  the head on them, and in each temporal attention attends with its own
  queries to K and V gathered over the model group (``flash`` on or off);
  the gather's backward sums each rank's dK and dV over the group and
  keeps the rank's slice. The prediction is gathered whole on every model
  rank. T must divide by the model axis (``ValueError``; GSPMD pads).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from pose3d_tpu_torch.ops import attention
from pose3d_tpu_torch.ops.flash_attention import flash_attention
from pose3d_tpu_torch.ops.numerics import LN_EPS
from pose3d_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, gather_model_grad, model_rank,
                                            model_size)

PACKED_MAX_SEQ = 64  # longest sequence the packed attention form takes


class _MHSA(nn.Module):
    """Multi-head self-attention with biased qkv and output projections;
    ``flash`` routes the module path's attention through
    ``ops.flash_attention``."""

    def __init__(self, dim: int, heads: int, *, flash: bool = False, device,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.heads = heads
        self.flash = flash
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x: torch.Tensor, use_kernels: bool = False, mesh=None) -> torch.Tensor:
        """``mesh``: x holds this model rank's frames of each sequence, and
        K and V are gathered over the mesh's model axis."""
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
        qkv = self.qkv(x)
        kv = None if mesh is None else gather_model_grad(qkv[..., dim:], 1, mesh, reduce=True)
        if self.flash:
            return self.proj(flash_attention(qkv, self.heads, kv))
        if kv is None:
            q, k, v = qkv.view(n, length, 3, self.heads, dh).permute(2, 0, 3, 1, 4)
        else:
            q = qkv[..., :dim].reshape(n, length, self.heads, dh).transpose(1, 2)
            k, v = kv.view(n, kv.shape[1], 2, self.heads, dh).permute(2, 0, 3, 1, 4)
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
    each joint; pre-LN residual throughout. ``flash`` applies to the
    temporal attention only."""

    def __init__(self, dim: int, heads: int, *, flash: bool = False, device,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.spatial_norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.spatial_attn = _MHSA(dim, heads, **kw)
        self.spatial_norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.spatial_mlp = _MLP(dim, **kw)
        self.temporal_norm1 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.temporal_attn = _MHSA(dim, heads, flash=flash, **kw)
        self.temporal_norm2 = nn.LayerNorm(dim, eps=LN_EPS, **kw)
        self.temporal_mlp = _MLP(dim, **kw)

    def forward(self, x: torch.Tensor, use_kernels: bool = False, mesh=None) -> torch.Tensor:
        b, t, j, c = x.shape
        xs = x.reshape(b * t, j, c)
        xs = xs + self.spatial_attn(self.spatial_norm1(xs), use_kernels)
        xs = xs + self.spatial_mlp(self.spatial_norm2(xs))
        xt = xs.view(b, t, j, c).transpose(1, 2).reshape(b * j, t, c)
        xt = xt + self.temporal_attn(self.temporal_norm1(xt), use_kernels, mesh)
        xt = xt + self.temporal_mlp(self.temporal_norm2(xt))
        return xt.view(b, j, t, c).transpose(1, 2)


class TemporalLifter(nn.Module):
    """(B, T, n_joints, in_dim) -> (B, T, n_joints, out_dim) f32, T <=
    ``clip_len``. The defaults are the served configuration: 17 joints,
    hidden 256, 5 blocks, 8 heads, clips of 243 frames. ``remat``,
    ``flash`` and ``activation_spec``: see the module docstring."""

    def __init__(self, n_joints: int = 17, in_dim: int = 2, out_dim: int = 3,
                 clip_len: int = 243, hidden: int = 256, n_blocks: int = 5,
                 heads: int = 8, use_kernels: bool = False, remat: bool = False,
                 flash: bool = False, activation_spec: tuple | None = None, *, device,
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
        self.remat = remat
        self.flash = flash
        self.activation_spec = check_activation_spec(activation_spec)
        self.sp_mesh = None  # bound by parallel.sharding.sequence_parallel
        self.embed = nn.Linear(in_dim, hidden, **kw)
        self.spatial_pe = nn.Parameter(torch.empty(1, 1, n_joints, hidden, **kw))
        self.temporal_pe = nn.Parameter(torch.empty(1, clip_len, 1, hidden, **kw))
        with torch.no_grad():
            self.spatial_pe.normal_(std=0.02)
            self.temporal_pe.normal_(std=0.02)
        self.blocks = nn.ModuleList(
            SpatioTemporalBlock(hidden, heads, flash=flash, **kw) for _ in range(n_blocks))
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

    @property
    def splits_frames(self) -> bool:
        """True where ``activation_spec`` splits the frames over the model
        axis."""
        return self.activation_spec is not None and self.activation_spec[1] == MODEL_AXIS

    def _frame_mesh(self):
        """The bound mesh where this model's frames are split over more than
        one model rank, else None; raises where the spec asks for a split
        and no mesh is bound."""
        if not self.splits_frames:
            return None
        if self.sp_mesh is None:
            raise RuntimeError("activation_spec splits the frames over the model axis: bind a "
                               "mesh first (parallel.sharding.sequence_parallel)")
        return self.sp_mesh if model_size(self.sp_mesh) > 1 else None

    def forward(self, x: torch.Tensor, *,
                use_kernels: bool | None = None) -> torch.Tensor:
        """``use_kernels`` None takes the module's own setting."""
        if use_kernels is None:
            use_kernels = self.use_kernels
        t = x.shape[1]
        if t > self.clip_len:
            raise ValueError(f"{t} frames exceed clip_len {self.clip_len}")
        pe = self.temporal_pe[:, :t]
        mesh = self._frame_mesh()
        if mesh is not None:
            n = model_size(mesh)
            if use_kernels:
                raise ValueError("sequence parallelism runs the module route; use_kernels "
                                 "takes whole sequences")
            if t % n:
                raise ValueError(f"{t} frames do not split over {n} model ranks")
            w = t // n
            x, pe = x.narrow(1, model_rank(mesh) * w, w), pe.narrow(1, model_rank(mesh) * w, w)
        x = self.embed(x.to(self.dtype))
        x = x + self.spatial_pe + pe
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_kernels, mesh, use_reentrant=False)
            else:
                x = block(x, use_kernels, mesh)
        y = self.head(self.norm(x))
        if mesh is not None:  # the loss reads the whole clip on every model rank
            y = gather_model_grad(y, 1, mesh, reduce=False)
        return y.to(torch.promote_types(self.dtype, torch.float32))


def check_activation_spec(spec):
    """``spec`` as a tuple, or None; raises ValueError unless it is a
    (B, T, J, C) spec that splits at most the batch over ``data`` and the
    frames over ``model`` (what a step over a (data, model) mesh runs)."""
    if spec is None:
        return None
    spec = tuple(spec)
    if (len(spec) != 4 or spec[0] not in (None, DATA_AXIS)
            or spec[1] not in (None, MODEL_AXIS) or spec[2:] != (None, None)):
        raise ValueError(f"activation_spec {spec}: the port splits the batch over "
                         f"{DATA_AXIS!r} and the frames over {MODEL_AXIS!r}, nothing else")
    return spec


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
