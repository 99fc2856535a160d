"""MotionBERT's dual-stream spatio-temporal transformer (DSTformer; Zhu et
al., ICCV 2023, ``lib/model/DSTformer.py``): (B, T, 17, 3) keypoint clips
(x, y and a per-joint confidence) -> (B, T, 17, 3) poses.

    h = joints_embed(x) + pos_embed[j] + temp_embed[f]
    for each layer i:
        s = ST_i(h): spatial, then temporal sub-block
        t = TS_i(h): temporal, then spatial sub-block
        a = softmax([s | t] W_i + b_i)         a pair of weights a token
        h = a_0 s + a_1 t
    y = head(tanh(pre_logits.fc(norm(h))))

A sub-block is pre-LN: x + proj(attention(qkv(LN_1 x))), then x +
fc2(GELU(fc1(LN_2 x))), exact GELU; the spatial one attends over the 17
joints of each frame, the temporal one over the T frames of each joint.
Each of the 2 x depth blocks holds its own spatial and temporal weights.
Built from ``models/temporal.py``'s ``_MHSA`` and ``_MLP``; ``use_kernels``
sends every attention through ``ops.attention`` as there (the packed
kernel at 17 joints, the sequence kernel at more than 64 frames). Where
``ops.dstformer.takes_fused`` holds (``use_kernels``, bf16 tokens on a
CUDA device, no gradient recorded, the published widths: hidden 512, 8
heads, MLP ratio 2, 17 joints, eps 1e-6), each sub-block runs on that
module's fused launches instead, on frame-major rows, neither axis
transposed; the embed, the fusions and the head stay as they are.

Parameter names are MotionBERT's (``joints_embed``, ``pos_embed``,
``temp_embed``, ``blocks_st.<i>`` / ``blocks_ts.<i>`` with ``norm1_s``,
``attn_s.qkv``, ``attn_s.proj``, ``norm2_s``, ``mlp_s.fc1``, ``mlp_s.fc2``
and the same for ``_t``, ``ts_attn.<i>``, ``norm``, ``pre_logits.fc``,
``head``), so that its checkpoint, with the ``module.`` prefix stripped as
its ``load_backbone`` does, loads with ``strict=True``. LayerNorm eps is
``load_backbone``'s 1e-6. Evaluation only: no dropout, no DropPath.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from pose3d_tpu_torch.models.temporal import TemporalLifter, _MHSA, _MLP
from pose3d_tpu_torch.ops import dstformer as fused
from pose3d_tpu_torch.train.debug import span


class DSTBlock(nn.Module):
    """One stream's block: a spatial and a temporal sub-block, run in the
    order ``order`` ("st" or "ts"), on (B, T, J, C) tokens."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, ln_eps: float, order: str, *,
                 device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.order = order
        self.norm1_s = nn.LayerNorm(dim, eps=ln_eps, **kw)
        self.norm1_t = nn.LayerNorm(dim, eps=ln_eps, **kw)
        self.attn_s = _MHSA(dim, heads, **kw)
        self.attn_t = _MHSA(dim, heads, **kw)
        self.norm2_s = nn.LayerNorm(dim, eps=ln_eps, **kw)
        self.norm2_t = nn.LayerNorm(dim, eps=ln_eps, **kw)
        self.mlp_s = _MLP(dim, mlp_ratio, **kw)
        self.mlp_t = _MLP(dim, mlp_ratio, **kw)

    def _sub_block(self, axis: str, x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        """x (N, L, C), N sequences along the sub-block's axis."""
        x = x + getattr(self, f"attn_{axis}")(getattr(self, f"norm1_{axis}")(x), use_kernels)
        return x + getattr(self, f"mlp_{axis}")(getattr(self, f"norm2_{axis}")(x))

    def forward(self, x: torch.Tensor, use_kernels: bool = False) -> torch.Tensor:
        b, t, j, c = x.shape
        for axis in self.order:
            if axis == "s":
                x = self._sub_block("s", x.reshape(b * t, j, c), use_kernels).view(b, t, j, c)
            else:  # the (b·j, t, c) layout of SpatioTemporalBlock's temporal half
                x = x.transpose(1, 2).reshape(b * j, t, c)
                x = self._sub_block("t", x, use_kernels).view(b, j, t, c).transpose(1, 2)
        return x

    def forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """The same block on the fused sub-blocks (``ops.dstformer``, its
        ``HEADS`` heads): (B, T, J, C) tokens as frame-major rows throughout,
        neither axis transposed."""
        b, t, j, c = x.shape
        rows = x.reshape(b * t * j, c)
        for axis in self.order:
            rows = fused.sub_block(rows, fused.weights(self, axis), axis, t)
        return rows.view(b, t, j, c)


def fuse(att: nn.Linear, s: torch.Tensor, t: torch.Tensor):
    """The streams' per-token fusion: (a_0 s + a_1 t, a) with the weights
    a = softmax([s | t] W + b), (..., 2), the softmax in f32 and a in the
    streams' dtype. [s | t] W is formed as s W_s + t W_t, without the
    concatenated 2C-wide rows."""
    c = s.shape[-1]
    logits = (nn.functional.linear(s, att.weight[:, :c])
              + nn.functional.linear(t, att.weight[:, c:], att.bias))
    a = torch.softmax(logits.float(), dim=-1).to(s.dtype)
    return s * a[..., :1] + t * a[..., 1:], a


class DSTformer(nn.Module):
    """(B, T, n_joints, in_dim) -> (B, T, n_joints, out_dim) in the
    parameters' dtype promoted to f32, T <= ``clip_len``. The defaults are
    MotionBERT's ``MB_train_h36m.yaml``: dim_feat 512, dim_rep 512, depth
    5, 8 heads, mlp_ratio 2, maxlen 243, 17 joints, dim_in 3, att_fuse."""

    def __init__(self, n_joints: int = 17, in_dim: int = 3, out_dim: int = 3,
                 clip_len: int = 243, hidden: int = 512, rep_dim: int = 512, n_blocks: int = 5,
                 heads: int = 8, mlp_ratio: int = 2, ln_eps: float = 1e-6,
                 use_kernels: bool = False, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.n_joints = n_joints
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.hidden = hidden
        self.n_blocks = n_blocks
        self.heads = heads
        self.use_kernels = use_kernels
        self.joints_embed = nn.Linear(in_dim, hidden, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_joints, hidden, **kw))
        self.temp_embed = nn.Parameter(torch.zeros(1, clip_len, 1, hidden, **kw))
        self.blocks_st = nn.ModuleList(DSTBlock(hidden, heads, mlp_ratio, ln_eps, "st", **kw)
                                       for _ in range(n_blocks))
        self.blocks_ts = nn.ModuleList(DSTBlock(hidden, heads, mlp_ratio, ln_eps, "ts", **kw)
                                       for _ in range(n_blocks))
        self.norm = nn.LayerNorm(hidden, eps=ln_eps, **kw)
        self.pre_logits = nn.Sequential(OrderedDict(
            fc=nn.Linear(hidden, rep_dim, **kw), act=nn.Tanh()))
        self.head = nn.Linear(rep_dim, out_dim, **kw)
        self.ts_attn = nn.ModuleList(nn.Linear(2 * hidden, 2, **kw) for _ in range(n_blocks))
        with torch.no_grad():
            self.pos_embed.normal_(std=0.02)
            self.temp_embed.normal_(std=0.02)

    # the seeded init of the kernel tests: every parameter drawn, none 0 or 1
    init_weights = TemporalLifter.init_weights

    @property
    def clip_len(self) -> int:
        return self.temp_embed.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        """Parameter and compute dtype."""
        return self.joints_embed.weight.dtype

    def forward(self, x: torch.Tensor, *, use_kernels: bool | None = None) -> torch.Tensor:
        """``use_kernels`` None takes the module's own setting."""
        if use_kernels is None:
            use_kernels = self.use_kernels
        t = x.shape[1]
        if t > self.clip_len:
            raise ValueError(f"{t} frames exceed clip_len {self.clip_len}")
        h = self.joints_embed(x.to(self.dtype)) + self.pos_embed
        h = h + self.temp_embed[:, :t]
        on_fused = fused.takes_fused(self, h, use_kernels)
        with span("pose3d.temporal.trunk"):
            for st, ts, att in zip(self.blocks_st, self.blocks_ts, self.ts_attn):
                if on_fused:
                    s, u = st.forward_fused(h), ts.forward_fused(h)
                else:
                    s, u = st(h, use_kernels), ts(h, use_kernels)
                with span("pose3d.temporal.fuse"):
                    h, _ = fuse(att, s, u)
        y = self.head(self.pre_logits(self.norm(h)))
        return y.to(torch.promote_types(self.dtype, torch.float32))
