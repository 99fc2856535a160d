"""Fused forward AND backward sub-blocks of the temporal lifter, for
training: the port of ``pose3d_tpu/ops/pallas_stblock_train.py``.

The two halves of a ``SpatioTemporalBlock`` (``ops/stblock``: spatial
attention over the 17 joints of each frame on flat (rows, 256) rows, and
temporal attention over the T frames of each joint on the (C, T, 17·256)
slab, the same bytes, or on (n, L, 256) joint-major sequences) each get

- a forward that also returns the two residuals the backward reads:
  ``x1``, the residual stream after the projection, and ``att``, the
  attention output before it (``spatial_fwd``, ``slab_fwd``,
  ``sequences_fwd``);
- a backward that recomputes the rest from ``x`` and ``x1`` and returns
  ``dx`` and the 12 weight and bias gradients, f32, summed over every row,
  as one flat tensor in the weights' layout (``spatial_bwd``,
  ``slab_bwd``, ``sequences_bwd``).

Each wrapper launches its CUDA kernels (``csrc/stblock.cu`` for the
forwards, ``csrc/stblock_train.cu`` for the backwards) when its operands
lie on a CUDA device and runs its plain version (``*_reference``: for the
forwards, ``ops/stblock``'s serving references with the residuals
returned; for the backwards, a direct transcription of the JAX
``_subblock_bwd``) when they lie on the CPU. ``SpatialBlockTrain`` /
``TemporalSlabTrain`` / ``TemporalBlockTrain`` are the
``autograd.Function``s around them (``temporal_block_train`` is the JAX
package's joint-major entry);
``temporal_train_forward_fused`` is the differentiable ``TemporalLifter``
forward on them (embed + PE and the head stay plain tensor code, as JAX
leaves them to XLA).

Numerical contract, the JAX kernels': products accumulate in f32;
LayerNorm, softmax and GELU-gradient math is f32; activations and row
gradients are rounded to the working dtype at the points ``subblock_bwd``
spells out; weight gradients are summed in f32 and handed to autograd in
the weights' dtype. Attention is per head (JAX's ``ATTN_GROUP`` is a TPU
layout of the same math).
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build, attention
from pose3d_tpu_torch.ops.numerics import dot, gelu, gelu_grad, ln_bwd_input, ln_fwd_stats
from pose3d_tpu_torch.ops.stblock import (
    BLOCK_ELEMS,
    DIM,
    DIM_HEAD,
    HEADS,
    N_JOINTS,
    SubBlockWeights,
    _check_operands,
    check_rows,
    check_sequences,
    check_slab,
    embed_clips,
    frame_major,
    joint_major,
    pack_half,
    run_sequences,
    run_slab,
    run_spatial,
    spatial_block_reference,
    supports,
    temporal_block_reference,
    temporal_head,
    temporal_slab_reference,
)
from pose3d_tpu_torch.train.debug import span

# the backward launcher's row layouts (csrc/stblock_train.cu enum Layout)
LAYOUT_SPATIAL, LAYOUT_SLAB, LAYOUT_SEQUENCES = 0, 1, 2
BWD_MAX_LEN = 256  # the longest sequence the attention backward kernel takes


# ---------------------------------------------------------------- plain math

def attention_bwd(qkv: torch.Tensor, datt: torch.Tensor) -> torch.Tensor:
    """dqkv (..., L, 768) f32 of per-head attention within each sequence of
    L rows, from its qkv (working dtype) and the f32 gradient of its output
    (pallas_stblock_train._attention_bwd, per head). With probabilities
    a = e·r, e the clamped numerator with no row max and r = 1/sum(e):
    dv = bf16(e)^T·bf16(r·do); ds = bf16(t - c·e) with t = da·e,
    c = r·sum(t); dq = (ds·k)·(r·scale); dk = ds^T·bf16(bf16(r)·q)·scale."""
    dt = qkv.dtype
    scale = DIM_HEAD ** -0.5
    dq, dk, dv = [], [], []
    for h in range(HEADS):
        cols = slice(h * DIM_HEAD, (h + 1) * DIM_HEAD)
        q = qkv[..., cols]
        k = qkv[..., DIM + cols.start:DIM + cols.stop]
        v = qkv[..., 2 * DIM + cols.start:2 * DIM + cols.stop]
        e = attention.score_exp(dot(q, k.transpose(-1, -2)) * scale)
        r = 1.0 / e.sum(dim=-1, keepdim=True)
        do = datt[..., cols].float()
        dv.append(dot(e.to(dt).transpose(-1, -2), (r * do).to(dt)))
        t = dot(do.to(dt), v.transpose(-1, -2)) * e
        c = r * t.sum(dim=-1, keepdim=True)
        ds = (t - c * e).to(dt)
        dq.append(dot(ds, k) * (r * scale))
        dk.append(dot(ds.transpose(-1, -2), (r.to(dt) * q).to(dt)) * scale)
    return torch.cat(dq + dk + dv, dim=-1)


def _attend_bwd_spatial(qkv, datt):
    rows = qkv.shape[0]
    return attention_bwd(qkv.view(rows // N_JOINTS, N_JOINTS, -1),
                         datt.view(rows // N_JOINTS, N_JOINTS, -1)).view(rows, -1)


def subblock_bwd(x, x1, att, dout, w: dict, attend_bwd):
    """Backward of one sub-block on (R, 256) rows from the saved x, x1 and
    att; ``attend_bwd(qkv, datt)`` -> dqkv f32. Returns (dx in x.dtype, the
    12 weight gradients f32 as one flat tensor in ``_LAYOUT`` order)."""
    dt = x.dtype
    g1f, g2f = w["ln1_g"].float(), w["ln2_g"].float()
    # recompute what the forward did not save
    xhat1, r1 = ln_fwd_stats(x)
    y = (xhat1 * g1f + w["ln1_b"].float()).to(dt)
    qkv = (dot(y, w["w_qkv"]) + w["b_qkv"].float()).to(dt)
    xhat2, r2 = ln_fwd_stats(x1)
    y2 = (xhat2 * g2f + w["ln2_b"].float()).to(dt)
    h_pre = dot(y2, w["w1"]) + w["b1"].float()  # f32
    hg = gelu(h_pre.to(dt))

    # MLP half: out = x1 + hg @ w2 + b2
    doutf = dout.float()
    dw2 = dot(hg.t(), dout)
    db2f = doutf.sum(0)
    dh = (dot(dout, w["w2"].t()) * gelu_grad(h_pre)).to(dt)  # gelu' of the f32 h_pre
    dw1 = dot(y2.t(), dh)
    db1f = dh.float().sum(0)
    dy2 = dot(dh, w["w1"].t())
    dg2 = (dy2 * xhat2).sum(0)
    db2 = dy2.sum(0)
    dx1 = doutf + ln_bwd_input(dy2 * g2f, xhat2, r2)  # f32

    # attention half: x1 = x + att @ wp + bp
    dx1_dt = dx1.to(dt)
    dwp = dot(att.t(), dx1_dt)
    dbp = dx1.sum(0)
    dqkv = attend_bwd(qkv, dot(dx1_dt, w["w_proj"].t()))  # f32
    dbqkv = dqkv.sum(0)
    dqkv_dt = dqkv.to(dt)
    dwqkv = dot(y.t(), dqkv_dt)
    dy = dot(dqkv_dt, w["w_qkv"].t())
    dg1 = (dy * xhat1).sum(0)
    db1 = dy.sum(0)
    dx = dx1 + ln_bwd_input(dy * g1f, xhat1, r1)
    dws = (dg1, db1, dwqkv, dbqkv, dwp, dbp, dg2, db2, dw1, db1f, dw2, db2f)
    return dx.to(dt), torch.cat([d.reshape(-1) for d in dws])


def spatial_fwd_reference(x: torch.Tensor, w: SubBlockWeights):
    """Plain version of ``spatial_fwd``."""
    return spatial_block_reference(x, w, with_residuals=True)


def spatial_bwd_reference(x, x1, att, dout, w: SubBlockWeights):
    """Plain version of ``spatial_bwd``."""
    return subblock_bwd(x, x1, att, dout, w.parts(), _attend_bwd_spatial)


def slab_fwd_reference(x_slab: torch.Tensor, w: SubBlockWeights):
    """Plain version of ``slab_fwd``."""
    return temporal_slab_reference(x_slab, w, with_residuals=True)


def slab_bwd_reference(x_slab, x1, att, dout, w: SubBlockWeights):
    """Plain version of ``slab_bwd``."""
    c = x_slab.shape[0]

    def attend_bwd(qkv, datt):
        return frame_major(attention_bwd(joint_major(qkv, c), joint_major(datt, c)), c)

    dx, dw = subblock_bwd(*(t.reshape(-1, DIM) for t in (x_slab, x1, att, dout)),
                          w.parts(), attend_bwd)
    return dx.view(x_slab.shape), dw


def sequences_fwd_reference(x3d: torch.Tensor, w: SubBlockWeights):
    """Plain version of ``sequences_fwd``."""
    return temporal_block_reference(x3d, w, with_residuals=True)


def sequences_bwd_reference(x3d, x1, att, dout, w: SubBlockWeights):
    """Plain version of ``sequences_bwd``."""
    n, length, _ = x3d.shape

    def attend_bwd(qkv, datt):
        return attention_bwd(qkv.view(n, length, -1), datt.view(n, length, -1)).view(
            n * length, -1)

    dx, dw = subblock_bwd(*(t.reshape(-1, DIM) for t in (x3d, x1, att, dout)),
                          w.parts(), attend_bwd)
    return dx.view(x3d.shape), dw


# ------------------------------------------------------------------ wrappers

def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_residuals(x: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"residuals and gradients must be {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if x.device.type == "cuda" and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("operands must be contiguous and start on a 16-byte boundary")


def spatial_fwd(x: torch.Tensor, w: SubBlockWeights):
    """Spatial sub-block forward on flat (n_frames·17, 256) rows -> (out,
    x1, att), each like x. On a CUDA device this launches the serving
    kernels with the x1 store on (three in a row; the attention scratch is
    att; bf16 only) and counts the call in ``spatial_fwd.launches``; on the
    CPU it runs ``spatial_fwd_reference``."""
    return run_spatial(x, w, spatial_fwd, with_residuals=True)


def slab_fwd(x_slab: torch.Tensor, w: SubBlockWeights):
    """Temporal sub-block forward on the (C, T, 17·256) slab -> (out, x1,
    att), each like the slab. On a CUDA device this launches the serving
    kernels with the x1 store on (three in a row) and counts the call in
    ``slab_fwd.launches``; on the CPU it runs ``slab_fwd_reference``."""
    return run_slab(x_slab, w, slab_fwd, with_residuals=True)


def _bwd_launch(x, x1, att, dout, w, n_outer: int, length: int, layout: int):
    """The backward kernels on (rows, 256) operands in one of the
    ``LAYOUT_*`` row layouts: (dx, dw f32)."""
    if length > BWD_MAX_LEN:
        raise ValueError(f"sequences of {length}: the attention backward kernel takes "
                         f"at most {BWD_MAX_LEN}")
    dx = torch.empty_like(x)
    dw = torch.empty(BLOCK_ELEMS, dtype=torch.float32, device=x.device)
    lib = _build.library()
    rows = x.numel() // DIM
    work = torch.empty(lib.stblock_train_bwd_workspace(rows, length), dtype=torch.uint8,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.stblock_train_bwd_launch(
            x.data_ptr(), x1.data_ptr(), att.data_ptr(), dout.data_ptr(), w.flat.data_ptr(),
            work.data_ptr(), dx.data_ptr(), dw.data_ptr(), n_outer, length, layout,
            BLOCK_ELEMS, _stream())
    _build.check(err, "stblock_train_bwd_launch")
    return dx, dw


def spatial_bwd(x, x1, att, dout, w: SubBlockWeights):
    """Backward of ``spatial_fwd`` from its input, residuals and the output
    gradient (all like x) -> (dx like x, the 12 weight gradients f32 as one
    flat tensor in the weights' layout). On a CUDA device this launches the
    kernels (bf16 only; the weight gradients are reduced in a fixed order,
    with no atomics) and counts the call in ``spatial_bwd.launches``; on
    the CPU it runs ``spatial_bwd_reference``."""
    check_rows(x)
    _check_operands(x, w)
    _check_residuals(x, x1, att, dout)
    if x.device.type == "cpu":
        return spatial_bwd_reference(x, x1, att, dout, w)
    if not x.shape[0]:
        return torch.empty_like(x), torch.zeros(BLOCK_ELEMS, device=x.device)
    out = _bwd_launch(x, x1, att, dout, w, x.shape[0] // N_JOINTS, N_JOINTS, LAYOUT_SPATIAL)
    spatial_bwd.launches += 1
    return out


def slab_bwd(x_slab, x1, att, dout, w: SubBlockWeights):
    """Backward of ``slab_fwd``, as ``spatial_bwd`` on the slab; counts the
    call in ``slab_bwd.launches``."""
    check_slab(x_slab)
    _check_operands(x_slab, w)
    _check_residuals(x_slab, x1, att, dout)
    if x_slab.device.type == "cpu":
        return slab_bwd_reference(x_slab, x1, att, dout, w)
    c, t, _ = x_slab.shape
    if not c:
        return torch.empty_like(x_slab), torch.zeros(BLOCK_ELEMS, device=x_slab.device)
    out = _bwd_launch(x_slab, x1, att, dout, w, c, t, LAYOUT_SLAB)
    slab_bwd.launches += 1
    return out


def sequences_fwd(x3d: torch.Tensor, w: SubBlockWeights):
    """Temporal sub-block forward on (n, L, 256) joint-major sequences ->
    (out, x1, att), each like x3d. On a CUDA device this launches the
    serving kernels with the x1 store on (three in a row) and counts the
    call in ``sequences_fwd.launches``; on the CPU it runs
    ``sequences_fwd_reference``."""
    return run_sequences(x3d, w, sequences_fwd, with_residuals=True)


def sequences_bwd(x3d, x1, att, dout, w: SubBlockWeights):
    """Backward of ``sequences_fwd``, as ``spatial_bwd`` on joint-major
    sequences (on a CUDA device L is at most ``BWD_MAX_LEN``, else
    ValueError); counts the call in ``sequences_bwd.launches``."""
    check_sequences(x3d)
    _check_operands(x3d, w)
    _check_residuals(x3d, x1, att, dout)
    if x3d.device.type == "cpu":
        return sequences_bwd_reference(x3d, x1, att, dout, w)
    n, length, _ = x3d.shape
    if not n:
        return torch.empty_like(x3d), torch.zeros(BLOCK_ELEMS, device=x3d.device)
    out = _bwd_launch(x3d, x1, att, dout, w, n, length, LAYOUT_SEQUENCES)
    sequences_bwd.launches += 1
    return out


WRAPPERS = (spatial_fwd, spatial_bwd, slab_fwd, slab_bwd, sequences_fwd, sequences_bwd)
for _f in WRAPPERS:
    _f.launches = 0


# ------------------------------------------------------------------ autograd

class SpatialBlockTrain(torch.autograd.Function):
    """Differentiable spatial sub-block: (x rows, flat weights) -> out."""

    @staticmethod
    def forward(ctx, x, flat):
        out, x1, att = spatial_fwd(x, SubBlockWeights(flat))
        ctx.save_for_backward(x, x1, att, flat)
        return out

    @staticmethod
    def backward(ctx, g):
        x, x1, att, flat = ctx.saved_tensors
        dx, dw = spatial_bwd(x, x1, att, g.contiguous(), SubBlockWeights(flat))
        return dx, dw.to(flat.dtype)  # the weights' dtype, as JAX's _cast_dws


class TemporalSlabTrain(torch.autograd.Function):
    """Differentiable temporal sub-block: (slab, flat weights) -> out."""

    @staticmethod
    def forward(ctx, x_slab, flat):
        out, x1, att = slab_fwd(x_slab, SubBlockWeights(flat))
        ctx.save_for_backward(x_slab, x1, att, flat)
        return out

    @staticmethod
    def backward(ctx, g):
        x, x1, att, flat = ctx.saved_tensors
        dx, dw = slab_bwd(x, x1, att, g.contiguous(), SubBlockWeights(flat))
        return dx, dw.to(flat.dtype)


class TemporalBlockTrain(torch.autograd.Function):
    """Differentiable temporal sub-block on joint-major sequences: (x3d,
    flat weights) -> out."""

    @staticmethod
    def forward(ctx, x3d, flat):
        out, x1, att = sequences_fwd(x3d, SubBlockWeights(flat))
        ctx.save_for_backward(x3d, x1, att, flat)
        return out

    @staticmethod
    def backward(ctx, g):
        x, x1, att, flat = ctx.saved_tensors
        dx, dw = sequences_bwd(x, x1, att, g.contiguous(), SubBlockWeights(flat))
        return dx, dw.to(flat.dtype)


def temporal_block_train(x3d: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Differentiable temporal sub-block on (n, L, 256) joint-major
    sequences with the flat weights of ``pack_train(block, "temporal",
    dtype)`` (``pallas_stblock_train.temporal_block_train``): returns out;
    its backward gives dx like x3d and the flat weight gradient, summed in
    f32 and handed back in the weights' dtype, as JAX's ``_cast_dws``.
    Kernels on a CUDA device (bf16), plain versions on the CPU."""
    return TemporalBlockTrain.apply(x3d, flat)


def pack_train(block, half: str, dtype: torch.dtype) -> SubBlockWeights:
    """One half ("spatial" or "temporal") of a ``SpatioTemporalBlock`` ->
    the kernels' flat operand in ``dtype``, DIFFERENTIABLE (``stblock.
    pack_half``; the serving packs are the same under no_grad)."""
    return pack_half(block, half, dtype)


def temporal_train_forward_fused(module, clips: torch.Tensor) -> torch.Tensor:
    """Differentiable ``TemporalLifter`` forward for training on the fused
    sub-blocks: clips (B, clip_len, 17, 2) -> (B, clip_len, 17, 3) f32, the
    value contract of ``module(clips)`` (pallas_stblock_train.
    temporal_train_forward_fused), and the trainer's ``apply(module,
    clips)`` (JAX's ``make_fused_train_apply``). Computes in bf16 on a CUDA
    device (f32 master parameters, cast on the way in) and in f32 on the
    CPU, where the sub-blocks run their plain versions. The embed + PE and
    the head are the serving forward's (``stblock.embed_clips`` /
    ``temporal_head``) in that dtype."""
    if not supports(module):
        raise ValueError("temporal_train_forward_fused takes a TemporalLifter with 17 "
                         "joints, hidden 256 and 8 heads only")
    dt = torch.bfloat16 if module.embed.weight.device.type == "cuda" else torch.float32
    b, t = clips.shape[:2]
    tokens = embed_clips(module, clips, dt)
    for block in module.blocks:
        with span("pose3d.train.pack"):
            spatial = pack_train(block, "spatial", dt).flat
        tokens = SpatialBlockTrain.apply(tokens, spatial)
        with span("pose3d.train.pack"):
            temporal = pack_train(block, "temporal", dt).flat
        xt = TemporalSlabTrain.apply(tokens.view(b, t, N_JOINTS * DIM), temporal)
        tokens = xt.view(-1, DIM)
    return temporal_head(module, tokens, b)
