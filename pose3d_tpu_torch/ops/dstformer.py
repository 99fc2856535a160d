"""DSTformer's sub-blocks on the fused launches of ``csrc/dstformer.cu``.

One pre-LN sub-block of ``models/dstformer.DSTBlock`` (spatial ``"s"`` or
temporal ``"t"``), on flat (rows, 512) bf16 token rows, frame-major (row
(c·T + t)·17 + j is joint j of frame t of clip c), as five launches:

- ``ln_qkv``: ``qkv = bf16(bf16(LN_1(x)) Wqkv^T + bqkv)``;
- ``attend``: multi-head attention over the 17 joints of each frame
  (``"s"``) or over the T frames of each joint (``"t"``), each read and
  written in place in the frame-major rows;
- ``proj_residual``: ``x1 = bf16(x + (o Wproj^T + bproj))``;
- ``ln_fc1_gelu``: ``h = bf16(gelu(bf16(LN_2(x1)) W1^T + b1))``;
- ``fc2_residual``: ``out = bf16(x1 + (h W2^T + b2))``.

``sub_block`` runs all five. Each launches its kernel when its operands
lie on a CUDA device (bf16, the widths the kernels bake in: hidden 512, 8
heads x 64, MLP ratio 2, LayerNorm eps 1e-6, 17 joints; anything else
raises) and runs its plain version when they lie on the CPU. Each
LayerNorm and each launch rounds its output to the working dtype; the sums
between, product, bias and the GELU or residual add, stay in f32. That is
the module route's rounding less three roundings of a product, so the
answer lies nearer the f32 model's (``csrc/dstformer.cu`` gives the
readings); in f32 the two routes agree. The attention is
``ops/attention``'s, with its clamped softmax. The weights are the
modules' parameters as they lie: nothing is packed or transposed.
Inference only: there is no backward.

Counts, process-wide: every kernel launch in ``sub_block.launches``, and
every sub-block that ``sub_block`` runs (on either device) in
``sub_block.fused``: 20 a forward of the published DSTformer on the fused
route.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from pose3d_tpu_torch.ops import _build, attention

WIDTH = 512       # hidden
HEADS = 8
MLP_RATIO = 2
N_JOINTS = 17
LN_EPS = 1e-6     # MotionBERT's load_backbone LayerNorm eps
AXES = {"s": 0, "t": 1}  # the kernel's axis code: spatial, temporal


class SubBlockWeights(NamedTuple):
    """One sub-block's parameters, as the modules hold them: LayerNorm
    scales and biases (C,), Linear weights (out, in) with biases (out,)."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor


def weights(block: nn.Module, axis: str) -> SubBlockWeights:
    """The ``axis`` sub-block's parameters of a ``DSTBlock`` (no copies)."""
    n1, attn = getattr(block, f"norm1_{axis}"), getattr(block, f"attn_{axis}")
    n2, mlp = getattr(block, f"norm2_{axis}"), getattr(block, f"mlp_{axis}")
    return SubBlockWeights(*(t.detach() for t in (
        n1.weight, n1.bias, attn.qkv.weight, attn.qkv.bias, attn.proj.weight, attn.proj.bias,
        n2.weight, n2.bias, mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias)))


def supports(model) -> bool:
    """True iff a DSTformer has the widths the kernels bake in (17 joints,
    hidden 512, 8 heads, MLP ratio 2, LayerNorm eps 1e-6)."""
    block = model.blocks_st[0] if len(model.blocks_st) else None
    return (block is not None and model.n_joints == N_JOINTS and model.hidden == WIDTH
            and model.heads == HEADS
            and block.mlp_s.fc1.out_features == MLP_RATIO * WIDTH
            and block.norm1_s.eps == LN_EPS)


def takes_fused(model, x: torch.Tensor, use_kernels: bool) -> bool:
    """The DSTformer forward's route: the fused sub-blocks where the
    kernels are asked for, the tokens lie on a CUDA device in bf16, no
    gradient is recorded (the launches have no backward) and the model has
    the kernels' widths; the module route otherwise."""
    return (use_kernels and x.device.type == "cuda" and x.dtype == torch.bfloat16
            and not torch.is_grad_enabled() and supports(model))


# ------------------------------------------------------------ plain versions


def ln_qkv_reference(x, w: SubBlockWeights) -> torch.Tensor:
    y = nn.functional.layer_norm(x, (x.shape[-1],), w.ln1_w, w.ln1_b, LN_EPS)
    return nn.functional.linear(y, w.qkv_w, w.qkv_b)


def attend_reference(qkv, axis: str, frames: int, heads: int = HEADS,
                     joints: int = N_JOINTS) -> torch.Tensor:
    """``attend``'s plain version: ``ops.attention.heads_attention`` on a
    (clips, frames, joints, 3C) view of the rows, the temporal axis on its
    (clips, joints, frames, 3C) transpose, answered in frame-major rows."""
    rows, three_c = qkv.shape
    c = three_c // 3
    seqs = qkv.view(-1, frames, joints, three_c)
    if axis == "t":
        seqs = seqs.transpose(1, 2)
    out = attention.heads_attention(seqs, heads, c // heads)
    if axis == "t":
        out = out.transpose(1, 2)
    return out.reshape(rows, c)


def _linear_f32(x, weight, bias) -> torch.Tensor:
    """x weight^T + bias summed in f32 and left unrounded, as the kernels'
    epilogues take it (the operands are exact in f32)."""
    return nn.functional.linear(x.float(), weight.float(), bias.float())


def proj_residual_reference(o, w: SubBlockWeights, x) -> torch.Tensor:
    return (x.float() + _linear_f32(o, w.proj_w, w.proj_b)).to(x.dtype)


def ln_fc1_gelu_reference(x1, w: SubBlockWeights) -> torch.Tensor:
    y = nn.functional.layer_norm(x1, (x1.shape[-1],), w.ln2_w, w.ln2_b, LN_EPS)
    return nn.functional.gelu(_linear_f32(y, w.fc1_w, w.fc1_b), approximate="none").to(x1.dtype)


def fc2_residual_reference(h, w: SubBlockWeights, x1) -> torch.Tensor:
    return (x1.float() + _linear_f32(h, w.fc2_w, w.fc2_b)).to(x1.dtype)


def sub_block_reference(x, w: SubBlockWeights, axis: str, frames: int, heads: int = HEADS,
                        joints: int = N_JOINTS) -> torch.Tensor:
    """Plain version of ``sub_block``, on any device, dtype and width."""
    o = attend_reference(ln_qkv_reference(x, w), axis, frames, heads, joints)
    x1 = proj_residual_reference(o, w, x)
    return fc2_residual_reference(ln_fc1_gelu_reference(x1, w), w, x1)


# ------------------------------------------------------------ the launches

# each weight's shape in the kernels
KERNEL_SHAPES = {"ln1_w": (WIDTH,), "ln1_b": (WIDTH,), "qkv_w": (3 * WIDTH, WIDTH),
                 "qkv_b": (3 * WIDTH,), "proj_w": (WIDTH, WIDTH), "proj_b": (WIDTH,),
                 "ln2_w": (WIDTH,), "ln2_b": (WIDTH,), "fc1_w": (MLP_RATIO * WIDTH, WIDTH),
                 "fc1_b": (MLP_RATIO * WIDTH,), "fc2_w": (WIDTH, MLP_RATIO * WIDTH),
                 "fc2_b": (WIDTH,)}


def check_operands(x: torch.Tensor, w: SubBlockWeights, frames: int,
                   joints: int = N_JOINTS) -> None:
    """Raises unless x and w are what the kernels take: (rows, 512) bf16
    rows, whole clips of ``frames`` x ``joints``, contiguous and on
    16-byte boundaries, the weights of those widths beside them."""
    if x.dim() != 2 or x.shape[1] != WIDTH:
        raise ValueError(f"x must be (rows, {WIDTH}), got {tuple(x.shape)}")
    if frames < 1 or x.shape[0] % (frames * joints):
        raise ValueError(f"{x.shape[0]} rows are not whole clips of {frames} x {joints}")
    for name, t in (("x", x), *w._asdict().items()):
        if name != "x":
            _shape(name, t, KERNEL_SHAPES[name])
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the DSTformer kernels take bfloat16, {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")


def _shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _shapes(w: SubBlockWeights, *names: str) -> None:
    """The named weights against the kernels' widths (``check_operands``'s)."""
    for name in names:
        _shape(name, getattr(w, name), KERNEL_SHAPES[name])


def _launch(name: str, *args) -> None:
    """One launcher of csrc/dstformer.cu on the current stream of the
    first tensor's device; tensors pass as their pointers, each checked to
    be what the kernels read (bf16, contiguous, 16-byte aligned, on that
    device)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.bfloat16 or t.device != dev or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: every operand must be contiguous bfloat16 on {dev}, "
                             f"16-byte aligned")
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                   for a in args), stream)
    _build.check(err, name)
    sub_block.launches += 1


def _empty(x: torch.Tensor, width: int) -> torch.Tensor:
    return torch.empty(x.shape[0], width, dtype=x.dtype, device=x.device)


def ln_qkv(x, w: SubBlockWeights) -> torch.Tensor:
    """(rows, 512) -> (rows, 1536) ``[q|k|v]`` rows."""
    if x.device.type == "cpu":
        return ln_qkv_reference(x, w)
    _shape("x", x, (x.shape[0], WIDTH))
    _shapes(w, "ln1_w", "ln1_b", "qkv_w", "qkv_b")
    qkv = _empty(x, 3 * WIDTH)
    _launch("dstformer_ln_qkv_launch", x, w.ln1_w, w.ln1_b, w.qkv_w, w.qkv_b, qkv, x.shape[0],
            WIDTH)
    return qkv


def attend(qkv, axis: str, frames: int) -> torch.Tensor:
    """(rows, 1536) -> (rows, 512): attention of ``HEADS`` heads along
    ``axis`` of the frame-major rows of clips of ``frames`` frames."""
    if axis not in AXES:
        raise ValueError(f"axis must be one of {tuple(AXES)}, got {axis!r}")
    if qkv.device.type == "cpu":
        return attend_reference(qkv, axis, frames)
    rows = qkv.shape[0]
    if qkv.shape != (rows, 3 * WIDTH) or qkv.dtype != torch.bfloat16 or frames < 1 \
            or rows % (frames * N_JOINTS) or not qkv.is_contiguous():
        raise ValueError(f"qkv must be contiguous bf16 (rows, {3 * WIDTH}) of whole clips")
    if axis == "t":
        attention.check_length(frames, WIDTH // HEADS)
    o = _empty(qkv, WIDTH)
    _launch("dstformer_attention_launch", qkv, o, rows // (frames * N_JOINTS), frames, N_JOINTS,
            AXES[axis], WIDTH)
    return o


def proj_residual(o, w: SubBlockWeights, x) -> torch.Tensor:
    if o.device.type == "cpu":
        return proj_residual_reference(o, w, x)
    _shape("o", o, (x.shape[0], WIDTH))
    _shape("x", x, (x.shape[0], WIDTH))
    _shapes(w, "proj_w", "proj_b")
    x1 = _empty(x, WIDTH)
    _launch("dstformer_proj_residual_launch", o, w.proj_w, w.proj_b, x, x1, x.shape[0], WIDTH)
    return x1


def ln_fc1_gelu(x1, w: SubBlockWeights) -> torch.Tensor:
    """(rows, 512) -> (rows, 1024)."""
    if x1.device.type == "cpu":
        return ln_fc1_gelu_reference(x1, w)
    _shape("x1", x1, (x1.shape[0], WIDTH))
    _shapes(w, "ln2_w", "ln2_b", "fc1_w", "fc1_b")
    h = _empty(x1, MLP_RATIO * WIDTH)
    _launch("dstformer_ln_fc1_gelu_launch", x1, w.ln2_w, w.ln2_b, w.fc1_w, w.fc1_b, h,
            x1.shape[0], WIDTH)
    return h


def fc2_residual(h, w: SubBlockWeights, x1) -> torch.Tensor:
    if h.device.type == "cpu":
        return fc2_residual_reference(h, w, x1)
    _shape("h", h, (x1.shape[0], MLP_RATIO * WIDTH))
    _shape("x1", x1, (x1.shape[0], WIDTH))
    _shapes(w, "fc2_w", "fc2_b")
    out = _empty(x1, WIDTH)
    _launch("dstformer_fc2_residual_launch", h, w.fc2_w, w.fc2_b, x1, out, x1.shape[0], WIDTH)
    return out


def sub_block(x, w: SubBlockWeights, axis: str, frames: int) -> torch.Tensor:
    """One sub-block of ``HEADS`` heads on (rows, C) frame-major rows of
    clips of ``frames`` frames -> new (rows, C) rows; x is left as it is.
    On a CUDA device the five launches (the operands as
    ``check_operands`` requires); on the CPU their plain versions, at any
    width."""
    if axis not in AXES:
        raise ValueError(f"axis must be one of {tuple(AXES)}, got {axis!r}")
    sub_block.fused += 1
    if x.device.type == "cpu":
        return sub_block_reference(x, w, axis, frames)
    check_operands(x, w, frames)
    x1 = proj_residual(attend(ln_qkv(x, w), axis, frames), w, x)
    return fc2_residual(ln_fc1_gelu(x1, w), w, x1)


sub_block.launches = 0
sub_block.fused = 0

