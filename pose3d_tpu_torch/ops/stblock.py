"""Fused sub-blocks of the temporal lifter, and the fused serving forward
built on them: the port of ``pose3d_tpu/ops/pallas_stblock.py``.

Each half of a ``SpatioTemporalBlock`` is one pre-LN transformer sub-block
on flat (rows, 256) bf16 token rows, frame-major (row (c·T + t)·17 + j is
joint j of frame t of clip c):

- ``spatial_block``: attention over the 17 joints of each frame;
- ``temporal_slab``: attention over the T frames of each joint, on the
  (C, T, 17·256) slab, which is the same bytes as the spatial rows;
- ``temporal_block_fused``: the same temporal sub-block on (n, L, 256)
  joint-major sequences, one sequence per row of the first axis (the JAX
  package's public entry for that layout).

Each runs its CUDA kernels (``csrc/stblock.cu``) when its operands lie on a
CUDA device and its plain version (``*_reference``) when they lie on the
CPU. ``temporal_forward_fused`` is the whole ``TemporalLifter`` inference
on them; the embed + PE and the LN -> 128 -> ReLU -> 3 head stay plain
tensor code, as the JAX package leaves them to XLA.

Numerical contract, the JAX kernels': products accumulate in f32,
LayerNorm statistics and softmax are f32, activations are rounded to the
working dtype at the same points (``_sub_block`` spells them out: qkv =
bf16(dot + b); x += bf16(dot + b) after the projection; the MLP
pre-activation is bf16(dot + b1), then GELU on the polynomial erf, then
x += bf16(dot + b2)), and softmax is the clamped one of ``ops/attention``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from pose3d_tpu_torch.models.temporal import TemporalLifter
from pose3d_tpu_torch.ops import _build, attention
from pose3d_tpu_torch.ops.numerics import dot, gelu, ln
from pose3d_tpu_torch.train.debug import span

N_JOINTS = 17
DIM = 256
HEADS = 8
DIM_HEAD = DIM // HEADS
MLP = 4 * DIM

# One sub-block's weights in the kernels' flat operand, in this order (the
# order of pallas_stblock.pack_spatial_weights / pack_temporal_weights);
# matrices are (in, out) row-major. csrc/stblock.cu has the same offsets.
# Each entry: name, shape, key in a SpatioTemporalBlock half, transposed.
_LAYOUT = (
    ("ln1_g", (DIM,), "norm1.weight", False),
    ("ln1_b", (DIM,), "norm1.bias", False),
    ("w_qkv", (DIM, 3 * DIM), "attn.qkv.weight", True),
    ("b_qkv", (3 * DIM,), "attn.qkv.bias", False),
    ("w_proj", (DIM, DIM), "attn.proj.weight", True),
    ("b_proj", (DIM,), "attn.proj.bias", False),
    ("ln2_g", (DIM,), "norm2.weight", False),
    ("ln2_b", (DIM,), "norm2.bias", False),
    ("w1", (DIM, MLP), "mlp.fc1.weight", True),
    ("b1", (MLP,), "mlp.fc1.bias", False),
    ("w2", (MLP, DIM), "mlp.fc2.weight", True),
    ("b2", (DIM,), "mlp.fc2.bias", False),
)
BLOCK_ELEMS = sum(math.prod(shape) for _, shape, _, _ in _LAYOUT)


@dataclass(frozen=True)
class SubBlockWeights:
    """One sub-block's weights as the kernels take them: one contiguous
    1-D tensor of ``BLOCK_ELEMS`` elements in ``_LAYOUT``."""

    flat: torch.Tensor

    def parts(self) -> dict[str, torch.Tensor]:
        """Views of the tensors, by layout name."""
        out, pos = {}, 0
        for name, shape, _, _ in _LAYOUT:
            n = math.prod(shape)
            out[name] = self.flat[pos:pos + n].view(shape)
            pos += n
        return out


def pack_half(block, half: str, dtype: torch.dtype | None = None) -> SubBlockWeights:
    """One half ("spatial" or "temporal") of a ``SpatioTemporalBlock`` ->
    the kernels' operand in ``dtype`` (default the block's). Differentiable:
    a ``torch.cat`` of the parameters' own transposed and cast views, so
    autograd splits the flat gradient back onto each parameter (a pack of
    the detached state dict would train nothing). Raises ValueError where
    the widths are not the kernel's (hidden 256, MLP 1024)."""
    params = dict(block.named_parameters())
    ref = params[f"{half}_attn.qkv.weight"]
    parts = []
    for name, shape, key, transposed in _LAYOUT:
        t = params[f"{half}_{key}"]
        t = t.t() if transposed else t
        if tuple(t.shape) != shape:
            raise ValueError(f"{half}_{key}: shape {tuple(t.shape)}, the kernel "
                             f"takes {shape} as {name}")
        parts.append(t.to(device=ref.device, dtype=dtype or ref.dtype).reshape(-1))
    return SubBlockWeights(torch.cat(parts))


def pack_spatial_weights(block) -> SubBlockWeights:
    """A ``SpatioTemporalBlock``'s spatial half -> the kernels' operand for
    serving (no grad), on its device and in its dtype."""
    with torch.no_grad():
        return pack_half(block, "spatial")


def pack_temporal_weights(block) -> SubBlockWeights:
    """The temporal half, as ``pack_spatial_weights``."""
    with torch.no_grad():
        return pack_half(block, "temporal")


def pack_temporal_lifter(module) -> list[tuple[SubBlockWeights, SubBlockWeights]]:
    """(spatial, temporal) operands of every block of a ``TemporalLifter``."""
    return [(pack_spatial_weights(b), pack_temporal_weights(b)) for b in module.blocks]


def _sub_block(x: torch.Tensor, w: dict, attend, with_residuals: bool = False):
    """One sub-block on flat rows x, ``attend`` mapping its qkv rows to
    attention rows, rounded to ``x.dtype`` where the JAX kernels round.
    With ``with_residuals`` returns (out, x1, att): the training forward's
    residual stream after the projection and attention output."""
    dt = x.dtype
    y = ln(x, w["ln1_g"], w["ln1_b"])
    qkv = (dot(y, w["w_qkv"]) + w["b_qkv"].float()).to(dt)
    att = attend(qkv)
    x1 = x + (dot(att, w["w_proj"]) + w["b_proj"].float()).to(dt)
    y = ln(x1, w["ln2_g"], w["ln2_b"])
    hg = gelu((dot(y, w["w1"]) + w["b1"].float()).to(dt))
    out = x1 + (dot(hg, w["w2"]) + w["b2"].float()).to(dt)
    return (out, x1, att) if with_residuals else out


def joint_major(rows: torch.Tensor, n_clips: int) -> torch.Tensor:
    """(C·T·17, w) frame-major rows -> (C·17, T, w) joint sequences, contiguous."""
    w = rows.shape[-1]
    return rows.view(n_clips, -1, N_JOINTS, w).transpose(1, 2).reshape(
        n_clips * N_JOINTS, -1, w).contiguous()


def frame_major(seqs: torch.Tensor, n_clips: int) -> torch.Tensor:
    """Inverse of ``joint_major``."""
    w = seqs.shape[-1]
    return seqs.view(n_clips, N_JOINTS, -1, w).transpose(1, 2).reshape(-1, w)


def spatial_block_reference(x: torch.Tensor, w: SubBlockWeights,
                            with_residuals: bool = False):
    """Plain version of ``spatial_block`` (and, ``with_residuals``, of the
    training forward), on any device and dtype."""
    return _sub_block(x, w.parts(), lambda qkv: attention.packed_flat_attention_reference(
        qkv, N_JOINTS, HEADS), with_residuals)


def temporal_slab_reference(x_slab: torch.Tensor, w: SubBlockWeights,
                            with_residuals: bool = False):
    """Plain version of ``temporal_slab`` (and, ``with_residuals``, of the
    training forward), on any device and dtype."""
    c = x_slab.shape[0]

    def attend(qkv):  # per (clip, joint): attention over its t frames
        return frame_major(attention.seq_attention_reference(joint_major(qkv, c), HEADS), c)

    outs = _sub_block(x_slab.reshape(-1, DIM), w.parts(), attend, with_residuals)
    if with_residuals:
        return tuple(o.view(x_slab.shape) for o in outs)
    return outs.view(x_slab.shape)


def temporal_block_reference(x3d: torch.Tensor, w: SubBlockWeights,
                             with_residuals: bool = False):
    """Plain version of ``temporal_block_fused`` (and, ``with_residuals``,
    of the training forward): full attention over each sequence's L rows,
    on any device and dtype."""
    n, length, _ = x3d.shape

    def attend(qkv):
        return attention.seq_attention_reference(qkv.view(n, length, -1), HEADS).view(-1, DIM)

    outs = _sub_block(x3d.reshape(-1, DIM), w.parts(), attend, with_residuals)
    if with_residuals:
        return tuple(o.view(x3d.shape) for o in outs)
    return outs.view(x3d.shape)


def _check_operands(x: torch.Tensor, w: SubBlockWeights) -> None:
    if w.flat.numel() != BLOCK_ELEMS:
        raise ValueError("weights do not follow the kernel's layout")
    if w.flat.device != x.device or w.flat.dtype != x.dtype:
        raise ValueError(f"weights are {w.flat.dtype} on {w.flat.device}, tokens "
                         f"{x.dtype} on {x.device}")
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError(f"no sub-block kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the sub-block kernels take bfloat16, got {x.dtype}")
    for name, t in (("tokens", x), ("weights", w.flat)):
        if not t.is_contiguous() or t.data_ptr() % 16:  # 16-byte vector loads
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")


def check_rows(x: torch.Tensor) -> None:
    """Raises unless x is (n_frames·17, 256) spatial rows."""
    if x.dim() != 2 or x.shape[1] != DIM or x.shape[0] % N_JOINTS:
        raise ValueError(f"tokens must be (n_frames*{N_JOINTS}, {DIM}), "
                         f"got {tuple(x.shape)}")


def check_slab(x_slab: torch.Tensor) -> None:
    """Raises unless x_slab is a (C, T, 17·256) slab whose T the CUDA
    attention can hold."""
    if x_slab.dim() != 3 or x_slab.shape[2] != N_JOINTS * DIM or x_slab.shape[1] < 1:
        raise ValueError(f"the slab must be (C, T, {N_JOINTS * DIM}), "
                         f"got {tuple(x_slab.shape)}")
    if x_slab.device.type == "cuda":
        attention.check_length(x_slab.shape[1], DIM_HEAD)


def check_sequences(x3d: torch.Tensor) -> None:
    """Raises unless x3d is (n, L, 256) joint-major sequences whose L the
    CUDA attention can hold."""
    if x3d.dim() != 3 or x3d.shape[2] != DIM or x3d.shape[1] < 1:
        raise ValueError(f"the sequences must be (n, L, {DIM}), got {tuple(x3d.shape)}")
    if x3d.device.type == "cuda":
        attention.check_length(x3d.shape[1], DIM_HEAD)


def _launch(launcher: str, x: torch.Tensor, w: SubBlockWeights, counter,
            with_residuals: bool, *shape) -> torch.Tensor | tuple:
    """The sub-block kernels' three launches (``csrc/stblock.cu``: LN_1 +
    qkv, the attention, projection + MLP) on x's rows through the C
    ``launcher``, with a qkv and an attention scratch allocated here;
    ``shape`` is the launcher's layout arguments. Counts the call in
    ``counter.launches``. Returns out, or (out, x1, att) for the training
    forward: the attention scratch is its att."""
    out, att = torch.empty_like(x), torch.empty_like(x)
    x1 = torch.empty_like(x) if with_residuals else None
    rows = x.numel() // DIM
    if rows:
        qkv = torch.empty(rows, 3 * DIM, dtype=x.dtype, device=x.device)
        with torch.cuda.device(x.device):  # the launch's current device
            err = getattr(_build.library(), launcher)(
                x.data_ptr(), w.flat.data_ptr(), qkv.data_ptr(), att.data_ptr(),
                x1.data_ptr() if with_residuals else None, out.data_ptr(), *shape,
                BLOCK_ELEMS, torch.cuda.current_stream().cuda_stream)
        _build.check(err, launcher)
        counter.launches += 1
    return (out, x1, att) if with_residuals else out


def run_spatial(x: torch.Tensor, w: SubBlockWeights, counter, with_residuals: bool):
    """``spatial_block`` and, ``with_residuals``, the training forward
    (out, x1, att): the kernels on a CUDA device (each frame one sequence
    of 17 rows of the sequences launcher), counted in
    ``counter.launches``, the plain version on the CPU."""
    check_rows(x)
    _check_operands(x, w)
    if x.device.type == "cpu":
        return spatial_block_reference(x, w, with_residuals)
    return _launch("stblock_sequences_launch", x, w, counter, with_residuals,
                   x.shape[0] // N_JOINTS, N_JOINTS)


def run_slab(x_slab: torch.Tensor, w: SubBlockWeights, counter, with_residuals: bool):
    """``temporal_slab`` and, ``with_residuals``, the training forward
    (out, x1, att), as ``run_spatial``, the attention over each joint's T
    frames of the slab."""
    check_slab(x_slab)
    _check_operands(x_slab, w)
    if x_slab.device.type == "cpu":
        return temporal_slab_reference(x_slab, w, with_residuals)
    c, t, _ = x_slab.shape
    return _launch("stblock_temporal_launch", x_slab, w, counter, with_residuals, c, t)


def run_sequences(x3d: torch.Tensor, w: SubBlockWeights, counter, with_residuals: bool):
    """``temporal_block_fused`` and, ``with_residuals``, the training forward
    (out, x1, att), as ``run_spatial`` on (n, L, 256) joint-major sequences."""
    check_sequences(x3d)
    _check_operands(x3d, w)
    if x3d.device.type == "cpu":
        return temporal_block_reference(x3d, w, with_residuals)
    n, length, _ = x3d.shape
    return _launch("stblock_sequences_launch", x3d, w, counter, with_residuals, n, length)


def spatial_block(x: torch.Tensor, w: SubBlockWeights) -> torch.Tensor:
    """The spatial sub-block on flat (n_frames·17, 256) rows.

    On a CUDA device this launches the kernels on the current stream (bf16
    only; anything else raises: three kernels in a row, each frame a
    sequence of 17 rows, with a qkv and an attention scratch allocated
    here) and counts the call in ``spatial_block.launches``; on the CPU it
    runs ``spatial_block_reference``.
    """
    return run_spatial(x, w, spatial_block, with_residuals=False)


spatial_block.launches = 0


def temporal_slab(x_slab: torch.Tensor, w: SubBlockWeights) -> torch.Tensor:
    """The temporal sub-block on the (C, T, 17·256) frame-major slab.

    On a CUDA device this launches the kernels on the current stream (bf16
    only; anything else raises: three kernels in a row, with a qkv and an
    attention scratch allocated here) and counts the call in
    ``temporal_slab.launches``; on the CPU it runs
    ``temporal_slab_reference``.
    """
    return run_slab(x_slab, w, temporal_slab, with_residuals=False)


temporal_slab.launches = 0


def temporal_block_fused(x3d: torch.Tensor, w: SubBlockWeights) -> torch.Tensor:
    """The temporal sub-block on (n, L, 256) joint-major sequences, full
    attention over each sequence's L rows (``pallas_stblock.
    temporal_block_fused``).

    On a CUDA device this launches the kernels on the current stream (bf16
    only; anything else raises; an L whose K and V do not fit in shared
    memory raises ValueError: three kernels in a row, with a qkv and an
    attention scratch allocated here) and counts the call in
    ``temporal_block_fused.launches``; on the CPU it runs
    ``temporal_block_reference``. Each sequence gives the bits that
    ``temporal_slab`` gives the same tokens in the frame-major layout.
    """
    return run_sequences(x3d, w, temporal_block_fused, with_residuals=False)


temporal_block_fused.launches = 0


def supports(model) -> bool:
    """True iff ``model`` has the widths the kernels bake in (17 joints,
    hidden 256, 8 heads): the fused route's condition in the JAX
    package's ``lift_sequence``."""
    return (isinstance(model, TemporalLifter) and model.n_joints == N_JOINTS
            and model.hidden == DIM and model.heads == HEADS)


def embed_clips(module, clips: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """(C, clip_len, 17, in_dim) clips -> the trunk's (C·clip_len·17, 256)
    input rows in ``dtype`` (default the module's): ``x @ W + b``, plus the
    PE table dtype(spatial_pe) + dtype(temporal_pe), rounded before it
    meets the tokens, as in the JAX fused forward (the module adds the two
    in turn). Differentiable in the module's parameters."""
    c, t, j, d = clips.shape
    if j != N_JOINTS or t != module.clip_len or d != module.in_dim:
        raise ValueError(f"expected (C, {module.clip_len}, {N_JOINTS}, "
                         f"{module.in_dim}), got {tuple(clips.shape)}")
    dt = dtype or module.dtype
    emb = module.embed
    tokens = clips.reshape(c * t * j, d).to(dt) @ emb.weight.t().to(dt) + emb.bias.to(dt)
    pe = module.spatial_pe.to(dt)[0, 0][None] + module.temporal_pe.to(dt)[0, :t][:, None]
    return tokens + pe.reshape(t * j, DIM).repeat(c, 1)


def temporal_trunk(tokens: torch.Tensor, n_clips: int, weights) -> torch.Tensor:
    """Every block's spatial then temporal sub-block on the (C·T·17, 256)
    rows of ``n_clips`` clips; ``weights`` as ``pack_temporal_lifter``."""
    for w_spatial, w_temporal in weights:
        tokens = spatial_block(tokens, w_spatial)
        tokens = temporal_slab(tokens.view(n_clips, -1, N_JOINTS * DIM),
                               w_temporal).view(-1, DIM)
    return tokens


def temporal_trunk_reference(tokens: torch.Tensor, n_clips: int,
                             weights) -> torch.Tensor:
    """Plain version of ``temporal_trunk``, on any device and dtype."""
    for w_spatial, w_temporal in weights:
        tokens = spatial_block_reference(tokens, w_spatial)
        tokens = temporal_slab_reference(tokens.view(n_clips, -1, N_JOINTS * DIM),
                                         w_temporal).view(-1, DIM)
    return tokens


def temporal_head(module, tokens: torch.Tensor, n_clips: int) -> torch.Tensor:
    """The trunk's rows -> (C, T, 17, out_dim) f32 through the module's
    LN (f32 statistics) -> Linear -> ReLU -> Linear head, in the rows'
    dtype."""
    y = ln(tokens, module.norm.weight, module.norm.bias)
    dt = y.dtype
    l1, l2 = module.head[0], module.head[2]
    y = torch.relu(y @ l1.weight.t().to(dt) + l1.bias.to(dt))
    y = (y @ l2.weight.t().to(dt) + l2.bias.to(dt)).float()
    return y.view(n_clips, -1, N_JOINTS, module.out_dim)


def temporal_forward_fused(module, clips: torch.Tensor, *,
                           weights=None) -> torch.Tensor:
    """Fused inference forward of a ``TemporalLifter`` of the kernels'
    widths: clips (C, clip_len, 17, in_dim) on the module's device ->
    (C, clip_len, 17, out_dim) f32, the contract of ``module(clips)``.

    Computes in the module's dtype (bf16 is the served configuration and
    the only one the kernels take): ``temporal_head(temporal_trunk(
    embed_clips(...)))``, whose plain version, the yardstick on the card,
    puts ``temporal_trunk_reference`` in the middle. ``weights`` defaults
    to ``pack_temporal_lifter(module)``; pass them packed once to skip the
    repacking. The trunk's launches lie in the span ``pose3d.temporal.trunk``.
    """
    if not supports(module):
        raise ValueError("temporal_forward_fused takes a TemporalLifter with 17 "
                         "joints, hidden 256 and 8 heads only")
    if weights is None:
        weights = pack_temporal_lifter(module)
    tokens = embed_clips(module, clips)
    with span("pose3d.temporal.trunk"):
        tokens = temporal_trunk(tokens, len(clips), weights)
    return temporal_head(module, tokens, len(clips))
