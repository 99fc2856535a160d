"""The fused lifter trunk: the port of ``pose3d_tpu/ops/pallas_lifter.py``.

``trunk`` runs both transformer blocks of the default
``JointTransformerLifter`` (17 tokens, dim 256, 4 heads x 64, MLP 1024)
on flat (B*17, 256) bf16 rows in CUDA kernels written for Hopper
(``csrc/lifter_trunk.cu``: per block the ``qkv_kernel``, the attention and
the ``rest_kernel`` of ``csrc/subblock_sm90.cuh`` and ``csrc/attention.cu``,
six launches from one C call) when its operands lie on a CUDA device, and
in its plain PyTorch version ``trunk_reference`` (composed of the three
launches' plain versions, ``trunk_qkv_reference``,
``trunk_attention_reference`` and ``trunk_rest_reference``) when they lie
on the CPU.
``lifter_forward_fused`` wraps it with the embed and the 256 -> 128 -> 3
head, which stay plain tensor code, as the JAX package leaves them to XLA.

Numerical contract, the JAX kernel's: products accumulate in f32,
LayerNorm statistics and softmax are f32, activations are rounded to the
working dtype at the same points (``trunk_reference`` spells them out),
and GELU uses the clamped polynomial erf of ``ops/numerics.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.ops import _build
from pose3d_tpu_torch.ops.attention import packed_flat_attention_reference
from pose3d_tpu_torch.ops.numerics import dot, gelu, ln
from pose3d_tpu_torch.train.debug import span

N_JOINTS = 17
DIM = 256
HEADS = 4
MLP = 4 * DIM
# the batch granularity: a batch must be a multiple of this many frames
# (the first kernel's frame tile; LifterService's buckets keep to it, and
# the launcher checks it)
FRAMES_PER_CTA = 4

# One block's weights in the kernel's flat operand, in this order;
# matrices are (in, out) row-major. csrc/lifter_trunk.cu has the same
# offsets. Each entry: name, shape, state-dict key, transposed.
_BLOCK_LAYOUT = (
    ("lna_g", (DIM,), "norm1.weight", False),
    ("lna_b", (DIM,), "norm1.bias", False),
    ("lnb_g", (DIM,), "mhsa.norm.weight", False),
    ("lnb_b", (DIM,), "mhsa.norm.bias", False),
    ("w_qkv", (DIM, 3 * DIM), "mhsa.to_qkv.weight", True),
    ("w_proj", (DIM, DIM), "mhsa.to_out.weight", True),
    ("ln2_g", (DIM,), "norm2.weight", False),
    ("ln2_b", (DIM,), "norm2.bias", False),
    ("w1", (DIM, MLP), "mlp.0.weight", True),
    ("b1", (MLP,), "mlp.0.bias", False),
    ("w2", (MLP, DIM), "mlp.2.weight", True),
    ("b2", (DIM,), "mlp.2.bias", False),
)
BLOCK_ELEMS = sum(math.prod(shape) for _, shape, _, _ in _BLOCK_LAYOUT)


@dataclass(frozen=True)
class TrunkWeights:
    """The trunk's weights as the kernel takes them: one contiguous 1-D
    tensor of ``n_blocks * BLOCK_ELEMS`` elements in ``_BLOCK_LAYOUT``."""

    flat: torch.Tensor
    n_blocks: int

    def block(self, i: int) -> dict[str, torch.Tensor]:
        """Views of block ``i``'s tensors, by layout name."""
        out, pos = {}, i * BLOCK_ELEMS
        for name, shape, _, _ in _BLOCK_LAYOUT:
            n = math.prod(shape)
            out[name] = self.flat[pos:pos + n].view(shape)
            pos += n
        return out


def pack_weights(src) -> TrunkWeights:
    """A ``JointTransformerLifter`` (or its state dict) -> ``TrunkWeights``
    on the same device and in the same dtype as its qkv weight.

    Raises ValueError where the widths are not the kernel's
    (hidden 256, MLP 1024).
    """
    sd = src.state_dict() if isinstance(src, nn.Module) else src
    n_blocks = sum(1 for k in sd if k.startswith("blocks.")
                   and k.endswith(".norm1.weight"))
    if n_blocks == 0:
        raise ValueError("no transformer blocks in the weights")
    ref = sd["blocks.0.mhsa.to_qkv.weight"]
    parts = []
    for i in range(n_blocks):
        for name, shape, key, transposed in _BLOCK_LAYOUT:
            t = sd[f"blocks.{i}.{key}"]
            t = t.t() if transposed else t
            if tuple(t.shape) != shape:
                raise ValueError(f"blocks.{i}.{key}: shape {tuple(t.shape)}, "
                                 f"the kernel takes {shape} as {name}")
            parts.append(t.to(device=ref.device, dtype=ref.dtype).reshape(-1))
    return TrunkWeights(torch.cat(parts).contiguous(), n_blocks)


def trunk_qkv_reference(x: torch.Tensor, w: dict[str, torch.Tensor],
                        pe: torch.Tensor | None = None):
    """Plain version of one block's first launch (``qkv_kernel``), on any
    device and dtype: with ``pe`` (the first block) the rows become
    ``x + pe[row % 17]``, rounded to ``x.dtype``; then ``qkv =
    dtype(LN_b(LN_a(x)) @ W_qkv)``, each LN rounded to ``x.dtype``.
    ``w`` is one block of ``TrunkWeights``. Returns (qkv, the residual
    stream x)."""
    if pe is not None:
        x = (x.view(-1, N_JOINTS, DIM) + pe).view(x.shape)
    y = ln(ln(x, w["lna_g"], w["lna_b"]), w["lnb_g"], w["lnb_b"])
    return dot(y, w["w_qkv"]).to(x.dtype), x


def trunk_attention_reference(qkv: torch.Tensor) -> torch.Tensor:
    """Plain version of one block's second launch: 4-head x 64 attention
    within each frame of 17 rows (the clamped softmax of ``ops/attention``)."""
    return packed_flat_attention_reference(qkv, N_JOINTS, HEADS)


def trunk_rest_reference(x: torch.Tensor, att: torch.Tensor,
                         w: dict[str, torch.Tensor]) -> torch.Tensor:
    """Plain version of one block's third launch (``rest_kernel``), on any
    device and dtype: ``x1 = x + dtype(att @ W_proj)``, then ``x1 +
    dtype(gelu(dtype(LN_2(x1) @ W1 + b1)) @ W2 + b2)``."""
    dt = x.dtype
    x = x + dot(att, w["w_proj"]).to(dt)
    y = ln(x, w["ln2_g"], w["ln2_b"])
    y = gelu((dot(y, w["w1"]) + w["b1"].float()).to(dt))
    return x + (dot(y, w["w2"]) + w["b2"].float()).to(dt)


def trunk_reference(tokens: torch.Tensor, pe: torch.Tensor,
                    weights: TrunkWeights) -> torch.Tensor:
    """Plain version of the trunk kernels, on any device and dtype: each
    block's three launches' plain versions in turn, the PE added by the
    first block's.

    tokens (B*17, 256), pe (17, 256). Rounds to ``tokens.dtype`` where
    the JAX kernel rounds to bf16: the PE add, each LN, qkv, the
    attention output, each residual add, the MLP pre-activation and its
    GELU.
    """
    x = tokens
    for i in range(weights.n_blocks):
        w = weights.block(i)
        qkv, x = trunk_qkv_reference(x, w, pe if i == 0 else None)
        x = trunk_rest_reference(x, trunk_attention_reference(qkv), w)
    return x


def _check_operands(tokens, pe, weights: TrunkWeights) -> None:
    if tokens.dim() != 2 or tokens.shape[1] != DIM:
        raise ValueError(f"tokens must be (B*{N_JOINTS}, {DIM}), "
                         f"got {tuple(tokens.shape)}")
    if tokens.shape[0] % (N_JOINTS * FRAMES_PER_CTA):
        raise ValueError(f"{tokens.shape[0]} rows: the batch must be a "
                         f"multiple of {FRAMES_PER_CTA} frames")
    if tuple(pe.shape) != (N_JOINTS, DIM):
        raise ValueError(f"pe must be ({N_JOINTS}, {DIM}), got {tuple(pe.shape)}")
    if weights.flat.numel() != weights.n_blocks * BLOCK_ELEMS:
        raise ValueError("weights do not follow the kernel's layout")
    for name, t in (("pe", pe), ("weights", weights.flat)):
        if t.device != tokens.device or t.dtype != tokens.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, tokens "
                             f"{tokens.dtype} on {tokens.device}")
    for name, t in (("tokens", tokens), ("pe", pe), ("weights", weights.flat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kernel_operands(tokens, pe, weights: TrunkWeights) -> None:
    if tokens.device.type != "cuda":
        raise ValueError(f"no trunk kernel for device {tokens.device}")
    if tokens.dtype != torch.bfloat16:
        raise TypeError(f"the trunk kernel takes bfloat16, got {tokens.dtype}")
    for name, t in (("tokens", tokens), ("pe", pe), ("weights", weights.flat)):
        if t.data_ptr() % 32:  # 16-byte vector loads and TMA boxes (kept at 32)
            raise ValueError(f"{name} must start on a 32-byte boundary")


def trunk_scratch(tokens: torch.Tensor, pe: torch.Tensor, weights: TrunkWeights):
    """``trunk`` on a CUDA device, returning (out, resid, qkv, attn): the
    output and the kernels' scratch as the call leaves it. qkv and attn hold
    the last block's q|k|v and attention output, resid that block's input
    rows (with one block, bf16(tokens + pe)), so that each launch can be
    held to its plain version on the inputs it was given. Counts the call in
    ``trunk.launches``."""
    _check_operands(tokens, pe, weights)
    _check_kernel_operands(tokens, pe, weights)
    out = torch.empty_like(tokens)
    # the kernels' scratch: the residual stream between blocks, q|k|v and
    # the attention output (71, 214 and 71 MB at B = 8192)
    resid, attn = torch.empty_like(tokens), torch.empty_like(tokens)
    qkv = torch.empty(tokens.shape[0], 3 * DIM, dtype=tokens.dtype, device=tokens.device)
    n_frames = tokens.shape[0] // N_JOINTS
    if n_frames == 0:
        return out, resid, qkv, attn
    lib = _build.library()
    with span("pose3d.trunk"), torch.cuda.device(tokens.device):  # the launch's current device
        err = lib.lifter_trunk_launch(
            tokens.data_ptr(), pe.data_ptr(), weights.flat.data_ptr(),
            resid.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
            n_frames, weights.n_blocks, FRAMES_PER_CTA, BLOCK_ELEMS,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "lifter_trunk_launch")
    trunk.launches += 1
    return out, resid, qkv, attn


def trunk(tokens: torch.Tensor, pe: torch.Tensor,
          weights: TrunkWeights) -> torch.Tensor:
    """Both transformer blocks on flat (B*17, 256) token rows.

    On a CUDA device this launches the Hopper kernels on the current stream
    (bf16 only; anything else raises), with their scratch allocated here,
    and counts the call in ``trunk.launches``; on the CPU it runs
    ``trunk_reference``.
    """
    _check_operands(tokens, pe, weights)
    if tokens.device.type == "cpu":
        return trunk_reference(tokens, pe, weights)
    return trunk_scratch(tokens, pe, weights)[0]


trunk.launches = 0


def supports(model) -> bool:
    """True iff ``model`` is the default architecture, the one the kernel
    bakes in and is tested at. The qkv and projection shapes do not
    depend on the head count, so a mismatch there would be silently
    wrong, not a shape error."""
    return (isinstance(model, JointTransformerLifter)
            and model.n_joints == N_JOINTS and model.in_dim == 2
            and model.out_dim == 3 and model.hidden == DIM
            and model.n_blocks == 2 and model.heads == HEADS
            and not model.class_token)


def embed_tokens(module, kp2d: torch.Tensor) -> torch.Tensor:
    """(B, 17, 2) keypoints -> the trunk's (B*17, 256) input rows,
    ``bf16(kp2d) @ W + b`` in the module's dtype (the PE is added in the
    trunk)."""
    x = kp2d.reshape(-1, 2).to(module.dtype)
    emb = module.linear_mapper
    return x @ emb.weight.t() + emb.bias


def lifter_head(module, tokens: torch.Tensor) -> torch.Tensor:
    """The trunk's (B*17, 256) output rows -> (B, 17, 3) f32 through the
    module's ``relu(@W3 + b3) @ W4 + b4`` head, in the module's dtype."""
    l3, l4 = module.mlp[0], module.mlp[2]
    y = torch.relu(tokens @ l3.weight.t() + l3.bias)
    y = (y @ l4.weight.t() + l4.bias).float()
    return y.view(tokens.shape[0] // N_JOINTS, N_JOINTS, 3)


def lifter_forward_fused(module, kp2d: torch.Tensor, *,
                         weights: TrunkWeights | None = None) -> torch.Tensor:
    """Fused inference forward of the default ``JointTransformerLifter``.

    kp2d (B, 17, 2), B a multiple of ``FRAMES_PER_CTA``, on the module's
    device. Computes in the module's dtype (bf16 is the served
    configuration and the only one the kernel takes). ``weights``
    defaults to ``pack_weights(module)``; pass them packed once to skip
    the repacking. Returns (B, 17, 3) f32, the contract of
    ``module(kp2d)``. Its plain version, the yardstick on the card, is
    ``lifter_head(module, trunk_reference(embed_tokens(module, kp2d),
    module.pe, weights))``.
    """
    if not supports(module):
        raise ValueError("lifter_forward_fused takes the default "
                         "JointTransformerLifter architecture only")
    if kp2d.dim() != 3 or tuple(kp2d.shape[1:]) != (N_JOINTS, 2):
        raise ValueError(f"kp2d must be (B, {N_JOINTS}, 2), got {tuple(kp2d.shape)}")
    if weights is None:
        weights = pack_weights(module)
    return lifter_head(module, trunk(embed_tokens(module, kp2d), module.pe, weights))
