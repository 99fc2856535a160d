"""Plain PyTorch attention math shared by the port's kernels.

The counterpart of the helpers in ``pose3d_tpu/ops/pallas_attention.py``
(``score_exp``, ``block_diag_mask``, ``masked_heads_attention``,
``frame_chunked_attention``). The CUDA trunk kernel (``csrc/
lifter_trunk.cu``) inlines the same math per frame; these functions are
what the plain versions of that kernel run, on any device.

Numerical contract, as in the JAX helpers: scores and softmax in f32,
the numerator ``e = exp(min(s, 80))`` with no row max, the normalizer
summed from the f32 ``e``, ``e`` cast to the value dtype before the AV
product, and the divide folded into the ``(rows, dh)`` output.
"""

from __future__ import annotations

import torch

SCORE_CLAMP = 80.0  # overflow guard in place of the softmax row max


def score_exp(s: torch.Tensor) -> torch.Tensor:
    """Clamped softmax numerator ``exp(min(s, SCORE_CLAMP))`` of f32 scores.

    The same math as a max-subtracted softmax while every score is below
    the clamp; exp(-inf) = 0 keeps masked entries exact.
    """
    return torch.exp(torch.clamp(s, max=SCORE_CLAMP))


def block_diag_mask(rows: int, seq: int, device) -> torch.Tensor:
    """(rows, rows) bool: True within each length-``seq`` diagonal block."""
    idx = torch.arange(rows, device=device) // seq
    return idx[:, None] == idx[None, :]


def masked_heads_attention(qkv: torch.Tensor, mask, heads: int,
                           dh: int) -> torch.Tensor:
    """Multi-head attention over packed rows.

    qkv (..., rows, 3*heads*dh), columns ``[q | k | v]`` with head h of
    each at ``[h*dh, (h+1)*dh)``; mask (rows, rows) bool or None (full
    attention). Returns (..., rows, heads*dh) in ``qkv.dtype``.
    """
    dim = heads * dh
    scale = dh ** -0.5
    outs = []
    for h in range(heads):
        q = qkv[..., h * dh:(h + 1) * dh].float()
        k = qkv[..., dim + h * dh:dim + (h + 1) * dh].float()
        v = qkv[..., 2 * dim + h * dh:2 * dim + (h + 1) * dh]
        s = (q @ k.transpose(-1, -2)) * scale
        if mask is not None:
            s = s.masked_fill(~mask, float("-inf"))
        e = score_exp(s)
        r = 1.0 / e.sum(dim=-1, keepdim=True)
        av = e.to(v.dtype).float() @ v.float()
        outs.append((av * r).to(qkv.dtype))
    return torch.cat(outs, dim=-1)


def frame_chunked_attention(qkv: torch.Tensor, seq: int, heads: int, dh: int,
                            chunk: int) -> torch.Tensor:
    """Per-sequence attention over flat rows, computed in ``chunk``-row
    score tiles that align to sequence boundaries.

    qkv (rows, 3*heads*dh) holds ``rows // seq`` sequences back to back.
    Equal to ``masked_heads_attention(qkv, block_diag_mask(rows, seq))``;
    ``chunk == seq`` gives one unmasked tile per sequence.
    """
    rows = qkv.shape[0]
    if chunk >= rows or rows % chunk or chunk % seq:
        # a misaligned chunk would split a sequence: one full masked tile
        return masked_heads_attention(
            qkv, block_diag_mask(rows, seq, qkv.device), heads, dh)
    mask = None if chunk == seq else block_diag_mask(chunk, seq, qkv.device)
    tiles = qkv.view(rows // chunk, chunk, qkv.shape[1])
    return masked_heads_attention(tiles, mask, heads, dh).view(rows, heads * dh)
