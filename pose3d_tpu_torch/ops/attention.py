"""Multi-head self-attention over flat ``[q|k|v]`` rows: the port of
``pose3d_tpu/ops/pallas_attention.py``.

- ``packed_flat_attention(qkv, seq, heads)``: (n·seq, 3·dim) rows that
  hold n sequences of ``seq`` tokens back to back -> (n·seq, dim), each
  sequence attending to itself only (the TPU kernel ``_packed_kernel``).
- ``seq_attention(qkv, heads)``: (N, L, 3·dim) -> (N, L, dim), one
  sequence per row of the first axis (the TPU kernel ``_seq_kernel``).

Both launch the CUDA kernels of ``csrc/attention.cu`` when ``qkv`` lies on
a CUDA device (sequences of at most ``SPLIT_LEN`` rows on
``attention_kernel``, longer ones on ``attention_wg_kernel``) and run their
plain versions (``*_reference``) when it lies on the CPU. Both are ``torch.autograd.Function``s on either device, as the
JAX wrappers are ``custom_vjp``s: the backward recomputes and
differentiates the standard-softmax formulation (``standard_attention``,
JAX's ``_xla_attention_flat``), for which JAX has no TPU kernel either.

Numerical contract, as in the JAX helpers: scores and softmax in f32,
the numerator ``e = exp(min(s, 80))`` with no row max, the normalizer
summed from the f32 ``e``, ``e`` cast to the value dtype before the AV
product, and the divide folded into the ``(rows, dh)`` output.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build

SCORE_CLAMP = 80.0  # overflow guard in place of the softmax row max
HEAD_DIMS = (16, 32, 64)  # the head widths the CUDA kernel is built for
SMEM_LIMIT = 232448  # shared memory one CUDA block may use on Hopper
# the longest sequence of the mma.sync kernel; longer ones take the wgmma
# kernel (csrc/attention.cuh kAttnSplitLen)
SPLIT_LEN = 64


def score_exp(s: torch.Tensor) -> torch.Tensor:
    """Clamped softmax numerator ``exp(min(s, SCORE_CLAMP))`` of f32 scores.

    The same math as a max-subtracted softmax while every score is below
    the clamp.
    """
    return torch.exp(torch.clamp(s, max=SCORE_CLAMP))


def heads_attention(qkv: torch.Tensor, heads: int, dh: int) -> torch.Tensor:
    """Multi-head attention within each sequence of ``rows`` tokens: the
    JAX helper ``masked_heads_attention`` with no mask.

    qkv (..., rows, 3*heads*dh), columns ``[q | k | v]`` with head h of
    each at ``[h*dh, (h+1)*dh)``. Returns (..., rows, heads*dh) in
    ``qkv.dtype``.
    """
    dim = heads * dh
    scale = dh ** -0.5
    outs = []
    for h in range(heads):
        q = qkv[..., h * dh:(h + 1) * dh].float()
        k = qkv[..., dim + h * dh:dim + (h + 1) * dh].float()
        v = qkv[..., 2 * dim + h * dh:2 * dim + (h + 1) * dh]
        e = score_exp((q @ k.transpose(-1, -2)) * scale)
        r = 1.0 / e.sum(dim=-1, keepdim=True)
        av = e.to(v.dtype).float() @ v.float()
        outs.append((av * r).to(qkv.dtype))
    return torch.cat(outs, dim=-1)


def packed_flat_attention_reference(qkv: torch.Tensor, seq: int,
                                    heads: int) -> torch.Tensor:
    """Plain version of ``packed_flat_attention``: full attention on the
    (rows // seq, seq, 3·dim) view, which equals the JAX kernel's
    block-diagonal mask over any whole number of sequences."""
    rows, three_dim = qkv.shape
    dim = three_dim // 3
    out = heads_attention(qkv.view(rows // seq, seq, three_dim), heads, dim // heads)
    return out.view(rows, dim)


def seq_attention_reference(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of ``seq_attention``."""
    return heads_attention(qkv, heads, qkv.shape[-1] // 3 // heads)


def smem_bytes(seq: int, dh: int) -> int:
    """Shared memory of one block of the mma.sync kernel at sequence length
    ``seq``: K and V of one head (Q stays in registers), padded to whole
    16-row tiles, at a pitch of dh + 8 bf16. ``csrc/attention.cuh``
    computes the same. The wgmma kernel streams K and V through a ring and
    needs no more for longer sequences, but takes the same lengths."""
    return 2 * (-(-seq // 16) * 16) * (dh + 8) * 2


def check_length(seq: int, dh: int) -> None:
    """Raises unless the K and V of a ``seq``-row sequence at head width
    ``dh`` fit in one CUDA block's shared memory (at most 1440 rows at
    dh = 32): the limit of every CUDA attention launch, the sub-blocks'
    included."""
    if smem_bytes(seq, dh) > SMEM_LIMIT:
        raise ValueError(f"sequence length {seq} at head width {dh}: K and V need "
                         f"{smem_bytes(seq, dh)} bytes and do not fit in shared memory")


def _head_dim(qkv: torch.Tensor, heads: int, seq: int) -> int:
    three_dim = qkv.shape[-1]
    if three_dim % 3 or (three_dim // 3) % heads:
        raise ValueError(f"qkv width {three_dim} is not 3 x {heads} heads")
    dh = three_dim // 3 // heads
    if seq < 1:
        raise ValueError(f"sequence length {seq} must be at least 1")
    if qkv.device.type == "cpu":
        return dh
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the attention kernel takes bfloat16, got {qkv.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh}: the attention kernel takes {HEAD_DIMS}")
    check_length(seq, dh)
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and start on a 16-byte boundary")
    return dh


def standard_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """MHSA within each sequence of qkv (..., L, 3·dim) with the standard
    max-subtracted softmax in f32, probabilities cast to the value dtype:
    the formulation the JAX wrappers' backward differentiates
    (``pallas_attention._xla_attention_flat``)."""
    *lead, length, three_dim = qkv.shape
    dim = three_dim // 3
    dh = dim // heads
    q, k, v = qkv.reshape(-1, length, 3, heads, dh).permute(2, 0, 3, 1, 4)
    a = (q @ k.transpose(-1, -2)) * dh ** -0.5
    a = torch.softmax(a.float(), dim=-1).to(qkv.dtype)
    return (a @ v).transpose(1, 2).reshape(*lead, length, dim)


def _standard_grad(qkv: torch.Tensor, g: torch.Tensor, heads: int) -> torch.Tensor:
    """d(standard_attention)/d(qkv) against the output gradient g."""
    with torch.enable_grad():
        x = qkv.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(standard_attention(x, heads), x, g)
    return dx


class _PackedFlatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, seq, heads, dh):
        ctx.save_for_backward(qkv)
        ctx.seq, ctx.heads = seq, heads
        if qkv.device.type == "cpu":
            return packed_flat_attention_reference(qkv, seq, heads)
        rows = qkv.shape[0]
        out = torch.empty(rows, heads * dh, dtype=qkv.dtype, device=qkv.device)
        if rows:
            _launch(qkv, out, rows // seq, seq, heads, dh)
            packed_flat_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        rows, seq = qkv.shape[0], ctx.seq
        dqkv = _standard_grad(qkv.view(rows // seq, seq, -1), g.reshape(rows // seq, seq, -1),
                              ctx.heads)
        return dqkv.view(rows, -1), None, None, None


class _SeqAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, dh):
        ctx.save_for_backward(qkv)
        ctx.heads = heads
        if qkv.device.type == "cpu":
            return seq_attention_reference(qkv, heads)
        n, length, _ = qkv.shape
        out = torch.empty(n, length, heads * dh, dtype=qkv.dtype, device=qkv.device)
        if n:
            _launch(qkv, out, n, length, heads, dh)
            seq_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return _standard_grad(qkv, g, ctx.heads), None, None


def packed_flat_attention(qkv: torch.Tensor, seq: int,
                          heads: int) -> torch.Tensor:
    """MHSA over flat rows: qkv (n·seq, 3·dim) -> (n·seq, dim), each run of
    ``seq`` rows one sequence; differentiable (see the module docstring).

    On a CUDA device this launches the kernel (bf16, head width 16, 32 or
    64; anything else raises) and counts it in
    ``packed_flat_attention.launches``; on the CPU it runs
    ``packed_flat_attention_reference``.
    """
    if qkv.dim() != 2:
        raise ValueError(f"qkv must be (rows, 3*dim), got {tuple(qkv.shape)}")
    dh = _head_dim(qkv, heads, seq)
    if qkv.shape[0] % seq:
        raise ValueError(f"{qkv.shape[0]} rows are not whole sequences of {seq}")
    return _PackedFlatAttention.apply(qkv, seq, heads, dh)


packed_flat_attention.launches = 0


def seq_attention(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """MHSA, one sequence per row of the first axis: qkv (N, L, 3·dim) ->
    (N, L, dim), for L too long to pack (the 243-frame temporal axis);
    differentiable (see the module docstring).

    On a CUDA device this launches the kernel (bf16, head width 16, 32 or
    64; anything else raises) and counts it in ``seq_attention.launches``;
    on the CPU it runs ``seq_attention_reference``.
    """
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (N, L, 3*dim), got {tuple(qkv.shape)}")
    dh = _head_dim(qkv, heads, qkv.shape[1])
    return _SeqAttention.apply(qkv, heads, dh)


seq_attention.launches = 0


def _launch(qkv, out, n_seq: int, seq: int, heads: int, dh: int) -> None:
    """Both wrappers' kernel: (n_seq, seq, 3·dim) contiguous rows are the
    same bytes as (n_seq·seq, 3·dim) flat rows, so on the GPU the packed
    and the per-sequence forms are one kernel, one block per (sequence,
    head); the TPU's packing exists to fill its 128-wide matrix unit."""
    lib = _build.library()
    with torch.cuda.device(qkv.device):  # the launch's current device
        err = lib.attention_launch(qkv.data_ptr(), out.data_ptr(), n_seq, seq,
                                   heads, dh, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "attention_launch")
