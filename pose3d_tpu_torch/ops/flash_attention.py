"""Flash attention over flat ``[q|k|v]`` rows: the port of the TPU kernels
of ``jax.experimental.pallas.ops.tpu.flash_attention`` that
``pose3d_tpu/models/temporal.py``'s ``_MHSA(flash=True)`` calls for the
temporal half of each block.

``flash_attention(qkv, heads, kv=None)`` computes non-causal softmax
attention ``softmax(q kᵀ · dh^-0.5) v`` per (sequence, head), with no
mask, bias or segment ids, without forming the (L, L) scores:

- ``qkv`` (N, Lq, 3·dim) are the rows of ``_MHSA.qkv``, head h of q, k
  and v at columns ``h·dh``, ``dim + h·dh`` and ``2·dim + h·dh``;
- ``kv`` (N, Lk, 2·dim), where given, are ``[k|v]`` rows of another
  length, from which k and v are read instead (sequence parallelism:
  each rank's local queries attend to the keys and values gathered over
  the mesh's model axis); the k and v columns of ``qkv`` then get a zero
  gradient.

It is a ``torch.autograd.Function`` over three kernels, each behind a
wrapper that counts its launches: ``flash_forward`` (O and the f32
log-sum-exp of each row), ``flash_backward_dq`` (dQ, and ``D =
rowsum(dO ∘ O)`` in f32, which JAX computes outside its kernels) and
``flash_backward_dkv`` (dK and dV, on that D), launched in that order.
On a CUDA device each wrapper launches its kernel of
``csrc/flash_attention.cu`` (bf16, head width 16, 32 or 64, any lengths;
anything else raises) and the backward runs no PyTorch op for D; on the
CPU each runs its plain version (``*_reference``, ``flash_delta``), in
any float dtype.

Numerical contract, the kernels' rounding points: scores, the softmax
and its sums in f32 (float64 for float64 inputs), P rounded to the input
dtype before the PV product, the divide by the row sum after it; in the
backward P recomputed from the log-sum-exp, dV = bf16(P)ᵀ dO, dP = dO Vᵀ,
dS = P ∘ (dP − D) rounded to the input dtype before dQ = scale · dS K and
dK = scale · dSᵀ Q. The kernels keep an online row max where the plain
version takes the row's max at once; the two differ by the bf16 rounding
of P relative to another max.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch.ops import _build

HEAD_DIMS = (16, 32, 64)  # the head widths the CUDA kernels are built for


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, L, heads·dh) -> (N, heads, L, dh) in the accumulation dtype."""
    n, length, dim = x.shape
    return x.reshape(n, length, heads, dim // heads).transpose(1, 2).to(_acc(x.dtype))


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, heads, L, dh) -> contiguous (N, L, heads·dh) in ``dtype``."""
    n, heads, length, dh = x.shape
    return x.transpose(1, 2).reshape(n, length, heads * dh).to(dtype)


def flash_forward_reference(q, k, v, heads: int):
    """Plain version of ``flash_forward``: (O (N, Lq, dim) in q's dtype,
    the log-sum-exp (N, heads, Lq) in f32, or float64 for float64 q)."""
    dt = q.dtype
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    s = (qh @ kh.transpose(-1, -2)) * (qh.shape[-1] ** -0.5)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(dt).to(s.dtype) @ vh) / l
    return _merge(o, dt), (m + torch.log(l)).squeeze(-1)


def flash_delta(dout: torch.Tensor, o: torch.Tensor, heads: int) -> torch.Tensor:
    """D = rowsum(dO ∘ O) per (sequence, head, row): (N, heads, Lq) in
    f32 (float64 for float64 inputs), contiguous."""
    return (_heads(dout, heads) * _heads(o, heads)).sum(dim=-1).contiguous()


def flash_backward_reference(q, k, v, dout, lse, delta, heads: int):
    """Plain version of both backward kernels: (dQ, dK, dV), each in its
    input's dtype and layout (N, L, dim), contiguous."""
    dt = q.dtype
    qh, kh, vh, doh = (_heads(t, heads) for t in (q, k, v, dout))
    scale = qh.shape[-1] ** -0.5
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse.to(qh.dtype).unsqueeze(-1))
    dv = p.to(dt).to(p.dtype).transpose(-1, -2) @ doh
    ds = p * (doh @ vh.transpose(-1, -2) - delta.to(p.dtype).unsqueeze(-1))
    ds = ds.to(dt).to(p.dtype)
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


def flash_attention_reference(qkv: torch.Tensor, heads: int,
                              kv: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``flash_attention`` (forward): (N, Lq, dim)."""
    q, k, v = _views(qkv, kv)
    return flash_forward_reference(q, k, v, heads)[0]


def _views(qkv: torch.Tensor, kv: torch.Tensor | None):
    """The strided q, k and v views of ``qkv`` (and ``kv``)."""
    dim = qkv.shape[-1] // 3
    q = qkv[..., :dim]
    if kv is None:
        return q, qkv[..., dim:2 * dim], qkv[..., 2 * dim:]
    return q, kv[..., :dim], kv[..., dim:]


def _strides(q: torch.Tensor, k: torch.Tensor) -> tuple[int, int, int, int]:
    """(q's sequence and row strides, k's) in elements."""
    return q.stride(0), q.stride(1), k.stride(0), k.stride(1)


def _cuda_args(q, k, v, heads: int) -> tuple:
    """The launch's shapes after the checks every kernel makes on a CUDA
    operand: (n, Lq, Lk, dh)."""
    dh = q.shape[-1] // heads
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash attention kernels take bfloat16, got {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh}: the flash attention kernels take {HEAD_DIMS}")
    if v.stride() != k.stride():
        raise ValueError("k and v must share their strides")
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:2]):
            raise ValueError("q, k and v must be row-major views whose rows start on "
                             "16-byte boundaries")
    return q.shape[0], q.shape[1], k.shape[1], dh


def flash_forward(q, k, v, heads: int):
    """(O, log-sum-exp) of attention of the q rows over the k, v rows: q
    (N, Lq, dim), k and v (N, Lk, dim) strided views -> O contiguous (N,
    Lq, dim), the log-sum-exp (N, heads, Lq) f32. Launches kernel 14a on
    a CUDA device (counted in ``flash_forward.launches``); on the CPU runs
    ``flash_forward_reference``."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, heads)
    n, lq, lk, dh = _cuda_args(q, k, v, heads)
    o = torch.empty(n, lq, heads * dh, dtype=q.dtype, device=q.device)
    lse = torch.empty(n, heads, lq, dtype=torch.float32, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), *_strides(q, k),
                                   o.data_ptr(), lse.data_ptr(), n, lq, lk, heads, dh,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_fwd_launch")
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def _grad_operands(dout, lse, delta, *rows):
    """The backward kernels' operand checks; ``rows``: what else they read
    in dout's layout (14c: O)."""
    if not all(t.is_contiguous() for t in (dout, lse, delta, *rows)):
        raise ValueError("dout, o, lse and delta must be contiguous")
    if any(t.shape != dout.shape or t.dtype != dout.dtype for t in rows):
        raise ValueError("o must have dout's shape and dtype")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be float32")


def flash_backward_dkv(q, k, v, dout, lse, delta, heads: int, dk, dv) -> None:
    """Writes dK and dV into ``dk`` and ``dv`` (views with k's strides), on
    the D that ``flash_backward_dq`` wrote into ``delta``. Launches kernel
    14b on a CUDA device (counted in ``flash_backward_dkv.launches``); on
    the CPU writes ``flash_backward_reference``'s."""
    if q.device.type == "cpu":
        _, gk, gv = flash_backward_reference(q, k, v, dout, lse, delta, heads)
        dk.copy_(gk)
        dv.copy_(gv)
        return
    n, lq, lk, dh = _cuda_args(q, k, v, heads)
    _grad_operands(dout, lse, delta)
    if dk.stride() != k.stride() or dv.stride() != k.stride():
        raise ValueError("dk and dv must have k's strides")
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       *_strides(q, k), dout.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), n, lq,
                                       lk, heads, dh, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd_dkv_launch")
    flash_backward_dkv.launches += 1


flash_backward_dkv.launches = 0


def flash_backward_dq(q, k, v, dout, o, lse, heads: int, dq, delta) -> None:
    """Writes dQ into ``dq`` (a view with q's strides) and D = rowsum(dO ∘
    O) into ``delta`` (contiguous (N, heads, Lq), the log-sum-exp's dtype),
    which ``flash_backward_dkv`` then reads. Launches kernel 14c on a CUDA
    device (counted in ``flash_backward_dq.launches``), which computes D
    from the O and dO tiles it loads; on the CPU writes ``flash_delta``'s D
    and ``flash_backward_reference``'s dQ."""
    if q.device.type == "cpu":
        delta.copy_(flash_delta(dout, o, heads))
        dq.copy_(flash_backward_reference(q, k, v, dout, lse, delta, heads)[0])
        return
    n, lq, lk, dh = _cuda_args(q, k, v, heads)
    _grad_operands(dout, lse, delta, o)
    if dq.stride() != q.stride():
        raise ValueError("dq must have q's strides")
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      *_strides(q, k), dout.data_ptr(), o.data_ptr(),
                                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), n, lq, lk,
                                      heads, dh, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_bwd_dq_launch")
    flash_backward_dq.launches += 1


flash_backward_dq.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, kv, heads):
        o, lse = flash_forward(*_views(qkv, kv), heads)
        ctx.save_for_backward(qkv, kv, o, lse)
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, kv, o, lse = ctx.saved_tensors
        dout = g.contiguous()
        delta = torch.empty_like(lse)
        q, k, v = _views(qkv, kv)
        dqkv = torch.empty_like(qkv)
        if kv is None:
            dkv = None
            _, dk, dv = _views(dqkv, None)
        else:
            dqkv[..., q.shape[-1]:].zero_()
            dkv = torch.empty_like(kv)
            _, dk, dv = _views(dqkv, dkv)
        flash_backward_dq(q, k, v, dout, o, lse, ctx.heads, dqkv[..., :q.shape[-1]], delta)
        flash_backward_dkv(q, k, v, dout, lse, delta, ctx.heads, dk, dv)
        return dqkv, dkv, None


def flash_attention(qkv: torch.Tensor, heads: int,
                    kv: torch.Tensor | None = None) -> torch.Tensor:
    """Attention of the q rows of ``qkv`` (N, Lq, 3·dim) over the k and v
    rows of ``qkv``, or of ``kv`` (N, Lk, 2·dim) where given -> (N, Lq,
    dim) in qkv's dtype; differentiable (see the module docstring)."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 or (qkv.shape[-1] // 3) % heads:
        raise ValueError(f"qkv must be (N, L, 3 x dim) with dim a multiple of {heads} heads, "
                         f"got {tuple(qkv.shape)}")
    if qkv.shape[1] < 1:
        raise ValueError("qkv must hold at least one row a sequence")
    dim = qkv.shape[-1] // 3
    if kv is not None:
        if (kv.dim() != 3 or kv.shape[0] != qkv.shape[0] or kv.shape[-1] != 2 * dim
                or kv.shape[1] < 1):
            raise ValueError(f"kv must be (N, Lk, 2 x dim) = ({qkv.shape[0]}, Lk, {2 * dim}), "
                             f"got {tuple(kv.shape)}")
        if kv.dtype != qkv.dtype or kv.device != qkv.device:
            raise ValueError("kv must have qkv's dtype and device")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention kernel for device {qkv.device}")
    if qkv.device.type == "cuda" and not (qkv.is_contiguous()
                                          and (kv is None or kv.is_contiguous())):
        raise ValueError("qkv and kv must be contiguous")
    return _FlashAttention.apply(qkv, kv, heads)
