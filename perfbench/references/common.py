"""Plain PyTorch pieces shared by the references: LayerNorm, exact GELU,
multi-head attention with a max-subtracted softmax, and the products,
each through a ``mm`` the caller picks.

``mm32`` multiplies in float32 (the caller turns TF32 off). The
controls' lower precisions, each tensor on its own scale (its largest
magnitude onto the format's largest value), then multiplied in float32:
``mm_fp8`` rounds both operands of the forward product to float8 e4m3
and the incoming gradient of each backward product to e5m2; ``mm_int8``
rounds all three to symmetric int8. ``mm_bf16`` rounds all three to
bfloat16, the precision that the ``temporal_lifter`` configuration states
for its products: its gap from ``mm32`` is the gap that precision
explains. It imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 on the card (TF32 off), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def round_fp8(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    """x rounded to ``dtype`` on a per-tensor scale, back in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / fmax, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


def round_int8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to symmetric int8 on a per-tensor scale, back in its dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return (torch.round(x.float() / scale).clamp(-127, 127) * scale).to(x.dtype)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _rounded_matmul(fwd, bwd):
    """A product whose forward operands go through ``fwd`` and whose
    incoming gradient goes through ``bwd``."""

    class Rounded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            qa, qb = fwd(a), fwd(b)
            ctx.save_for_backward(qa, qb)
            return torch.matmul(qa, qb)

        @staticmethod
        def backward(ctx, g):
            qa, qb = ctx.saved_tensors
            qg = bwd(g)
            return torch.matmul(qg, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), qg)

    return Rounded.apply


mm_fp8 = _rounded_matmul(lambda x: round_fp8(x, torch.float8_e4m3fn, E4M3_MAX),
                         lambda g: round_fp8(g, torch.float8_e5m2, E5M2_MAX))
mm_int8 = _rounded_matmul(round_int8, round_int8)
mm_bf16 = _rounded_matmul(round_bf16, round_bf16)

MATMULS = {"f32": mm32, "bf16": mm_bf16, "fp8": mm_fp8, "int8": mm_int8}


def linear(x, w, b, mm):
    """x @ w^T (+ b), w as nn.Linear stores it (out, in); the rows of x
    flattened into one product."""
    y = mm(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b


def layer_norm(x, g, b, eps: float):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def gelu(x):
    """Exact GELU, x Phi(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(qkv, heads: int, mm):
    """(..., L, 3 d) rows [q | k | v], head h of each at [h dh, (h+1) dh)
    -> (..., L, d): softmax(q k^T / sqrt(dh)) v per head."""
    *lead, length, three_d = qkv.shape
    d = three_d // 3
    dh = d // heads
    q, k, v = qkv.reshape(*lead, length, 3, heads, dh).unbind(-3)
    q, k, v = (t.transpose(-2, -3) for t in (q, k, v))  # (..., heads, L, dh)
    s = mm(q, k.transpose(-1, -2)) * dh ** -0.5
    a = torch.softmax(s, dim=-1)
    return mm(a, v).transpose(-2, -3).reshape(*lead, length, d)
