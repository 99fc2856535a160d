"""The elementwise math the port's kernels share, as plain PyTorch.

The counterpart of ``_ln``, ``_erf``, ``_erf_grad``, ``_gelu`` and the
f32-accumulated dot of ``pose3d_tpu/ops/pallas_lifter.py``, which the
lifter trunk and the temporal sub-block kernels all use, and of the
training kernels' ``_gelu_grad``, ``_ln_fwd_stats`` and ``_ln_bwd_input``
(``pallas_stblock_train.py``). The CUDA kernels (``csrc/common.cuh``,
``csrc/stblock_train.cu``) carry the same constants and follow the same
rounding.
"""

from __future__ import annotations

import math

import torch

LN_EPS = 1e-5

# erf(x) ~= clamp(x)·P(clamp(x)^2), the JAX kernels' degree-8 polynomial
# (pallas_lifter._ERF_C): max |err| 2.7e-5 against the true erf, far below
# bf16 resolution. The CUDA kernels carry the same coefficients.
ERF_C = (1.1283599228e+00, -3.7577772172e-01, 1.1177045202e-01,
         -2.5570011680e-02, 4.4038703607e-03, -5.4564336601e-04,
         4.5123548106e-05, -2.1986137083e-06, 4.7283642828e-08)
ERF_CLAMP = 3.0


def _horner(coefs, s):
    p = torch.full_like(s, coefs[-1])
    for c in coefs[-2::-1]:
        p = p * s + c
    return p


def erf(x: torch.Tensor) -> torch.Tensor:
    """The clamped polynomial erf, in ``x.dtype``."""
    xc = torch.clamp(x, -ERF_CLAMP, ERF_CLAMP)
    return xc * _horner(ERF_C, xc * xc)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU on the polynomial erf, in f32, returned in ``x.dtype``."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + erf(xf / math.sqrt(2.0)))).to(x.dtype)


# P'(s) of the erf polynomial: d/dx [x·P(x^2)] = P(s) + 2s·P'(s)
# (pallas_lifter._ERF_D)
ERF_D = tuple(float((i + 1) * c) for i, c in enumerate(ERF_C[1:]))
INV_SQRT2 = float(1.0 / math.sqrt(2.0))


def erf_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of ``erf``: 0 where |x| >= 3 (strict ``<`` at the clamp, as the
    JAX kernels), in ``x.dtype``."""
    s = torch.clamp(x, -ERF_CLAMP, ERF_CLAMP).square()
    inner = _horner(ERF_C, s) + 2.0 * s * _horner(ERF_D, s)
    return torch.where(x.abs() < ERF_CLAMP, inner, torch.zeros_like(inner))


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """The exact derivative of ``gelu`` (0.5·x·(1 + erf(x/sqrt2)) on the
    polynomial erf), in f32: the train kernels' GELU backward
    (pallas_stblock_train._gelu_grad)."""
    xf = x.float()
    u = xf * INV_SQRT2
    return 0.5 * (1.0 + erf(u)) + 0.5 * xf * INV_SQRT2 * erf_grad(u)


def ln_fwd_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 LayerNorm forward pieces (xhat, r), biased variance."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + LN_EPS)
    return (xf - mu) * r, r


def ln_bwd_input(dy_affine: torch.Tensor, xhat: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """dx of LayerNorm given d(xhat·g), already multiplied by g."""
    m1 = dy_affine.mean(dim=-1, keepdim=True)
    m2 = (dy_affine * xhat).mean(dim=-1, keepdim=True)
    return r * (dy_affine - m1 - xhat * m2)


def ln(x, g, b) -> torch.Tensor:
    """LayerNorm with f32 statistics and biased variance, in ``x.dtype``."""
    xhat, _ = ln_fwd_stats(x)
    return (xhat * g.float() + b.float()).to(x.dtype)


def dot(a, w) -> torch.Tensor:
    """a @ w accumulated in f32 (exact products of the working dtype)."""
    return a.float() @ w.float()
