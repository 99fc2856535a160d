"""The elementwise math the port's kernels share, as plain PyTorch.

The counterpart of ``_ln``, ``_erf``, ``_gelu`` and the f32-accumulated
dot of ``pose3d_tpu/ops/pallas_lifter.py``, which the lifter trunk and the
temporal sub-block kernels all use. The CUDA kernels (``csrc/common.cuh``)
carry the same constants and follow the same rounding.
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


def ln(x, g, b) -> torch.Tensor:
    """LayerNorm with f32 statistics and biased variance, in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + LN_EPS)
    return (y * g.float() + b.float()).to(x.dtype)


def dot(a, w) -> torch.Tensor:
    """a @ w accumulated in f32 (exact products of the working dtype)."""
    return a.float() @ w.float()
