"""Plain reference of the ``vit_lifter`` configuration: the MyViT
joint-token lifter (RHnejad/3D_PoseEstimation,
``phase1_lifting/baselineModel.py:312-362``) and the serving rules of a
bucketed batch service, in float32 PyTorch.

The parameters are named as the reference repository's state dict names
them: ``linear_mapper``, ``blocks.<i>.{norm1, mhsa.norm, mhsa.to_qkv,
mhsa.to_out, norm2, mlp.0, mlp.2}``, ``mlp.{0, 2}``. A block is pre-LN:
x + to_out(attention(to_qkv(LN_mhsa(LN_1(x))))), then x + MLP(LN_2(x))
with exact GELU; the fixed sinusoidal PE is added after the embedding.

``serve`` applies the service's rules as this file states them: buckets
are the powers of two from ``min_bucket`` to ``max_batch``; a request is
cut into chunks of at most ``max_batch`` frames, each zero-padded to the
smallest bucket that holds it, run, and sliced back. It imports nothing
of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.references.common import attention, gelu, layer_norm, linear, mm32


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    d, mlp, hh = cfg["hidden"], cfg["mlp_hidden"], cfg["head_hidden"]
    shapes = {"linear_mapper.weight": (d, cfg["in_dim"]), "linear_mapper.bias": (d,)}
    for i in range(cfg["n_blocks"]):
        p = f"blocks.{i}."
        shapes.update({
            p + "norm1.weight": (d,), p + "norm1.bias": (d,),
            p + "mhsa.norm.weight": (d,), p + "mhsa.norm.bias": (d,),
            p + "mhsa.to_qkv.weight": (3 * d, d), p + "mhsa.to_out.weight": (d, d),
            p + "norm2.weight": (d,), p + "norm2.bias": (d,),
            p + "mlp.0.weight": (mlp, d), p + "mlp.0.bias": (mlp,),
            p + "mlp.2.weight": (d, mlp), p + "mlp.2.bias": (d,),
        })
    shapes.update({"mlp.0.weight": (hh, d), "mlp.0.bias": (hh,),
                   "mlp.2.weight": (cfg["out_dim"], hh), "mlp.2.bias": (cfg["out_dim"],)})
    return shapes


def sinusoidal_pe(length: int, d: int) -> torch.Tensor:
    """pe[i, j] = sin(i / 1e4^(j/d)) for even j, cos(i / 1e4^((j-1)/d))
    for odd j, in float64 and rounded to float32."""
    i = np.arange(length, dtype=np.float64)[:, None]
    j = np.arange(d, dtype=np.float64)[None, :]
    even = np.sin(i / np.power(1e4, j / d))
    odd = np.cos(i / np.power(1e4, (j - 1) / d))
    return torch.from_numpy(np.where(j % 2 == 0, even, odd).astype(np.float32))


def forward(p: dict, x: torch.Tensor, cfg: dict, mm=mm32) -> torch.Tensor:
    """(B, 17, 2) keypoints -> (B, 17, 3) poses, in float32."""
    eps, heads = cfg["ln_eps"], cfg["heads"]
    x = x.float()
    t = linear(x, p["linear_mapper.weight"], p["linear_mapper.bias"], mm)
    t = t + sinusoidal_pe(cfg["n_joints"], cfg["hidden"]).to(t.device)
    for i in range(cfg["n_blocks"]):
        b = f"blocks.{i}."
        y = layer_norm(t, p[b + "norm1.weight"], p[b + "norm1.bias"], eps)
        y = layer_norm(y, p[b + "mhsa.norm.weight"], p[b + "mhsa.norm.bias"], eps)
        a = attention(linear(y, p[b + "mhsa.to_qkv.weight"], None, mm), heads, mm)
        t = t + linear(a, p[b + "mhsa.to_out.weight"], None, mm)
        y = layer_norm(t, p[b + "norm2.weight"], p[b + "norm2.bias"], eps)
        y = gelu(linear(y, p[b + "mlp.0.weight"], p[b + "mlp.0.bias"], mm))
        t = t + linear(y, p[b + "mlp.2.weight"], p[b + "mlp.2.bias"], mm)
    y = torch.relu(linear(t, p["mlp.0.weight"], p["mlp.0.bias"], mm))
    return linear(y, p["mlp.2.weight"], p["mlp.2.bias"], mm)


def buckets(cfg: dict) -> list[int]:
    out, b = [], cfg["min_bucket"]
    while b <= cfg["max_batch"]:
        out.append(b)
        b *= 2
    return out


def chunk_buckets(n: int, cfg: dict) -> list[tuple[int, int]]:
    """A request of n frames as the service runs it: (frames, bucket) a
    chunk."""
    top, bs = cfg["max_batch"], buckets(cfg)
    out = []
    for pos in range(0, n, top):
        take = min(top, n - pos)
        out.append((take, next(b for b in bs if b >= take)))
    return out


@torch.no_grad()
def serve(p: dict, kp2d: torch.Tensor, cfg: dict, mm=mm32) -> torch.Tensor:
    """A request's (N, 17, 2) keypoints -> its (N, 17, 3) poses, chunk by
    chunk, each padded with zero frames to its bucket and sliced back."""
    outs, pos = [], 0
    for take, bucket in chunk_buckets(len(kp2d), cfg):
        x = torch.zeros((bucket, *kp2d.shape[1:]), dtype=torch.float32, device=kp2d.device)
        x[:take] = kp2d[pos:pos + take]
        outs.append(forward(p, x, cfg, mm)[:take])
        pos += take
    return torch.cat(outs) if outs else kp2d.new_zeros((0, cfg["n_joints"], cfg["out_dim"]))
