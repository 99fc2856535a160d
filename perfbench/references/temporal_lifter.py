"""Plain reference of the ``temporal_lifter`` configuration's training
step, in float32 PyTorch: the spatio-temporal lifter's forward, the MSE
loss, its gradients by autograd and AdamW.

The forward: (B, T, 17, 2) clips embedded to ``hidden``, plus a learned
spatial (per joint) and temporal (per frame) table; each block attends
over the 17 joints of every frame, then over the T frames of every
joint, each half pre-LN (x + proj(attention(qkv(LN_1 x))), then x +
fc2(GELU(fc1(LN_2 x)))) with exact GELU; then LN -> hidden/2 -> ReLU ->
3. Parameters are named as the port's state dict names them
(``embed``, ``spatial_pe``, ``temporal_pe``, ``blocks.<i>.<half>_...``,
``norm``, ``head.{0, 2}``).

AdamW is torch's update written out: decoupled decay p(1 - lr wd), the
moments with bias correction, p - lr m_hat / (sqrt(v_hat) + eps).

``leaves`` splits each qkv weight and bias into its q, k and v parts,
the leaves the comparison reads: a key bias has a gradient of 0 in exact
arithmetic (the softmax cancels it), and held apart it is left out by
the rule on the reference's gradient. It imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.references.common import attention, gelu, layer_norm, linear, mm32

HALVES = ("spatial", "temporal")
CHUNK_CLIPS = 8  # clips a forward and backward at a time: the gradient is their sum


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    d, j, t, hh = cfg["hidden"], cfg["n_joints"], cfg["clip_len"], cfg["head_hidden"]
    mlp = cfg["mlp_ratio"] * d
    shapes = {"embed.weight": (d, cfg["in_dim"]), "embed.bias": (d,),
              "spatial_pe": (1, 1, j, d), "temporal_pe": (1, t, 1, d)}
    for i in range(cfg["n_blocks"]):
        for half in HALVES:
            p = f"blocks.{i}.{half}_"
            shapes.update({
                p + "norm1.weight": (d,), p + "norm1.bias": (d,),
                p + "attn.qkv.weight": (3 * d, d), p + "attn.qkv.bias": (3 * d,),
                p + "attn.proj.weight": (d, d), p + "attn.proj.bias": (d,),
                p + "norm2.weight": (d,), p + "norm2.bias": (d,),
                p + "mlp.fc1.weight": (mlp, d), p + "mlp.fc1.bias": (mlp,),
                p + "mlp.fc2.weight": (d, mlp), p + "mlp.fc2.bias": (d,),
            })
    shapes.update({"norm.weight": (d,), "norm.bias": (d,),
                   "head.0.weight": (hh, d), "head.0.bias": (hh,),
                   "head.2.weight": (cfg["out_dim"], hh), "head.2.bias": (cfg["out_dim"],)})
    return shapes


def _half(x, p: dict, prefix: str, cfg: dict, mm):
    eps = cfg["ln_eps"]
    y = layer_norm(x, p[prefix + "norm1.weight"], p[prefix + "norm1.bias"], eps)
    a = attention(linear(y, p[prefix + "attn.qkv.weight"], p[prefix + "attn.qkv.bias"], mm),
                  cfg["heads"], mm)
    x = x + linear(a, p[prefix + "attn.proj.weight"], p[prefix + "attn.proj.bias"], mm)
    y = layer_norm(x, p[prefix + "norm2.weight"], p[prefix + "norm2.bias"], eps)
    y = gelu(linear(y, p[prefix + "mlp.fc1.weight"], p[prefix + "mlp.fc1.bias"], mm))
    return x + linear(y, p[prefix + "mlp.fc2.weight"], p[prefix + "mlp.fc2.bias"], mm)


def forward(p: dict, clips: torch.Tensor, cfg: dict, mm=mm32) -> torch.Tensor:
    """(B, T, 17, 2) -> (B, T, 17, 3), float32."""
    b, t, j, _ = clips.shape
    c = cfg["hidden"]
    x = linear(clips.float(), p["embed.weight"], p["embed.bias"], mm)
    x = x + p["spatial_pe"] + p["temporal_pe"][:, :t]
    for i in range(cfg["n_blocks"]):
        xs = _half(x.reshape(b * t, j, c), p, f"blocks.{i}.spatial_", cfg, mm)
        xt = xs.view(b, t, j, c).transpose(1, 2).reshape(b * j, t, c)
        xt = _half(xt, p, f"blocks.{i}.temporal_", cfg, mm)
        x = xt.view(b, j, t, c).transpose(1, 2)
    y = layer_norm(x, p["norm.weight"], p["norm.bias"], cfg["ln_eps"])
    y = torch.relu(linear(y, p["head.0.weight"], p["head.0.bias"], mm))
    return linear(y, p["head.2.weight"], p["head.2.bias"], mm)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


def mpjpe_sum(pred: torch.Tensor, target: torch.Tensor) -> float:
    """Every joint's L2 error, summed over joints, frames and clips."""
    return float((pred - target).double().square().sum(-1).sqrt().sum())


def leaves(tensors: dict) -> dict[str, torch.Tensor]:
    """The comparison's leaves: every parameter, each qkv weight and bias
    cut into q, k and v."""
    out = {}
    for name, t in tensors.items():
        if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}[{part}]"] = piece
        else:
            out[name] = t
    return out


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves(tensors).items()}


def host_leaves(tensors: dict) -> dict[str, torch.Tensor]:
    """The leaves, float32 copies on the host."""
    return {k: v.detach().float().cpu() for k, v in leaves(tensors).items()}


class AdamW:
    """torch's AdamW update, written out (amsgrad off)."""

    def __init__(self, params: dict, cfg: dict):
        self.lr, self.wd, self.eps = cfg["lr"], cfg["weight_decay"], cfg["adam_eps"]
        self.b1, self.b2 = cfg["betas"]
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def train_steps(params0: dict, batches, cfg: dict, mm=mm32):
    """The configuration's first steps from ``params0`` (copied) over
    ``batches`` [(clips, targets), ...]. Returns each step's loss, the
    first step's gradient by name, the parameters after the last step by
    name, and each step's MPJPE sum. Each batch runs CHUNK_CLIPS clips at
    a time, each chunk's loss weighted by its share of the batch, so that
    it fits beside nothing else; the clips are independent, so the sum is
    the whole batch's gradient."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in params0.items()}
    opt = AdamW(params, cfg)
    losses, mpjpe, first_grad = [], [], None
    for clips, target in batches:
        loss, err, grads = 0.0, 0.0, None
        for i in range(0, len(clips), CHUNK_CLIPS):
            c, t = clips[i:i + CHUNK_CLIPS], target[i:i + CHUNK_CLIPS].float()
            pred = forward(params, c, cfg, mm)
            part = mse(pred, t) * (len(c) / len(clips))
            g = torch.autograd.grad(part, list(params.values()))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss += float(part.detach())
            err += mpjpe_sum(pred.detach(), t)
        grads = dict(zip(params, grads))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(loss)
        mpjpe.append(err)
    return losses, first_grad, {k: v.detach() for k, v in params.items()}, mpjpe
