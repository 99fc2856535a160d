"""Plain reference of the ``motionbert`` configuration: MotionBERT's
DSTformer forward (Zhu et al., ICCV 2023; ``lib/model/DSTformer.py`` as
built by ``load_backbone`` from ``configs/pose3d/MB_train_h36m.yaml``) in
float32 PyTorch, and the plain clipping and overlap-averaging of a video
that the program's ``lift_sequence`` defines, for any configuration's
forward.

The forward, (B, T, 17, 3) -> (B, T, 17, 3):

    h = x W_e + b_e + pos_embed[j] + temp_embed[f]
    for each layer i:
        s = ST_i(h): the spatial sub-block, then the temporal one
        t = TS_i(h): the temporal sub-block, then the spatial one
        a = softmax([s | t] W_f,i + b_f,i)      (2C -> 2, a pair a token)
        h = a_0 s + a_1 t
    y = tanh(LN(h) W_r + b_r) W_o + b_o

A sub-block is pre-LN: x + proj(attention(qkv(LN_1 x))), then x +
fc2(GELU(fc1(LN_2 x))), exact GELU, LayerNorm eps 1e-6, softmax with the
row max subtracted; spatial sub-blocks attend over the 17 joints of a
frame, temporal ones over the T frames of a joint. Each block of each
stream holds its own weights. Parameters are named as MotionBERT's state
dict names them (``param_shapes``). MotionBERT's eval-time path: no
dropout, no DropPath.

Departures from MotionBERT, each the served program's: the configuration
serves bf16 weights (this reference computes in float32 on those same
weights, cast up); and x and y are divided by the image size, where
MotionBERT's ``infer_wild.py`` rescales each clip by ``crop_scale``.

``lift_video``: a video's frames cut into clips of ``min(clip_len, T)``
frames, one at every ``stride``-th frame (half a clip by default) whose
clip fits, and one more anchored at the last frame where the grid does
not reach it; every clip through the forward; each frame the mean of the
clips that hold it. It imports nothing of the program.
"""

from __future__ import annotations

import torch

from perfbench.references.common import attention, gelu, layer_norm, linear, mm32

STREAMS = (("blocks_st", "st"), ("blocks_ts", "ts"))
CHUNK_CLIPS = 8  # clips a forward of lift_video at a time


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    d, j, t, r = cfg["hidden"], cfg["n_joints"], cfg["clip_len"], cfg["rep_dim"]
    mlp = cfg["mlp_ratio"] * d
    shapes = {"joints_embed.weight": (d, cfg["in_dim"]), "joints_embed.bias": (d,),
              "pos_embed": (1, j, d), "temp_embed": (1, t, 1, d)}
    for stream, _ in STREAMS:
        for i in range(cfg["n_blocks"]):
            for a in "st":
                p = f"{stream}.{i}."
                shapes.update({
                    f"{p}norm1_{a}.weight": (d,), f"{p}norm1_{a}.bias": (d,),
                    f"{p}attn_{a}.qkv.weight": (3 * d, d), f"{p}attn_{a}.qkv.bias": (3 * d,),
                    f"{p}attn_{a}.proj.weight": (d, d), f"{p}attn_{a}.proj.bias": (d,),
                    f"{p}norm2_{a}.weight": (d,), f"{p}norm2_{a}.bias": (d,),
                    f"{p}mlp_{a}.fc1.weight": (mlp, d), f"{p}mlp_{a}.fc1.bias": (mlp,),
                    f"{p}mlp_{a}.fc2.weight": (d, mlp), f"{p}mlp_{a}.fc2.bias": (d,),
                })
    for i in range(cfg["n_blocks"]):
        shapes.update({f"ts_attn.{i}.weight": (2, 2 * d), f"ts_attn.{i}.bias": (2,)})
    shapes.update({"norm.weight": (d,), "norm.bias": (d,),
                   "pre_logits.fc.weight": (r, d), "pre_logits.fc.bias": (r,),
                   "head.weight": (cfg["out_dim"], r), "head.bias": (cfg["out_dim"],)})
    return shapes


def _sub_block(x, p: dict, block: str, axis: str, cfg: dict, mm):
    """x (N, L, C): N sequences along the sub-block's axis ("s" or "t")."""
    w = lambda name: p[f"{block}{name.format(axis)}"]
    eps = cfg["ln_eps"]
    y = layer_norm(x, w("norm1_{}.weight"), w("norm1_{}.bias"), eps)
    a = attention(linear(y, w("attn_{}.qkv.weight"), w("attn_{}.qkv.bias"), mm),
                  cfg["heads"], mm)
    x = x + linear(a, w("attn_{}.proj.weight"), w("attn_{}.proj.bias"), mm)
    y = layer_norm(x, w("norm2_{}.weight"), w("norm2_{}.bias"), eps)
    y = gelu(linear(y, w("mlp_{}.fc1.weight"), w("mlp_{}.fc1.bias"), mm))
    return x + linear(y, w("mlp_{}.fc2.weight"), w("mlp_{}.fc2.bias"), mm)


def _stream(h, p: dict, block: str, order: str, cfg: dict, mm):
    """One stream's block on (B, T, J, C) tokens, its sub-blocks in
    ``order``."""
    b, t, j, c = h.shape
    for axis in order:
        if axis == "s":
            h = _sub_block(h.reshape(b * t, j, c), p, block, "s", cfg, mm).view(b, t, j, c)
        else:
            seqs = h.transpose(1, 2).reshape(b * j, t, c)
            h = _sub_block(seqs, p, block, "t", cfg, mm).view(b, j, t, c).transpose(1, 2)
    return h


def fusion_weights(p: dict, i: int, s, u, mm=mm32):
    """Layer i's pair of weights a token, softmax([s | u] W + b)."""
    return torch.softmax(linear(torch.cat([s, u], dim=-1), p[f"ts_attn.{i}.weight"],
                                p[f"ts_attn.{i}.bias"], mm), dim=-1)


def forward(p: dict, clips: torch.Tensor, cfg: dict, mm=mm32) -> torch.Tensor:
    """(B, T, 17, in_dim) -> (B, T, 17, out_dim), float32."""
    t = clips.shape[1]
    h = linear(clips.float(), p["joints_embed.weight"], p["joints_embed.bias"], mm)
    h = h + p["pos_embed"]
    h = h + p["temp_embed"][:, :t]
    for i in range(cfg["n_blocks"]):
        s, u = (_stream(h, p, f"{stream}.{i}.", order, cfg, mm) for stream, order in STREAMS)
        a = fusion_weights(p, i, s, u, mm)
        h = s * a[..., :1] + u * a[..., 1:]
    y = layer_norm(h, p["norm.weight"], p["norm.bias"], cfg["ln_eps"])
    y = torch.tanh(linear(y, p["pre_logits.fc.weight"], p["pre_logits.fc.bias"], mm))
    return linear(y, p["head.weight"], p["head.bias"], mm)


def clip_starts(n: int, length: int, stride: int) -> list[int]:
    """The first frame of each clip: every ``stride``-th frame whose clip
    of ``length`` fits in n, and n - length where those leave the last
    frames out."""
    starts = list(range(0, n - length + 1, stride))
    if starts[-1] + length < n:
        starts.append(n - length)
    return starts


def lift_video(forward_fn, p: dict, kp_px: torch.Tensor, cfg: dict, mm=mm32,
               image_size: float = 1000.0, stride: int | None = None) -> torch.Tensor:
    """(T, J, in_dim) pixel keypoints -> (T, J, out_dim) float32 on their
    device: x and y over ``image_size``, a third channel as it is; clips as
    the module docstring says, ``CHUNK_CLIPS`` at a time through
    ``forward_fn(p, clips, cfg, mm)``; each frame the mean over its clips."""
    n = kp_px.shape[0]
    length = min(cfg["clip_len"], n)
    stride = stride or max(length // 2, 1)
    kp = kp_px.float()
    kp = torch.cat([kp[..., :2] / image_size, kp[..., 2:]], dim=-1)
    starts = clip_starts(n, length, stride)
    total = torch.zeros(n, kp.shape[1], cfg["out_dim"], device=kp.device)
    count = torch.zeros(n, 1, 1, device=kp.device)
    for i in range(0, len(starts), CHUNK_CLIPS):
        batch = starts[i:i + CHUNK_CLIPS]
        out = forward_fn(p, torch.stack([kp[s:s + length] for s in batch]), cfg, mm)
        for s, o in zip(batch, out):
            total[s:s + length] += o
            count[s:s + length] += 1
    return total / count
