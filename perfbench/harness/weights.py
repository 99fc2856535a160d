"""Seeded weights, made on the device in one draw.

Every parameter a configuration's reference names is cut from one
``torch.randn`` on the device (a ``torch.Generator`` there, seeded by the
run's seed) and scaled: matrices lecun-normal (1 / sqrt(fan in)),
LayerNorm scales 1 + N(0, 0.1), biases, LayerNorm shifts and PE tables
N(0, 0.1). No bias is 0 and no scale 1, so a weight read from the wrong
place shows in the outputs. The same seed gives the same weights; the
draw is in float32 and the result is cast to the dtype served.
"""

from __future__ import annotations

import math

import torch


def seeded_params(shapes: dict, seed: int, device, dtype=torch.float32) -> dict:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        t = flat[pos:pos + n].view(shape)
        pos += n
        if len(shape) == 2:
            t = t * shape[1] ** -0.5
        elif "norm" in name and name.endswith("weight"):
            t = 1.0 + 0.1 * t
        else:
            t = 0.1 * t
        out[name] = t.to(dtype).contiguous()
    return out
