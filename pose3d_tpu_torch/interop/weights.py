"""flax param trees of the JAX package -> state dicts of the port.

The counterpart of ``pose3d_tpu/interop/torch_weights.py``'s
``vit_lifter_to_torch``, written with numpy alone so that the port needs
no JAX: a flax ``Dense`` kernel is (in, out) and a torch ``Linear``
weight (out, in), so kernels are transposed; LayerNorm scale/bias become
weight/bias.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable C-order copy


def _dense(p, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _scale_bias(p, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def vit_lifter_from_flax(params) -> dict[str, torch.Tensor]:
    """``JointTransformerLifter`` flax params (nested dicts of arrays) ->
    the port's ``JointTransformerLifter`` state dict (reference MyViT keys).

    The block count is read from the tree; a class token (``cls_token``)
    is carried over under the same name. The PE is a non-persistent
    buffer and is not part of the state dict.
    """
    sd: dict[str, torch.Tensor] = {}
    _dense(params["Dense_0"], "linear_mapper", sd)
    if "cls_token" in params:
        sd["cls_token"] = _t(params["cls_token"])
    n_blocks = sum(1 for k in params if k.startswith("TransformerBlock_"))
    for i in range(n_blocks):
        bp = params[f"TransformerBlock_{i}"]
        att = bp["JointAttention_0"]
        b = f"blocks.{i}"
        _scale_bias(bp["LayerNorm_0"], f"{b}.norm1", sd)
        _scale_bias(att["LayerNorm_0"], f"{b}.mhsa.norm", sd)
        _dense(att["Dense_0"], f"{b}.mhsa.to_qkv", sd)
        _dense(att["Dense_1"], f"{b}.mhsa.to_out", sd)
        _scale_bias(bp["LayerNorm_1"], f"{b}.norm2", sd)
        _dense(bp["Dense_0"], f"{b}.mlp.0", sd)
        _dense(bp["Dense_1"], f"{b}.mlp.2", sd)
    _dense(params["Dense_1"], "mlp.0", sd)
    _dense(params["Dense_2"], "mlp.2", sd)
    return sd
