"""Reference checkpoints <-> the port's state dicts: the counterpart of
``pose3d_tpu/interop/torch_weights.py``, with its 14 public names.

"torch" in these names means the reference repository's module layout
(RHnejad/3D_PoseEstimation), whose trainers save
``torch.save({'model': model.state_dict(), ...})``. The port's models
keep the reference's keys and PyTorch's layouts (``models/lifters.py``,
``models/resnet.py``, ``models/heads.py``), so no tensor is transposed or
flipped here and no flax template is needed: each converter picks the
family's entries by the reference's key map, as JAX's does, and copies
them.

- ``*_from_torch(sd)``: a reference state dict (tensors or numpy arrays)
  -> a state dict that the port's model loads with ``strict=True``. Keys
  of the reference module that the family does not use (the AE's dead
  branches, ``Model_3D``'s camera-embedding MLP, a classifier ``fc``) are
  left out; a missing key raises KeyError.
- ``*_to_torch(sd)``: the port's state dict -> the reference's, as
  tensors, ready for ``torch.save({'model': ...})``.

| reference (file:line of the reference) | port model |
| --- | --- |
| ``LinearModel`` (phase1_lifting/baselineModel.py:50-102) | ``MartinezLifter`` |
| ``AE`` (baselineModel.py:135-215, encoder2/decoder2) | ``AELifter`` |
| ``MyViT`` (baselineModel.py:312-362) | ``JointTransformerLifter`` |
| ``Projection`` (phase5_loop/Model_2d.py:140-170) | ``ProjectionMLP`` |
| ``ResNet`` (phase3_direct/my_HybrIK/Resnet.py:98-165) | ``ResNet`` (torchvision keys) |
| ``Model_3D`` (phase3_direct/my_HybrIK/Model.py:12-191) | ``PoseNet3D`` |
| ``Model_2D`` (phase5_loop/Model_2d.py:13-138) | ``PoseNet2D`` |

A BatchNorm's ``num_batches_tracked`` is carried where the state dict
has it and set to 0 where it does not (JAX's export writes 0). The ViT's
sinusoidal PE is a buffer both sides recompute, in no state dict.
"""

from __future__ import annotations

import numpy as np
import torch

_BN = ("weight", "bias", "running_mean", "running_var")
_RESNET_ROOTS = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4.")


def _t(v) -> torch.Tensor:
    """A tensor or array-like -> a CPU tensor of its own (a copy)."""
    if torch.is_tensor(v):
        return v.detach().cpu().clone()
    return torch.from_numpy(np.array(v, order="C"))


def _linear(sd, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(sd[f"{prefix}.weight"])
    if f"{prefix}.bias" in sd:
        out[f"{prefix}.bias"] = _t(sd[f"{prefix}.bias"])


def _norm(sd, prefix: str, out: dict) -> None:
    """LayerNorm's affine pair."""
    for k in ("weight", "bias"):
        out[f"{prefix}.{k}"] = _t(sd[f"{prefix}.{k}"])


def _batch_norm(sd, prefix: str, out: dict) -> None:
    for k in _BN:
        out[f"{prefix}.{k}"] = _t(sd[f"{prefix}.{k}"])
    count = f"{prefix}.num_batches_tracked"
    out[count] = _t(sd[count]) if count in sd else torch.tensor(0, dtype=torch.int64)


def _martinez(sd, num_stages: int) -> dict:
    out: dict = {}
    _linear(sd, "w1", out)
    _batch_norm(sd, "batch_norm1", out)
    for i in range(num_stages):
        t = f"linear_stages.{i}"
        _linear(sd, f"{t}.w1", out)
        _batch_norm(sd, f"{t}.batch_norm1", out)
        _linear(sd, f"{t}.w2", out)
        _batch_norm(sd, f"{t}.batch_norm2", out)
    _linear(sd, "w2", out)
    return out


def martinez_from_torch(sd, num_stages: int = 2) -> dict:
    """``LinearModel`` state dict -> ``MartinezLifter`` state dict."""
    return _martinez(sd, num_stages)


def martinez_to_torch(sd, num_stages: int = 2) -> dict:
    """``MartinezLifter`` state dict -> ``LinearModel`` state dict."""
    return _martinez(sd, num_stages)


# encoder2: Flatten(0) Linear(1) BN(2) ReLU Drop | Linear(5) BN(6) ...;
# decoder2: Linear(0) BN(1) ReLU Drop | Linear(4)
_AE_LAYERS = (("encoder2.1", "encoder2.2"), ("encoder2.5", "encoder2.6"),
              ("decoder2.0", "decoder2.1"))


def _ae(sd) -> dict:
    out: dict = {}
    for lin, bn in _AE_LAYERS:
        _linear(sd, lin, out)
        _batch_norm(sd, bn, out)
    _linear(sd, "decoder2.4", out)
    return out


def ae_from_torch(sd) -> dict:
    """``AE`` state dict (the active encoder2/decoder2 path,
    baselineModel.py:186-205) -> ``AELifter`` state dict; the dead
    encoder/decoder branches are left out."""
    return _ae(sd)


def ae_to_torch(sd) -> dict:
    """``AELifter`` state dict -> ``AE`` state dict (encoder2/decoder2)."""
    return _ae(sd)


def _vit(sd, n_blocks: int) -> dict:
    out: dict = {}
    _linear(sd, "linear_mapper", out)
    for i in range(n_blocks):
        b = f"blocks.{i}"
        _norm(sd, f"{b}.norm1", out)
        _norm(sd, f"{b}.mhsa.norm", out)
        _linear(sd, f"{b}.mhsa.to_qkv", out)
        _linear(sd, f"{b}.mhsa.to_out", out)
        _norm(sd, f"{b}.norm2", out)
        _linear(sd, f"{b}.mlp.0", out)
        _linear(sd, f"{b}.mlp.2", out)
    _linear(sd, "mlp.0", out)
    _linear(sd, "mlp.2", out)
    return out


def vit_lifter_from_torch(sd, n_blocks: int = 2) -> dict:
    """``MyViT`` state dict -> ``JointTransformerLifter`` state dict."""
    return _vit(sd, n_blocks)


def vit_lifter_to_torch(sd, n_blocks: int = 2) -> dict:
    """``JointTransformerLifter`` state dict -> ``MyViT`` state dict."""
    return _vit(sd, n_blocks)


# mlp: Flatten(0) [Linear BN Tanh Drop] x 3 at (1, 2), (5, 6), (9, 10), Linear(13)
_PROJECTION_LAYERS = (("mlp.1", "mlp.2"), ("mlp.5", "mlp.6"), ("mlp.9", "mlp.10"))


def _projection(sd) -> dict:
    out: dict = {}
    for lin, bn in _PROJECTION_LAYERS:
        _linear(sd, lin, out)
        _batch_norm(sd, bn, out)
    _linear(sd, "mlp.13", out)
    return out


def projection_from_torch(sd) -> dict:
    """``Projection`` state dict -> ``ProjectionMLP`` state dict."""
    return _projection(sd)


def projection_to_torch(sd) -> dict:
    """``ProjectionMLP`` state dict -> ``Projection`` state dict."""
    return _projection(sd)


def _resnet(sd, src: str, dst: str) -> dict:
    """The torchvision ResNet body's entries of ``sd`` under ``src`` (the
    key map of ``models.resnet.load_torch_resnet``: the stem and
    ``layer1``-``layer4``, no classifier), re-keyed under ``dst``."""
    body = {k[len(src):]: v for k, v in sd.items()
            if k.startswith(src) and k[len(src):].startswith(_RESNET_ROOTS)}
    if "conv1.weight" not in body:
        raise KeyError(f"{src}conv1.weight: no ResNet under {src!r}")
    norms = {n.removesuffix(".running_var") for n in body if n.endswith(".running_var")}
    out = {n: _t(v) for n, v in body.items() if n.rsplit(".", 1)[0] not in norms}
    for bn in norms:
        _batch_norm(body, bn, out)
    return {dst + k: v for k, v in out.items()}


def resnet_from_torch(sd, prefix: str = "") -> dict:
    """Reference (torchvision-layout) ResNet state dict -> ``ResNet`` state
    dict; ``prefix`` (e.g. ``"preact."``) is stripped from the keys, and
    the classifier ``fc`` is left out, as the reference's warm start
    leaves it (Model.py:30-38)."""
    return _resnet(sd, prefix, "")


def resnet_to_torch(sd, prefix: str = "") -> dict:
    """``ResNet`` state dict -> the reference's (torchvision keys), each
    key after ``prefix``."""
    return _resnet(sd, "", prefix)


def _posenet(sd) -> dict:
    out = _resnet(sd, "preact.", "preact.")
    for slot in (0, 3, 6):  # the deconvs, no bias; their BatchNorms at slot + 1
        out[f"deconv_layers.{slot}.weight"] = _t(sd[f"deconv_layers.{slot}.weight"])
        _batch_norm(sd, f"deconv_layers.{slot + 1}", out)
    _linear(sd, "final_layer", out)
    return out


def posenet3d_from_torch(sd) -> dict:
    """``Model_3D`` state dict -> ``PoseNet3D`` state dict: the backbone
    under ``preact.``, the deconv stack at slots 0/3/6 with BatchNorms at
    1/4/7, the 1x1 final conv; the dead camera-embedding MLP (Model.py:
    50-64) is left out."""
    return _posenet(sd)


def posenet3d_to_torch(sd) -> dict:
    """``PoseNet3D`` state dict -> ``Model_3D`` state dict."""
    return _posenet(sd)


def posenet2d_from_torch(sd) -> dict:
    """``Model_2D`` state dict -> ``PoseNet2D`` state dict (``Model_3D``'s
    structure with a J-channel final conv, Model_2d.py:13-138)."""
    return _posenet(sd)


def posenet2d_to_torch(sd) -> dict:
    """``PoseNet2D`` state dict -> ``Model_2D`` state dict."""
    return _posenet(sd)
