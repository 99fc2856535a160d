"""flax param trees of the JAX package -> state dicts of the port.

The counterpart of ``pose3d_tpu/interop/torch_weights.py``'s
``vit_lifter_to_torch``, ``martinez_to_torch``, ``ae_to_torch``,
``resnet_to_torch``, ``posenet3d_to_torch``, ``posenet2d_to_torch`` and
``projection_to_torch``, and of ``pose_smpl_net_from_flax`` (the JAX
package has no export of ``PoseSMPLNet``), written with numpy alone
so that the port needs no JAX: a flax ``Dense`` kernel is (in, out) and a
torch ``Linear`` weight (out, in), so kernels are transposed; a flax
``Conv`` kernel is (kH, kW, in, out) and a torch ``Conv2d`` weight (out,
in, kH, kW); LayerNorm and BatchNorm scale/bias become weight/bias,
BatchNorm mean/var become running_mean/running_var.
"""

from __future__ import annotations

import numpy as np
import torch

from pose3d_tpu_torch.ops.stblock import _LAYOUT, SubBlockWeights


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))  # a writable C-order copy


def _dense(p, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _scale_bias(p, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _batch_norm(p, stats, prefix: str, sd: dict) -> None:
    """flax BatchNorm (scale/bias params, mean/var statistics) -> torch's
    weight, bias, running_mean, running_var and the num_batches_tracked
    counter, which ``load_state_dict(strict=True)`` needs."""
    _scale_bias(p, prefix, sd)
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def martinez_lifter_from_flax(params, batch_stats=None) -> dict[str, torch.Tensor]:
    """``MartinezLifter`` flax params and batch_stats -> the port's
    ``MartinezLifter`` state dict (reference ``LinearModel`` keys).

    | flax | port |
    | --- | --- |
    | ``Dense_0``, ``BatchNorm_0`` | ``w1``, ``batch_norm1`` |
    | ``MartinezBlock_{i}.Dense_0``, ``.BatchNorm_0`` | ``linear_stages.{i}.w1``, ``.batch_norm1`` |
    | ``MartinezBlock_{i}.Dense_1``, ``.BatchNorm_1`` | ``linear_stages.{i}.w2``, ``.batch_norm2`` |
    | ``Dense_1`` | ``w2`` |

    The stage count is read from the tree, and so is ``use_bn``: a tree
    without BatchNorm (``use_bn=False``) needs no ``batch_stats``.
    """
    sd: dict[str, torch.Tensor] = {}
    stats = batch_stats or {}
    _dense(params["Dense_0"], "w1", sd)
    if "BatchNorm_0" in params:
        _batch_norm(params["BatchNorm_0"], stats["BatchNorm_0"], "batch_norm1", sd)
    n_stages = sum(1 for k in params if k.startswith("MartinezBlock_"))
    for i in range(n_stages):
        bp, t = params[f"MartinezBlock_{i}"], f"linear_stages.{i}"
        for j in range(2):
            _dense(bp[f"Dense_{j}"], f"{t}.w{j + 1}", sd)
            if f"BatchNorm_{j}" in bp:
                _batch_norm(bp[f"BatchNorm_{j}"], stats[f"MartinezBlock_{i}"][f"BatchNorm_{j}"],
                            f"{t}.batch_norm{j + 1}", sd)
    _dense(params["Dense_1"], "w2", sd)
    return sd


# the AELifter's Dense_i / BatchNorm_i -> the reference AE's Sequential indices
_AE_LAYERS = (("encoder2.1", "encoder2.2"), ("encoder2.5", "encoder2.6"),
              ("decoder2.0", "decoder2.1"))


def ae_lifter_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``AELifter`` flax params and batch_stats -> the port's ``AELifter``
    state dict (reference ``AE`` keys): ``Dense_i`` / ``BatchNorm_i`` for
    i < 3 -> ``encoder2.1``/``.2``, ``encoder2.5``/``.6``,
    ``decoder2.0``/``.1``; ``Dense_3`` -> ``decoder2.4``."""
    sd: dict[str, torch.Tensor] = {}
    for i, (linear, bn) in enumerate(_AE_LAYERS):
        _dense(params[f"Dense_{i}"], linear, sd)
        _batch_norm(params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"], bn, sd)
    _dense(params["Dense_3"], "decoder2.4", sd)
    return sd


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


# SpatioTemporalBlock_{i} of the flax TemporalLifter -> blocks.{i} of the
# port's: the spatial half (LayerNorm_0, _MHSA_0, LayerNorm_1, _MLP_0),
# then the temporal half (LayerNorm_2, _MHSA_1, LayerNorm_3, _MLP_1), the
# order of pallas_stblock.pack_spatial_weights / pack_temporal_weights.
_ST_BLOCKS = ("SpatioTemporalBlock_", "CheckpointSpatioTemporalBlock_")  # remat=False / True
_ST_HALVES = (
    ("spatial", "LayerNorm_0", "_MHSA_0", "LayerNorm_1", "_MLP_0"),
    ("temporal", "LayerNorm_2", "_MHSA_1", "LayerNorm_3", "_MLP_1"),
)


def temporal_lifter_from_flax(params) -> dict[str, torch.Tensor]:
    """``TemporalLifter`` flax params (nested dicts of arrays) -> the port's
    ``models.temporal.TemporalLifter`` state dict.

    | flax | port |
    | --- | --- |
    | ``Dense_0`` | ``embed`` |
    | ``spatial_pe``, ``temporal_pe`` | the same names |
    | ``SpatioTemporalBlock_{i}.LayerNorm_0`` / ``_2`` | ``blocks.{i}.spatial_norm1`` / ``temporal_norm1`` |
    | ``.._MHSA_0`` / ``_1`` ``.Dense_0``, ``.Dense_1`` | ``blocks.{i}.spatial_attn`` / ``temporal_attn`` ``.qkv``, ``.proj`` |
    | ``..LayerNorm_1`` / ``_3`` | ``blocks.{i}.spatial_norm2`` / ``temporal_norm2`` |
    | ``.._MLP_0`` / ``_1`` ``.Dense_0``, ``.Dense_1`` | ``blocks.{i}.spatial_mlp`` / ``temporal_mlp`` ``.fc1``, ``.fc2`` |
    | ``LayerNorm_0`` | ``norm`` |
    | ``Dense_1``, ``Dense_2`` | ``head.0``, ``head.2`` |

    The block count is read from the tree; a tree built with ``remat=True``
    names its blocks ``CheckpointSpatioTemporalBlock_{i}``. A tree with no
    blocks raises ValueError.
    """
    sd: dict[str, torch.Tensor] = {}
    _dense(params["Dense_0"], "embed", sd)
    sd["spatial_pe"] = _t(params["spatial_pe"])
    sd["temporal_pe"] = _t(params["temporal_pe"])
    prefix = next((p for p in _ST_BLOCKS if f"{p}0" in params), None)
    if prefix is None:
        raise ValueError(f"no {' or '.join(p + '0' for p in _ST_BLOCKS)} in the tree")
    n_blocks = sum(1 for k in params if k.startswith(prefix))
    for i in range(n_blocks):
        bp = params[f"{prefix}{i}"]
        for half, ln1, att, ln2, mlp in _ST_HALVES:
            b = f"blocks.{i}.{half}"
            _scale_bias(bp[ln1], f"{b}_norm1", sd)
            _dense(bp[att]["Dense_0"], f"{b}_attn.qkv", sd)
            _dense(bp[att]["Dense_1"], f"{b}_attn.proj", sd)
            _scale_bias(bp[ln2], f"{b}_norm2", sd)
            _dense(bp[mlp]["Dense_0"], f"{b}_mlp.fc1", sd)
            _dense(bp[mlp]["Dense_1"], f"{b}_mlp.fc2", sd)
    _scale_bias(params["LayerNorm_0"], "norm", sd)
    _dense(params["Dense_1"], "head.0", sd)
    _dense(params["Dense_2"], "head.2", sd)
    return sd


def sub_block_from_jax(weights, dtype: torch.dtype = torch.float32):
    """The 12-tuple of ``pallas_stblock.pack_temporal_weights`` or
    ``pack_spatial_weights`` (numpy arrays; its ``(1, n)`` rows are
    flattened) -> ``ops.stblock.SubBlockWeights`` in ``dtype``: the
    kernels' flat operand, in the same order. Raises ValueError where the
    tuple does not follow the layout."""
    if len(weights) != len(_LAYOUT):
        raise ValueError(f"{len(weights)} arrays, the sub-block layout has {len(_LAYOUT)}")
    parts = []
    for a, (name, shape, _, _) in zip(weights, _LAYOUT):
        a = np.asarray(a, np.float32)
        if a.shape != shape and a.shape != (1, *shape):
            raise ValueError(f"{name}: shape {a.shape}, the layout takes {shape}")
        parts.append(a.reshape(-1))
    return SubBlockWeights(_t(np.concatenate(parts)).to(dtype))


def _conv(p, prefix: str, sd: dict) -> None:
    """flax Conv kernel (kH, kW, I, O) -> torch Conv2d weight (O, I, kH, kW)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv_transpose(p, prefix: str, sd: dict) -> None:
    """flax ConvTranspose kernel (kH, kW, I, O) -> torch ConvTranspose2d
    weight (I, O, kH, kW), spatially flipped: flax's ConvTranspose(4, 2,
    'SAME') is torch's ConvTranspose2d(4, 2, padding=1) only with the
    kernel flipped (``pose3d_tpu/interop/torch_weights.py`` ``_deconv``)."""
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)
    sd[f"{prefix}.weight"] = _t(w[:, :, ::-1, ::-1])


def resnet_from_flax(params, batch_stats, prefix: str = "") -> dict[str, torch.Tensor]:
    """``ResNet`` flax params and batch_stats -> the port's ``ResNet`` state
    dict (torchvision's keys), each key after ``prefix``.

    | flax | port |
    | --- | --- |
    | ``stem_conv``, ``stem_bn`` | ``conv1``, ``bn1`` |
    | ``stage{s}_block{i}.Conv_{k}``, ``.BatchNorm_{k}``, k < body | ``layer{s}.{i}.conv{k+1}``, ``.bn{k+1}`` |
    | ``stage{s}_block{i}.Conv_{body}``, ``.BatchNorm_{body}`` | ``layer{s}.{i}.downsample.0``, ``.downsample.1`` |

    ``body`` is 3 convolutions for a Bottleneck (whose first is 1x1) and 2
    for a BasicBlock (whose first is 3x3); a block with one more has the
    downsample. The blocks are read from the tree.
    """
    sd: dict[str, torch.Tensor] = {}
    _conv(params["stem_conv"], f"{prefix}conv1", sd)
    _batch_norm(params["stem_bn"], batch_stats["stem_bn"], f"{prefix}bn1", sd)
    for name in (k for k in params if "_block" in k):
        stage, idx = name.removeprefix("stage").split("_block")
        bp, bs = params[name], batch_stats[name]
        t = f"{prefix}layer{stage}.{idx}"
        body = 2 if np.asarray(bp["Conv_0"]["kernel"]).shape[0] == 3 else 3
        for k in range(body):
            _conv(bp[f"Conv_{k}"], f"{t}.conv{k + 1}", sd)
            _batch_norm(bp[f"BatchNorm_{k}"], bs[f"BatchNorm_{k}"], f"{t}.bn{k + 1}", sd)
        if f"Conv_{body}" in bp:
            _conv(bp[f"Conv_{body}"], f"{t}.downsample.0", sd)
            _batch_norm(bp[f"BatchNorm_{body}"], bs[f"BatchNorm_{body}"],
                        f"{t}.downsample.1", sd)
    return sd


def posenet3d_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``PoseNet3D`` flax params and batch_stats -> the port's
    ``PoseNet3D`` state dict (the reference ``Model_3D`` keys).

    | flax | port |
    | --- | --- |
    | ``backbone`` | ``preact.`` + ``resnet_from_flax`` |
    | ``head.ConvTranspose_{i}``, i = 0, 1, 2 | ``deconv_layers.{0,3,6}`` (kernel flipped) |
    | ``head.BatchNorm_{i}`` | ``deconv_layers.{1,4,7}`` |
    | ``head.Conv_0`` | ``final_layer`` |
    """
    sd = resnet_from_flax(params["backbone"], batch_stats["backbone"], prefix="preact.")
    hp, hs = params["head"], batch_stats["head"]
    n_deconv = sum(1 for k in hp if k.startswith("ConvTranspose_"))
    for i in range(n_deconv):
        _conv_transpose(hp[f"ConvTranspose_{i}"], f"deconv_layers.{3 * i}", sd)
        _batch_norm(hp[f"BatchNorm_{i}"], hs[f"BatchNorm_{i}"], f"deconv_layers.{3 * i + 1}", sd)
    _conv(hp["Conv_0"], "final_layer", sd)
    return sd


def posenet2d_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``PoseNet2D`` flax params and batch_stats -> the port's ``PoseNet2D``
    state dict (the reference ``Model_2D`` keys): the tree and the keys are
    ``PoseNet3D``'s, with a J-channel final conv (``posenet3d_from_flax``)."""
    return posenet3d_from_flax(params, batch_stats)


# ProjectionMLP's Dense_i / BatchNorm_i -> the reference Projection's
# Sequential indices (0 Flatten; Linear, BatchNorm, Tanh, Dropout x 3; 13 Linear)
_PROJECTION_LAYERS = (("mlp.1", "mlp.2"), ("mlp.5", "mlp.6"), ("mlp.9", "mlp.10"))


def projection_mlp_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``ProjectionMLP`` flax params and batch_stats -> the port's
    ``ProjectionMLP`` state dict (reference ``Projection`` keys):
    ``Dense_i`` / ``BatchNorm_i`` for i < 3 -> ``mlp.1``/``.2``,
    ``mlp.5``/``.6``, ``mlp.9``/``.10``; ``Dense_3`` -> ``mlp.13``."""
    sd: dict[str, torch.Tensor] = {}
    for i, (linear, bn) in enumerate(_PROJECTION_LAYERS):
        _dense(params[f"Dense_{i}"], linear, sd)
        _batch_norm(params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"], bn, sd)
    _dense(params["Dense_3"], "mlp.13", sd)
    return sd


def pose_smpl_net_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """``PoseSMPLNet`` flax params and batch_stats -> the port's
    ``PoseSMPLNet`` state dict (the reference ``Simple3DPoseBaseSMPL``
    keys): ``backbone`` and ``head`` as ``posenet3d_from_flax`` maps them
    (``preact.``, ``deconv_layers.{3i, 3i+1}``, ``final_layer``, here to 29
    x 64 channels), and the Dense layers ``fc1``, ``fc2``, ``decshape`` and
    ``decphi`` to the Linear layers of the same names, kernels transposed."""
    sd = posenet3d_from_flax(params, batch_stats)
    for name in ("fc1", "fc2", "decshape", "decphi"):
        _dense(params[name], name, sd)
    return sd
