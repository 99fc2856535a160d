"""Shared set-up of the port's tests (``tests/test_torch_*.py``).

The port's tests feed one set of seeded numpy inputs and weights to the
JAX package and to ``pose3d_tpu_torch`` and compare the outputs. JAX is
imported only inside the helpers that need it, so the files that hold
the tests which need a GPU also import where JAX is absent (run them
there with ``--noconftest``; ``tests/conftest.py`` imports JAX).
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import pytest
import torch


def flax_vit(seed: int = 0, **fields):
    """(flax JointTransformerLifter, its params as numpy) at ``fields``."""
    jax = pytest.importorskip("jax")
    from pose3d_tpu.models.lifters import JointTransformerLifter

    model = JointTransformerLifter(**fields)
    x = np.zeros((1, fields.get("n_joints", 17), fields.get("in_dim", 2)),
                 np.float32)
    params = model.init({"params": jax.random.key(seed)}, x, train=False)["params"]
    return model, jax.tree.map(np.asarray, params)


def torch_vit(params, dtype=torch.float32, device="cpu", **fields):
    """The port's JointTransformerLifter at ``fields``, holding ``params``."""
    from pose3d_tpu_torch.interop.weights import vit_lifter_from_flax
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter

    model = JointTransformerLifter(**fields, device=device, dtype=dtype)
    model.load_state_dict(vit_lifter_from_flax(params), strict=True)
    return model.eval()


def flax_temporal(seed: int = 0, **fields):
    """(flax TemporalLifter, its params as numpy) at ``fields``."""
    jax = pytest.importorskip("jax")
    from pose3d_tpu.models.temporal import TemporalLifter

    model = TemporalLifter(**fields)
    x = np.zeros((1, fields.get("clip_len", 243), fields.get("n_joints", 17),
                  fields.get("in_dim", 2)), np.float32)
    # jitted: one compile instead of an eager dispatch per op (~5x faster)
    params = jax.jit(model.init)({"params": jax.random.key(seed)}, x)["params"]
    return model, jax.tree.map(np.asarray, params)


@functools.cache
def _jitted_apply(model):
    import jax

    return jax.jit(lambda variables, x: model.apply(variables, x))


def flax_apply(model, params, x, batch_stats=None) -> np.ndarray:
    """``model.apply`` (inference) under one jit per flax module (modules
    hash by their fields), as numpy."""
    variables = {"params": params}
    if batch_stats:
        variables["batch_stats"] = batch_stats
    return np.asarray(_jitted_apply(model)(variables, x))


def _seeded_norms(tree, rng, stats: bool):
    """A copy of a flax params (or batch_stats) tree whose biases, BN
    scales (or BN means and variances) are drawn from ``rng``: biases and
    means N(0, 0.1), scales 1 + N(0, 0.1), variances U(0.5, 1.5). The init's
    zeros and ones would hide a bias, scale or statistic read from the
    wrong place."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _seeded_norms(v, rng, stats)
        elif k in ("bias", "mean"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "scale":
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "var":
            out[k] = (0.5 + rng.random(v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def flax_bn_lifter(kind: str, seed: int = 0, **fields):
    """(flax MartinezLifter or AELifter, params, batch_stats) at
    ``fields``, as numpy, with seeded biases, BN scales and statistics."""
    jax = pytest.importorskip("jax")
    from pose3d_tpu.models.lifters import AELifter, MartinezLifter

    model = {"martinez": MartinezLifter, "ae": AELifter}[kind](**fields)
    x = np.zeros((1, fields.get("in_dim", 34)), np.float32)
    variables = jax.jit(lambda k: model.init({"params": k}, x, train=False))(
        jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    params = _seeded_norms(jax.tree.map(np.asarray, variables["params"]), rng, False)
    stats = _seeded_norms(jax.tree.map(np.asarray, variables.get("batch_stats", {})),
                          rng, True)
    return model, params, stats


def torch_bn_lifter(kind: str, params, batch_stats, dtype=torch.float32, device="cpu",
                    **fields):
    """The port's MartinezLifter or AELifter at ``fields``, holding the flax
    ``params`` and ``batch_stats``."""
    from pose3d_tpu_torch.interop import weights
    from pose3d_tpu_torch.models.lifters import AELifter, MartinezLifter

    cls, bridge = {"martinez": (MartinezLifter, weights.martinez_lifter_from_flax),
                   "ae": (AELifter, weights.ae_lifter_from_flax)}[kind]
    model = cls(**fields, device=device, dtype=dtype)
    model.load_state_dict(bridge(params, batch_stats), strict=True)
    return model.eval()


def torch_temporal(params, dtype=torch.float32, device="cpu", **fields):
    """The port's TemporalLifter at ``fields``, holding ``params``."""
    from pose3d_tpu_torch.interop.weights import temporal_lifter_from_flax
    from pose3d_tpu_torch.models.temporal import TemporalLifter

    model = TemporalLifter(**fields, device=device, dtype=dtype)
    model.load_state_dict(temporal_lifter_from_flax(params), strict=True)
    return model.eval()


def _seeded_image_model(model, seed: int, final_scale: float):
    """(params, batch_stats) of a flax image model at 64 x 64, as numpy:
    biases, BN scales and BN statistics seeded (``_seeded_norms``), the
    head's final 1x1 conv kernel scaled by ``final_scale``."""
    jax = pytest.importorskip("jax")

    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = jax.jit(lambda k: model.init({"params": k}, x, train=False))(
        jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)
    params = _seeded_norms(jax.tree.map(np.asarray, variables["params"]), rng, False)
    stats = _seeded_norms(jax.tree.map(np.asarray, variables["batch_stats"]), rng, True)
    params["head"]["Conv_0"]["kernel"] = params["head"]["Conv_0"]["kernel"] * final_scale
    return params, stats


@functools.cache
def flax_posenet(architecture: str = "resnet18", seed: int = 0, final_scale: float = 32.0,
                 depth: int = 64):
    """(params, batch_stats) of a flax ``PoseNet3D`` (17 joints, volume depth
    ``depth``), as numpy, cached per process (``_seeded_image_model``): the
    final conv scaled so that the coordinates spread (at the init's scale
    the heatmaps are near uniform and every coordinate sits near -1/32).
    Callers must not modify the trees."""
    pytest.importorskip("jax")
    from pose3d_tpu.models.heads import PoseNet3D

    return _seeded_image_model(PoseNet3D(architecture=architecture, depth=depth), seed,
                               final_scale)


@functools.cache
def flax_posenet2d(architecture: str = "resnet18", seed: int = 0, final_scale: float = 256.0):
    """(params, batch_stats) of a flax ``PoseNet2D`` (17 joints), as numpy,
    cached per process (``_seeded_image_model``): at the init's scale
    every coordinate sits within ~2e-3 of 0.47 on 64 x 64 frames; x256 on
    the final conv spreads them. Callers must not modify the trees."""
    pytest.importorskip("jax")
    from pose3d_tpu.models.heads import PoseNet2D

    return _seeded_image_model(PoseNet2D(architecture=architecture), seed, final_scale)


def torch_posenet2d(params, batch_stats, dtype=torch.float32, device="cpu", **fields):
    """The port's PoseNet2D at ``fields``, holding the flax ``params`` and
    ``batch_stats``, in eval mode."""
    from pose3d_tpu_torch.interop.weights import posenet2d_from_flax
    from pose3d_tpu_torch.models.heads import PoseNet2D

    model = PoseNet2D(**fields, device=device, dtype=dtype)
    model.load_state_dict(posenet2d_from_flax(params, batch_stats), strict=True)
    return model.eval()


@functools.cache
def flax_pose_smpl_net(architecture: str = "resnet18", seed: int = 0, final_scale: float = 64.0,
                       depth: int = 8):
    """(params, batch_stats) of a flax ``PoseSMPLNet`` (29 joints, volume
    depth ``depth``), as numpy, cached per process
    (``_seeded_image_model``): at the init's scale the uvd sit within ~0.1
    of 0 (std 0.015 at ResNet-18, 64 x 64, depth 8); x64 on the final conv
    spreads them (std 0.13). Callers must not modify the trees."""
    pytest.importorskip("jax")
    from pose3d_tpu.models.smpl_pose import PoseSMPLNet

    return _seeded_image_model(PoseSMPLNet(architecture=architecture, depth=depth), seed,
                               final_scale)


def torch_pose_smpl_net(params, batch_stats, dtype=torch.float32, device="cpu", **fields):
    """The port's PoseSMPLNet at ``fields``, holding the flax ``params`` and
    ``batch_stats``, in eval mode."""
    from pose3d_tpu_torch.interop.weights import pose_smpl_net_from_flax
    from pose3d_tpu_torch.models.smpl_pose import PoseSMPLNet

    model = PoseSMPLNet(**fields, device=device, dtype=dtype)
    model.load_state_dict(pose_smpl_net_from_flax(params, batch_stats), strict=True)
    return model.eval()


def flax_posenet_apply(model, params, batch_stats, x):
    """A flax PoseNet3D's inference under one jit per module: (coords,
    heatmap or None) as numpy."""
    coords, heatmap = _jitted_apply(model)({"params": params, "batch_stats": batch_stats}, x)
    return np.asarray(coords), None if heatmap is None else np.asarray(heatmap)


def torch_posenet(params, batch_stats, dtype=torch.float32, device="cpu", **fields):
    """The port's PoseNet3D at ``fields``, holding the flax ``params`` and
    ``batch_stats``, in eval mode."""
    from pose3d_tpu_torch.interop.weights import posenet3d_from_flax
    from pose3d_tpu_torch.models.heads import PoseNet3D

    model = PoseNet3D(**fields, device=device, dtype=dtype)
    model.load_state_dict(posenet3d_from_flax(params, batch_stats), strict=True)
    return model.eval()


H36M_CAM_SUFFIXES = (".54138969", ".55011271", ".58860488", ".60457274")


def write_fake_h36m(root, frames: dict, rng) -> dict:
    """A fabricated Human3.6M export in the VideoPose3D schema under
    ``root/npz`` (the pattern of ``tests/test_h36m_reader.py``'s
    ``fake_h36m``): ``frames`` maps (subject, action) to a frame count;
    each gets a world-frame 3D pose (``data_3d_h36m.npz``), a camera-frame
    one (``data_3d_h36m_mono.npz``) and 2D keypoints for the mono file and
    each of the four cameras (``data_2d_h36m.npz``), all 32 joints,
    float32, seeded from ``rng``. Returns {"pos3d", "pos3d_mono",
    "pos2d"}, the nested dicts written."""
    npz = pathlib.Path(root) / "npz"
    npz.mkdir(parents=True, exist_ok=True)
    out = {"pos3d": {}, "pos3d_mono": {}, "pos2d": {}}
    for (s, a), n in frames.items():
        for d in out.values():
            d.setdefault(s, {})
        out["pos3d"][s][a] = rng.standard_normal((n, 32, 3)).astype(np.float32)
        out["pos3d_mono"][s][a] = rng.standard_normal((n, 32, 3)).astype(np.float32)
        out["pos2d"][s][a] = rng.random((n, 32, 2)).astype(np.float32)
        for c in H36M_CAM_SUFFIXES:
            out["pos2d"][s][a + c] = rng.random((n, 32, 2)).astype(np.float32)
    np.savez(npz / "data_3d_h36m.npz", positions_3d=out["pos3d"])
    np.savez(npz / "data_3d_h36m_mono.npz", positions_3d_mono=out["pos3d_mono"])
    np.savez(npz / "data_2d_h36m.npz", positions_2d=out["pos2d"])
    return out


def cuda_device() -> torch.device:
    """The first CUDA device; skips the calling test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)
