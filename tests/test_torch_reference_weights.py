"""The reference-checkpoint bridge of the port
(``pose3d_tpu_torch/interop/torch_weights.py``) against the JAX
package's (``pose3d_tpu/interop/torch_weights.py``), for the seven model
families, on seeded flax variables v (biases, scales and BatchNorm
statistics drawn, not the init's zeros and ones):

- ``X_from_torch(JAX X_to_torch(v))`` is ``X_from_flax(v)`` bit for bit,
  with equal key sets, and the port's model of the family loads it with
  ``strict=True``;
- the port's ``X_to_torch(X_from_flax(v))`` is JAX's ``X_to_torch(v)`` bit
  for bit, with equal key sets;
- keys of the reference module that the family does not use (a
  classifier ``fc``, ``Model_3D``'s camera-embedding MLP, the AE's dead
  branches) are left out; a missing key raises KeyError.
"""

import numpy as np
import pytest
import torch

from torch_port_util import flax_bn_lifter, flax_posenet, flax_posenet2d, flax_vit

from pose3d_tpu_torch.interop import torch_weights as TW
from pose3d_tpu_torch.interop import weights as W

torch.set_num_threads(2)

FAMILIES = ("martinez", "ae", "vit_lifter", "projection", "resnet", "posenet3d", "posenet2d")


def _flax_projection():
    import jax

    from pose3d_tpu.models.heads import ProjectionMLP
    from torch_port_util import _seeded_norms

    model = ProjectionMLP()
    v = jax.jit(lambda k: model.init({"params": k}, np.zeros((1, 17, 3), np.float32),
                                     train=False))(jax.random.key(0))
    rng = np.random.default_rng(9)
    return (_seeded_norms(jax.tree.map(np.asarray, v["params"]), rng, False),
            _seeded_norms(jax.tree.map(np.asarray, v["batch_stats"]), rng, True))


def _family(name):
    """(JAX variables, JAX's X_to_torch, the port's X_from_flax of them,
    the port's model, keyword arguments of both X_*_torch)."""
    from pose3d_tpu.interop import torch_weights as JW

    from pose3d_tpu_torch.models import heads, lifters, resnet

    if name in ("martinez", "ae"):
        _, p, s = flax_bn_lifter(name)
        bridge = W.martinez_lifter_from_flax if name == "martinez" else W.ae_lifter_from_flax
        cls = lifters.MartinezLifter if name == "martinez" else lifters.AELifter
        kw = {"num_stages": 2} if name == "martinez" else {}
        return ({"params": p, "batch_stats": s}, getattr(JW, f"{name}_to_torch"),
                bridge(p, s), cls(device="cpu"), kw)
    if name == "vit_lifter":
        _, p = flax_vit(seed=1, n_blocks=2)
        return ({"params": p}, JW.vit_lifter_to_torch, W.vit_lifter_from_flax(p),
                lifters.JointTransformerLifter(n_blocks=2, device="cpu"), {"n_blocks": 2})
    if name == "projection":
        p, s = _flax_projection()
        return ({"params": p, "batch_stats": s}, JW.projection_to_torch,
                W.projection_mlp_from_flax(p, s), heads.ProjectionMLP(device="cpu"), {})
    if name == "resnet":
        p, s = flax_posenet()
        p, s = p["backbone"], s["backbone"]
        return ({"params": p, "batch_stats": s}, JW.resnet_to_torch, W.resnet_from_flax(p, s),
                resnet.ResNet("resnet18", device="cpu"), {})
    p, s = flax_posenet() if name == "posenet3d" else flax_posenet2d()
    bridge = W.posenet3d_from_flax if name == "posenet3d" else W.posenet2d_from_flax
    cls = heads.PoseNet3D if name == "posenet3d" else heads.PoseNet2D
    return ({"params": p, "batch_stats": s}, getattr(JW, f"{name}_to_torch"), bridge(p, s),
            cls("resnet18", device="cpu"), {})


def _same(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, w in want.items():
        w = w if torch.is_tensor(w) else torch.from_numpy(np.array(w))  # 0-d stays 0-d
        g = got[k]
        assert torch.is_tensor(g) and g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert g.reshape(-1).view(torch.uint8).equal(w.reshape(-1).view(torch.uint8)), (what, k)


@pytest.mark.parametrize("name", FAMILIES)
def test_from_torch_reads_jax_export(name):
    variables, jax_to_torch, from_flax, model, kw = _family(name)
    reference = jax_to_torch(variables, **kw)
    got = getattr(TW, f"{name}_from_torch")(reference, **kw)
    _same(got, from_flax, f"{name}_from_torch")
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", FAMILIES)
def test_to_torch_is_jax_export(name):
    variables, jax_to_torch, from_flax, _, kw = _family(name)
    _same(getattr(TW, f"{name}_to_torch")(from_flax, **kw), jax_to_torch(variables, **kw),
          f"{name}_to_torch")


def test_unused_reference_keys_are_left_out():
    from pose3d_tpu.interop import torch_weights as JW

    p, s = flax_posenet()
    reference = JW.posenet3d_to_torch({"params": p, "batch_stats": s})
    extra = {"preact.fc.weight": np.zeros((10, 512), np.float32),
             "cam_mlp.0.weight": np.zeros((4, 4), np.float32)}
    got = TW.posenet3d_from_torch({**reference, **extra})
    assert not set(extra) & set(got)
    resnet = TW.resnet_from_torch({**reference, **extra}, prefix="preact.")
    assert "fc.weight" not in resnet and "conv1.weight" in resnet
    _, lp, ls = flax_bn_lifter("ae")
    ae = JW.ae_to_torch({"params": lp, "batch_stats": ls})
    got = TW.ae_from_torch({**ae, "encoder.1.weight": np.zeros((2, 2), np.float32)})
    assert "encoder.1.weight" not in got
    with pytest.raises(KeyError):
        TW.martinez_from_torch(ae)
    with pytest.raises(KeyError, match="no ResNet"):
        TW.resnet_from_torch(ae)
