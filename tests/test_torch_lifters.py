"""The port's JointTransformerLifter and weight bridge against the JAX package.

Same seeded inputs and flax-initialised weights through the flax module
and the port's ``nn.Module``. Tolerance 1e-4 in f32: both sides compute
exact GELU and a max-subtracted softmax, so what differs is the order of
f32 sums (measured 3e-6 at the default width, outputs up to ~1.2).
"""

import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import flax_vit, torch_vit

pytest.importorskip("jax")
torch.set_num_threads(2)

F32_ATOL = 1e-4

CONFIGS = {
    "default": {},
    "narrow": {"hidden": 64, "n_blocks": 1, "heads": 2},
    "class_token": {"hidden": 64, "n_blocks": 1, "heads": 2,
                    "class_token": True},
    "projector": {"in_dim": 3, "out_dim": 2, "hidden": 64, "n_blocks": 1,
                  "heads": 2},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_module_matches_flax_f32(name):
    fields = CONFIGS[name]
    fmodel, params = flax_vit(seed=0, **fields)
    tmodel = torch_vit(params, **fields)
    in_dim = fields.get("in_dim", 2)
    x = np.random.default_rng(7).random((32, 17, in_dim)).astype(np.float32)
    want = np.asarray(fmodel.apply({"params": params}, x, train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (32, 17, fields.get("out_dim", 3))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


def test_bf16_module_close_to_flax_bf16():
    """At bf16 both sides round at other places (bias fused into the
    matmul here, added after it in flax): the JAX package's bf16 budget."""
    import jax.numpy as jnp

    from pose3d_tpu.models.lifters import JointTransformerLifter

    _, params = flax_vit(seed=0)
    x = np.random.default_rng(7).random((32, 17, 2)).astype(np.float32)
    want = np.asarray(JointTransformerLifter(dtype=jnp.bfloat16).apply(
        {"params": params}, x, train=False))
    with torch.no_grad():
        got = torch_vit(params, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2, rtol=0)


def test_weights_equal_the_jax_package_export():
    """vit_lifter_from_flax == interop.torch_weights.vit_lifter_to_torch,
    key for key and bit for bit, and the port's module takes it strictly."""
    from pose3d_tpu.interop.torch_weights import vit_lifter_to_torch

    from pose3d_tpu_torch.interop.weights import vit_lifter_from_flax
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter

    _, params = flax_vit(seed=3)
    got = vit_lifter_from_flax(params)
    want = vit_lifter_to_torch({"params": params})
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].is_contiguous()
    model = JointTransformerLifter(device="cpu")
    model.load_state_dict(got, strict=True)
    assert set(model.state_dict()) == set(want)


def test_class_token_crosses_the_bridge():
    from pose3d_tpu_torch.interop.weights import vit_lifter_from_flax

    _, params = flax_vit(seed=1, **CONFIGS["class_token"])
    sd = vit_lifter_from_flax(params)
    np.testing.assert_array_equal(sd["cls_token"].numpy(), params["cls_token"])


def test_positional_embedding_copy_is_exact():
    from pose3d_tpu.models.lifters import sinusoidal_positional_embeddings as jax_pe

    from pose3d_tpu_torch.models.lifters import sinusoidal_positional_embeddings

    for seq, d in ((17, 256), (18, 64), (243, 512)):
        np.testing.assert_array_equal(sinusoidal_positional_embeddings(seq, d),
                                      jax_pe(seq, d))


def test_parity_hazards_pinned():
    """eps 1e-5 everywhere, bias-free qkv/out, exact GELU, the double LN,
    and a fixed PE that is not part of the state dict."""
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter

    model = JointTransformerLifter(class_token=True, device="cpu")
    norms = [m for m in model.modules() if isinstance(m, nn.LayerNorm)]
    assert len(norms) == 3 * model.n_blocks
    assert all(m.eps == 1e-5 for m in norms)
    for block in model.blocks:
        assert block.mhsa.to_qkv.bias is None
        assert block.mhsa.to_out.bias is None
        assert isinstance(block.mhsa.norm, nn.LayerNorm)
        assert block.mlp[1].approximate == "none"
    assert "pe" not in model.state_dict()
    assert model.pe.shape == (18, 256)
    assert not model.pe.requires_grad


def test_init_weights_is_seeded():
    from pose3d_tpu_torch.models.lifters import JointTransformerLifter

    def draw(seed):
        model = JointTransformerLifter(device="cpu")
        return model.init_weights(torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = draw(5), draw(5), draw(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.mlp.0.bias"], c["blocks.0.mlp.0.bias"])
