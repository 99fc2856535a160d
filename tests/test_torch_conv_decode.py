"""The fused 1x1-conv + soft-argmax decode's wrapper and plain version
(``pose3d_tpu_torch/ops/conv_decode.py``) against the JAX package's
``conv_soft_argmax_3d_fused`` (Pallas in interpret mode), at the shapes
of ``tests/test_pallas_conv_decode.py``: B = 2, 8 x 8 pixels, C = 128,
D = 64, J in {17, 4, 3}.

The JAX function takes the conv kernel (C, J*D); the port takes torch's
(J*D, C) weight, its transpose. Tolerances:

- f32: atol 2e-5, the JAX suite's (f32 products summed in another order;
  measured up to 6.0e-7 on coordinates that spread with std >= 0.23);
- bf16 features, weight and bias (the bias rounded to bf16 first, as
  ``heads.py`` rounds it in a bf16 model): atol 2e-5 as well, since both
  sides multiply the same bf16 values exactly and sum in f32 (measured up
  to 5.7e-6); the JAX suite's own bf16 budget against its unfused oracle
  is 5e-2;
- a bias offset of +150 on every channel (logits past exp's f32 range
  without the maximum subtracted) moves f32 coordinates by at most 2e-5
  (measured 3.0e-6).

Tests marked ``cuda`` run the Hopper kernel (C = 256, D = 64) against its
plain version and skip without a card: coordinates within 1e-3, two
calls bitwise equal.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.ops import conv_decode as CD

torch.set_num_threads(2)

ATOL = 2e-5
KERNEL_ATOL = 1e-3


def _operands(b, h, w, c, j, d, seed=0, bias_offset=0.0):
    """numpy (feats (B, H, W, C), kernel (C, J*D), bias (J*D,)) f32, drawn
    as the JAX suite's ``_setup`` draws them but with a kernel of scale
    4 / sqrt(C), not 0.05, so that the logits (std ~4) peak and the
    coordinates spread."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kernel = (rng.standard_normal((c, j * d)) * 4 * c ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(j * d) * 0.1 + bias_offset).astype(np.float32)
    return feats, kernel, bias


def _jax_fused(feats, kernel, bias, j, d, dtype):
    import jax.numpy as jnp

    from pose3d_tpu.ops.pallas_conv_decode import conv_soft_argmax_3d_fused

    dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return np.asarray(conv_soft_argmax_3d_fused(
        jnp.asarray(feats, dt), jnp.asarray(kernel, dt), jnp.asarray(bias, dt),
        num_joints=j, depth=d, interpret=True))


def _port(feats, kernel, bias, dtype, device="cpu"):
    """numpy operands -> the port's (feats, weight (J*D, C), bias) in dtype."""
    dt = getattr(torch, dtype)
    return (torch.from_numpy(feats).to(device, dt),
            torch.from_numpy(kernel.T.copy()).to(device, dt),
            torch.from_numpy(bias).to(device, dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [17, 4, 3])
def test_plain_matches_jax_kernel(j, dtype):
    ops = _operands(2, 8, 8, 128, j, 64, seed=j)
    want = _jax_fused(*ops, j, 64, dtype)
    got = CD.conv_soft_argmax_3d_fused(*_port(*ops, dtype), num_joints=j, depth=64)
    assert got.dtype == torch.float32 and got.shape == (2, j * 3)
    assert got.std() >= 0.1  # coordinates that spread: the comparison is not vacuous
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert torch.equal(got, CD.conv_soft_argmax_3d_reference(*_port(*ops, dtype), j, 64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_large_logits_keep_the_coordinates(dtype):
    """+150 on every bias: the softmax is shift-invariant, so the
    coordinates stay; the JAX kernel agrees (its pad joint included)."""
    base = _operands(2, 8, 8, 128, 17, 64, seed=5)
    shifted = _operands(2, 8, 8, 128, 17, 64, seed=5, bias_offset=150.0)
    got = CD.conv_soft_argmax_3d_fused(*_port(*shifted, dtype))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), _jax_fused(*shifted, 17, 64, dtype), atol=ATOL,
                               rtol=0)
    if dtype == "float32":  # bf16 rounds the shifted bias to other steps
        np.testing.assert_allclose(got.numpy(), CD.conv_soft_argmax_3d_fused(
            *_port(*base, dtype)).numpy(), atol=ATOL, rtol=0)


def test_plain_equals_the_unfused_head():
    """The fused decode is ``soft_argmax_3d_nhwc`` of the 1x1 conv's
    logits, the unfused head of PoseNet3D."""
    from pose3d_tpu_torch.ops.heatmap import soft_argmax_3d_nhwc

    feats, kernel, bias = _port(*_operands(2, 6, 5, 32, 3, 8, seed=7), "float32")
    conv = torch.nn.Conv2d(32, 24, 1)
    with torch.no_grad():
        conv.weight.copy_(kernel[:, :, None, None])
        conv.bias.copy_(bias)
        logits = conv(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        want = soft_argmax_3d_nhwc(logits, 3, 8)
    got = CD.conv_soft_argmax_3d_fused(feats, kernel, bias, 3, 8)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


class TestWrapperRules:
    def test_rejects_bad_operands(self):
        feats, kernel, bias = _port(*_operands(1, 4, 4, 16, 2, 8), "float32")
        with pytest.raises(ValueError, match="weight must be"):
            CD.conv_soft_argmax_3d_fused(feats, kernel[:8], bias, 2, 8)
        with pytest.raises(ValueError, match="bias must be"):
            CD.conv_soft_argmax_3d_fused(feats, kernel, bias[:8], 2, 8)
        with pytest.raises(ValueError, match="feats must be"):
            CD.conv_soft_argmax_3d_fused(feats[0], kernel, bias, 2, 8)

    def test_refuses_grad_and_other_devices(self):
        feats, kernel, bias = _port(*_operands(1, 4, 4, 16, 2, 8), "float32")
        kernel.requires_grad_()
        with pytest.raises(ValueError, match="no backward yet"):
            CD.conv_soft_argmax_3d_fused(feats, kernel, bias, 2, 8)
        with torch.no_grad():
            assert CD.conv_soft_argmax_3d_fused(feats, kernel, bias, 2, 8).shape == (1, 6)
        meta = [t.detach().to("meta") for t in (feats, kernel, bias)]
        with pytest.raises(ValueError, match="no conv-decode kernel for device meta"):
            CD.conv_soft_argmax_3d_fused(*meta, 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 17), (3, 13, 11, 3), (2, 64, 64, 17)])
def test_kernel_matches_plain_version_on_the_card(shape):
    """C = 256, D = 64, bf16: coordinates within 1e-3 of the plain version
    (143 pixels: a ragged second tile; +150 on the bias), two calls
    bitwise equal, one count per call."""
    dev = cuda_device()
    b, h, w, j = shape
    feats, weight, bias = _port(*_operands(b, h, w, 256, j, 64, seed=11, bias_offset=150.0),
                                "bfloat16", dev)
    bias = bias.float()
    before = CD.conv_soft_argmax_3d_fused.launches
    got = CD.conv_soft_argmax_3d_fused(feats, weight, bias, j, 64)
    again = CD.conv_soft_argmax_3d_fused(feats, weight, bias, j, 64)
    torch.cuda.synchronize()
    assert CD.conv_soft_argmax_3d_fused.launches == before + 2
    want = CD.conv_soft_argmax_3d_reference(feats, weight, bias, j, 64)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_rejects_f32_operands_and_other_widths():
    dev = cuda_device()
    feats, weight, bias = _port(*_operands(1, 8, 8, 256, 2, 64), "float32", dev)
    with pytest.raises(TypeError, match="bfloat16"):
        CD.conv_soft_argmax_3d_fused(feats, weight, bias, 2, 64)
    feats, weight, bias = _port(*_operands(1, 8, 8, 128, 2, 64), "bfloat16", dev)
    with pytest.raises(ValueError, match="256 features"):
        CD.conv_soft_argmax_3d_fused(feats, weight, bias.float(), 2, 64)
