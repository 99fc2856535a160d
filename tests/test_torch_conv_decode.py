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

The backward (kernel 13b; on the CPU the autograd Function runs its plain
version ``conv_soft_argmax_3d_backward_reference``) against ``jax.vjp`` of
the Pallas function in interpret mode, J in {1, 3, 17}, +100 on the bias
(logits ~100; the coordinates' spread, std >= 0.1, is asserted):

- f32 dfeats, dW and db: atol 2^-16·max|want| each (f32 products and sums
  in another order; measured up to 1.0e-6·max|want|);
- bf16: the port's products take dslab rounded to bf16, the JAX
  interpret-mode kernel keeps it f32, so dfeats and dW are held to
  2^-7·max|want| + 2^-7·|want| (measured up to 6.1e-3·max|want|); db,
  summed unrounded by both, to 2^-16·max|want| + 2^-7·|want| (the port
  returns it f32 for a bias handed in f32, the JAX kernel in bf16);
- the plain backward against torch.autograd of the plain forward: float64
  atol 1e-12; its bf16 form equals the f32 pieces rounded at the products.

Tests marked ``cuda`` run the Hopper kernels (C = 256, D = 64) against
their plain versions and skip without a card: coordinates within 1e-3,
gradients within 2^-7·max|want| + 2^-7·|want| (both round dslab to bf16,
from f32 values computed in another order), two calls bitwise equal.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.ops import conv_decode as CD
from pose3d_tpu_torch.ops.heatmap import nhwc_expectations
from pose3d_tpu_torch.ops.softargmax import soft_argmax_3d_nhwc_backward_reference

torch.set_num_threads(2)

ATOL = 2e-5
KERNEL_ATOL = 1e-3
MIN_SPREAD = 0.1
GRAD_REL = 2 ** -7  # bf16 dslab rounded at the products: a bf16 step


def assert_grad_close(got, want, atol_rel, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=atol_rel * np.abs(want).max(), rtol=rtol,
                               err_msg=what)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [17, 3, 1])
def test_backward_matches_jax_vjp(j, dtype):
    """(dfeats, dW, db) of the wrapper (its autograd Function, the plain
    backward on the CPU) vs ``jax.vjp`` of the Pallas function in
    interpret mode (``_bwd_kernel``). In bf16 the port's bias is the bf16
    bias in f32, as ``PoseNet3D`` hands it over."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.ops.pallas_conv_decode import conv_soft_argmax_3d_fused

    ops = _operands(2, 8, 8, 128, j, 64, seed=j, bias_offset=100.0)
    ct = np.random.default_rng(j + 2).standard_normal((2, j * 3)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    _, vjp = jax.vjp(lambda f, k, b: conv_soft_argmax_3d_fused(f, k, b, j, 64, interpret=True),
                     *(jnp.asarray(a, jdt) for a in ops))
    want = [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(ct))]
    want[1] = want[1].T  # (C, J*D) kernel -> (J*D, C) weight
    feats, weight, bias = (t.requires_grad_() for t in _port(*ops, dtype))
    coords = CD.conv_soft_argmax_3d_fused(feats, weight, bias.float(), j, 64)
    coords.backward(torch.from_numpy(ct))
    assert coords.std() >= MIN_SPREAD
    bf16 = dtype == "bfloat16"
    for name, t, w, rel in (("dfeats", feats, want[0], GRAD_REL if bf16 else 2 ** -16),
                            ("dW", weight, want[1], GRAD_REL if bf16 else 2 ** -16),
                            ("db", bias, want[2], 2 ** -16)):
        assert t.grad.dtype == t.dtype and t.grad.shape == t.shape, name
        assert_grad_close(t.grad.float().numpy(), w, rel, GRAD_REL if bf16 else 0.0, name)


@pytest.mark.parametrize("j,d,c", [(3, 8, 16), (17, 64, 32)])
def test_plain_backward_matches_autograd(j, d, c):
    """``conv_soft_argmax_3d_backward_reference`` in float64 equals
    torch.autograd through the plain forward's expectations."""
    feats, weight, bias = (t.double().requires_grad_()
                           for t in _port(*_operands(2, 5, 7, c, j, d, seed=c), "float32"))
    e = nhwc_expectations(feats @ weight.t() + bias, j, d)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((2, j, 3)))
    want = torch.autograd.grad(e, (feats, weight, bias), g)
    got = CD.conv_soft_argmax_3d_backward_reference(feats.detach(), weight.detach(),
                                                    bias.detach(), e.detach(), g, j, d)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


def test_bf16_plain_backward_rounds_dslab_at_the_products():
    """For bf16 operands the plain backward rounds dslab (the logits'
    gradient, computed in f32) to bf16 before dfeats = dslab @ W and dW =
    dslab^T @ feats, sums both in f32 and rounds each once to bf16; db
    sums dslab unrounded, in the bias's dtype."""
    feats, weight, bias = _port(*_operands(2, 5, 7, 32, 3, 8, seed=4, bias_offset=50.0),
                                "bfloat16")
    bias = bias.float()
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 3, 3)).astype(np.float32))
    logits = feats.float() @ weight.float().t() + bias
    e = nhwc_expectations(logits, 3, 8)
    dslab = soft_argmax_3d_nhwc_backward_reference(logits, e, g, 3, 8).reshape(70, 24)
    rounded = dslab.bfloat16().float()
    dfeats, dw, db = CD.conv_soft_argmax_3d_backward_reference(feats, weight, bias, e, g, 3, 8)
    assert (dfeats.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16, torch.float32)
    assert torch.equal(dfeats, (rounded @ weight.float()).bfloat16().reshape(2, 5, 7, 32))
    assert torch.equal(dw, (rounded.t() @ feats.float().reshape(70, 32)).bfloat16())
    torch.testing.assert_close(db, dslab.sum(0), atol=1e-6, rtol=0)
    assert not torch.equal(dfeats, (dslab @ weight.float()).bfloat16().reshape(2, 5, 7, 32))


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
        """Grad is taken (kernel 13b repaired the refusal of the forward-only
        wrapper); any device but the CPU and CUDA is refused."""
        feats, kernel, bias = _port(*_operands(1, 4, 4, 16, 2, 8), "float32")
        kernel.requires_grad_()
        CD.conv_soft_argmax_3d_fused(feats, kernel, bias, 2, 8).sum().backward()
        assert kernel.grad.shape == kernel.shape and torch.isfinite(kernel.grad).all()
        with torch.no_grad():
            assert CD.conv_soft_argmax_3d_fused(feats, kernel, bias, 2, 8).shape == (1, 6)
        meta = [t.detach().to("meta") for t in (feats, kernel, bias)]
        with pytest.raises(ValueError, match="no conv-decode kernel for device meta"):
            CD.conv_soft_argmax_3d_fused(*meta, 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 17), (3, 13, 11, 3), (2, 64, 64, 17),
                                   (5, 61, 67, 17)])
def test_kernel_matches_plain_version_on_the_card(shape):
    """C = 256, D = 64, bf16: coordinates within 1e-3 of the plain version
    (143 pixels: a ragged second tile; 5 x 4087 pixels: 160 tiles, more
    than the card's SMs, so that a persistent CTA takes several, each
    sample's last tile ragged; +150 on the bias), two calls bitwise equal,
    one count per call."""
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
    j = CD.MAX_JOINTS + 1
    feats, weight, bias = _port(*_operands(1, 8, 8, 256, j, 64), "bfloat16", dev)
    with pytest.raises(ValueError, match=f"at most {CD.MAX_JOINTS} joints"):
        CD.conv_soft_argmax_3d_fused(feats, weight, bias.float(), j, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 17), (3, 13, 11, 3), (2, 64, 64, 1),
                                   (5, 61, 67, 17)])
def test_backward_kernel_matches_plain_version_on_the_card(shape):
    """Kernel 13b through the wrapper's backward (+100 on the bias, a
    ragged second tile at 143 pixels, 160 tiles of which each sample's
    last is ragged at 5 x 4087 pixels): dfeats (bf16, channels_last), dW
    (bf16) and db (f32) against the plain backward, one backward count
    per backward, two backward calls bitwise equal."""
    dev = cuda_device()
    b, h, w, j = shape
    feats, weight, bias = _port(*_operands(b, h, w, 256, j, 64, seed=12, bias_offset=100.0),
                                "bfloat16", dev)
    bias = bias.float()
    g = torch.randn(b, j * 3, generator=torch.Generator().manual_seed(15)).to(dev)
    runs = []
    for _ in range(2):
        nchw = feats.permute(0, 3, 1, 2).detach().requires_grad_()
        wt, bs = weight.detach().requires_grad_(), bias.detach().requires_grad_()
        before = CD.conv_soft_argmax_3d_backward.launches
        CD.conv_soft_argmax_3d_fused(nchw.permute(0, 2, 3, 1), wt, bs, j, 64).backward(g)
        assert CD.conv_soft_argmax_3d_backward.launches == before + 1
        assert nchw.grad.is_contiguous(memory_format=torch.channels_last)
        runs.append((nchw.grad.permute(0, 2, 3, 1), wt.grad, bs.grad))
    torch.cuda.synchronize()
    e = nhwc_expectations(feats.float() @ weight.float().t() + bias, j, 64)
    de = g.view(b, j, 3) * torch.tensor([2.0 / w, 2.0 / h, 2.5 / 64], device=dev)  # dcoords/dE
    want = CD.conv_soft_argmax_3d_backward_reference(feats, weight, bias, e, de, j, 64)
    for name, got, again, w_ in zip(("dfeats", "dW", "db"), *runs, want):
        assert got.dtype == w_.dtype and torch.equal(got, again), name
        assert_grad_close(got.float().cpu().numpy(), w_.float().cpu().numpy(), GRAD_REL,
                          GRAD_REL, name)
