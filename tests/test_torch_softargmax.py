"""The port's volumetric soft-argmax decodes (``pose3d_tpu_torch/ops/
heatmap.py``) and the NHWC soft-argmax kernel's wrapper and plain version
(``ops/softargmax.py``) against the JAX package.

Seeded numpy logits go through the JAX functions (the Pallas kernel
``soft_argmax_3d_nhwc_pallas`` in interpret mode, and the XLA
``heatmap.soft_argmax_3d_nhwc`` / ``soft_argmax_3d``) and through the
port. The logits are N(0, 3) around an offset of 100, with a planted
peak of +12 per (sample, joint): a decode that skipped the maximum
subtraction would overflow exp (e^100 > the f32 maximum). H != W, so a
decode that swapped x and y fails. Tolerances:

- f32: atol 2e-5, the JAX suite's (both sides sum in f32, in another
  order; measured up to 9.4e-6 on coordinates reaching |1|);
- bf16 logits: the same 2e-5, since both sides promote the same bf16
  values to f32 before any arithmetic (measured up to 1.3e-5);
- the heatmap: atol 1e-6 (probabilities below 1).

The backward (kernel 11b; on the CPU the autograd Function runs its plain
version ``soft_argmax_3d_nhwc_backward_reference``) against ``jax.vjp``
of the Pallas function in interpret mode, J in {1, 3, 17}, on the same
logits ~100 (the coordinates' spread, std >= 0.1, is asserted):

- f32 dx: atol 2^-16·max|want| (both compute the same formula in f32;
  measured up to 5.7e-6·max|want|);
- bf16 dx (written in bf16 by both): 2^-7·|want| + 2^-16·max|want|, one
  bf16 step where the f32 values round the other way (measured one step,
  1.2e-4, on an element of ~0.03);
- the plain backward against torch.autograd of the plain forward: float64
  atol 1e-12, f32 atol 2^-16·max|want|.

The legacy (B, J, D, H, W) decode ``soft_argmax_3d_pallas`` (kernel 12 on
the card; on the CPU its plain version ``soft_argmax_3d_expectations_
reference``) against the JAX ``soft_argmax_3d_pallas`` in interpret mode,
on N(0, 3) logits and on the logits ~100 with planted peaks above, f32
and bf16, at the shapes of the JAX suite (16^3 and 8 x 16 x 32), z_scale
2.5, 2.0 and 1.0: atol 2e-5 as above. Its backward, the XLA formula
``_vjp_bwd`` in PyTorch ops (``soft_argmax_3d_backward_reference``),
against ``_vjp_bwd`` on the same expectations: the NHWC backward's limits
above; end to end against ``jax.grad`` of the JAX function: f32 the same,
bf16 as accurate as JAX against a float64 gradient (see the test). The
plain legacy decode against the plain NHWC decode on the same
volumes: atol 1e-5 (the same f32 expectations, summed in another order).

Tests marked ``cuda`` run the Hopper kernels against their plain versions
and skip without a card: coordinates within 1e-3 (both sum in f32, in
another order; measured on the H100 in ``chip_smoke.py``), dx within
2^-7·|want| + 2^-16·max|want| (bf16) or 2^-14·max|want| (f32; the
kernel's p / s comes from the forward's merged sum, the plain version's
from its own), two calls bitwise equal.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device

from pose3d_tpu_torch.ops import heatmap as H
from pose3d_tpu_torch.ops import softargmax as SA

torch.set_num_threads(2)

ATOL = 2e-5
KERNEL_ATOL = 1e-3
MIN_SPREAD = 0.1


def assert_grad_close(got, want, dtype, f32_rel=2 ** -16):
    """dx: within f32_rel·max|want| in f32; in bf16 one bf16 step of the
    element (2^-7·|want|) plus 2^-16·max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = np.abs(want).max()
    rtol = 2 ** -7 if dtype == "bfloat16" else 0.0
    atol = (2 ** -16 if dtype == "bfloat16" else f32_rel) * top
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _logits(b, h, w, j, d, seed=0, offset=100.0, peak=12.0):
    """(B, H, W, J*D) f32 logits: N(0, 3) + offset, plus one planted peak
    per (sample, joint) at a seeded voxel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, j, d)) * 3.0 + offset
    for bi in range(b):
        for ji in range(j):
            x[bi, rng.integers(h), rng.integers(w), ji, rng.integers(d)] += peak
    return x.reshape(b, h, w, j * d).astype(np.float32)


def _volumes(b, j, d, h, w, kind, seed=0, peak=12.0):
    """(B, J, D, H, W) f32 logits: "random" N(0, 3) (the JAX suite's), or
    "peaks" N(0, 3) + 100 with a +``peak`` planted per (sample, joint)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, j, d, h, w)) * 3.0
    if kind == "peaks":
        x += 100.0
        for bi in range(b):
            for ji in range(j):
                x[bi, ji, rng.integers(d), rng.integers(h), rng.integers(w)] += peak
    return x.astype(np.float32)


def _jnp(x, dtype):
    import jax.numpy as jnp

    return jnp.asarray(x, {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype])


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("j", [17, 4, 3])
def test_plain_nhwc_matches_jax_kernel(j, d, dtype):
    """The wrapper on the CPU (its plain version) vs the JAX Pallas kernel
    in interpret mode and vs the JAX XLA decode."""
    from pose3d_tpu.ops.heatmap import soft_argmax_3d_nhwc
    from pose3d_tpu.ops.pallas_softargmax import soft_argmax_3d_nhwc_pallas

    x = _logits(2, 8, 6, j, d, seed=j * d)
    want = np.asarray(soft_argmax_3d_nhwc_pallas(_jnp(x, dtype), j, d, interpret=True))
    want_xla = np.asarray(soft_argmax_3d_nhwc(_jnp(x, dtype), j, d))
    got = SA.soft_argmax_3d_nhwc_kernel(_torch(x, dtype), j, d)
    assert got.dtype == torch.float32 and got.shape == (2, j * 3)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_xla, atol=ATOL, rtol=0)
    plain = SA.soft_argmax_3d_nhwc_reference(_torch(x, dtype), j, d)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("z_scale,xy_scale", [(2.5, 2.0), (2.0, 2.0), (1.0, 1.0)])
def test_scaling_matches_jax(z_scale, xy_scale):
    from pose3d_tpu.ops.heatmap import soft_argmax_3d_nhwc

    x = _logits(2, 5, 7, 3, 8, seed=1)
    want = np.asarray(soft_argmax_3d_nhwc(_jnp(x, "float32"), 3, 8, z_scale=z_scale,
                                          xy_scale=xy_scale))
    got = H.soft_argmax_3d_nhwc(torch.from_numpy(x), 3, 8, z_scale=z_scale, xy_scale=xy_scale)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_planted_peaks_are_found():
    """A peak of +30 over N(0, 1) logits takes nearly all the mass: the
    expectations sit on the planted voxel (x over W, y over H, z over D)."""
    rng = np.random.default_rng(3)
    b, h, w, j, d = 2, 8, 6, 4, 8
    x = rng.standard_normal((b, h, w, j, d)).astype(np.float32)
    where = [(rng.integers(h), rng.integers(w), rng.integers(d)) for _ in range(b * j)]
    for n, (yi, xi, di) in enumerate(where):
        x[n // j, yi, xi, n % j, di] += 30.0
    e = H.nhwc_expectations(torch.from_numpy(x.reshape(b, h, w, j * d)), j, d)
    want = np.array([(xi, yi, di) for yi, xi, di in where], np.float32).reshape(b, j, 3)
    np.testing.assert_allclose(e.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("layout", ["flat", "5d"])
def test_plain_heatmap_decode_matches_jax(layout):
    """``soft_argmax_3d`` with the heatmap, on (B, J*D, H, W) or (B, J, D,
    H, W) logits, vs the JAX XLA function."""
    from pose3d_tpu.ops.heatmap import soft_argmax_3d

    b, j, d, h, w = 2, 4, 8, 6, 5
    x = _logits(b, h, w, j, d, seed=5).reshape(b, h, w, j * d).transpose(0, 3, 1, 2).copy()
    if layout == "5d":
        x = x.reshape(b, j, d, h, w)
    want, want_hm = soft_argmax_3d(_jnp(x, "float32"), j, d, h, w, z_scale=2.5)
    got, hm = H.soft_argmax_3d(torch.from_numpy(x), j, d, h, w, z_scale=2.5)
    assert hm.shape == (b, j, d, h, w) and hm.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hm.numpy(), np.asarray(want_hm), atol=1e-6, rtol=0)
    assert H.soft_argmax_3d(torch.from_numpy(x), j, d, h, w, return_heatmap=False)[1] is None


def test_heatmap_and_nhwc_decodes_agree():
    """The two layouts of one decode: (B, J*D, H, W) and its NHWC view."""
    x = torch.from_numpy(_logits(2, 6, 5, 3, 8, seed=6))
    nhwc = H.soft_argmax_3d_nhwc(x, 3, 8)
    flat, _ = H.soft_argmax_3d(x.permute(0, 3, 1, 2), 3, 8, 6, 5)
    torch.testing.assert_close(nhwc, flat, atol=ATOL, rtol=0)


def test_plain_nhwc_decode_is_differentiable():
    x = torch.from_numpy(_logits(1, 4, 4, 2, 8, seed=7)).requires_grad_()
    H.soft_argmax_3d_nhwc(x, 2, 8).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [17, 3, 1])
def test_backward_matches_jax_vjp(j, dtype):
    """The wrapper's gradient (its autograd Function, the plain backward on
    the CPU) vs ``jax.vjp`` of ``soft_argmax_3d_nhwc_pallas`` in interpret
    mode (``_kernel_nhwc_bwd``), in the logits' dtype."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.ops.pallas_softargmax import soft_argmax_3d_nhwc_pallas

    x = _logits(2, 8, 6, j, 64, seed=j)
    ct = np.random.default_rng(j + 1).standard_normal((2, j * 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: soft_argmax_3d_nhwc_pallas(a, j, 64, interpret=True),
                     _jnp(x, dtype))
    want = np.asarray(vjp(jnp.asarray(ct))[0].astype(jnp.float32))
    xt = _torch(x, dtype).requires_grad_()
    coords = SA.soft_argmax_3d_nhwc_kernel(xt, j, 64)
    coords.backward(torch.from_numpy(ct))
    assert coords.std() >= MIN_SPREAD
    assert xt.grad.dtype == xt.dtype and xt.grad.shape == xt.shape
    assert_grad_close(xt.grad.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("j,d", [(3, 8), (17, 64)])
def test_plain_backward_matches_autograd(j, d, dtype):
    """``soft_argmax_3d_nhwc_backward_reference`` (the JAX formula) equals
    torch.autograd through the plain forward's expectations."""
    x = torch.from_numpy(_logits(2, 5, 7, j, d, seed=d + j)).to(dtype).requires_grad_()
    e = H.nhwc_expectations(x, j, d)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal((2, j, 3))).to(dtype)
    (want,) = torch.autograd.grad(e, x, g)
    got = SA.soft_argmax_3d_nhwc_backward_reference(x.detach(), e.detach(), g, j, d)
    assert got.dtype == dtype
    atol = 1e-12 if dtype == torch.float64 else 2 ** -16 * want.abs().max().item()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


def test_backward_hands_a_channels_last_gradient_to_the_conv():
    """The logits as the final conv writes them (channels_last, decoded
    through an NHWC view): their gradient comes back channels_last."""
    x = torch.from_numpy(_logits(2, 6, 5, 3, 8, seed=9)).permute(0, 3, 1, 2).requires_grad_()
    assert x.is_contiguous(memory_format=torch.channels_last)
    SA.soft_argmax_3d_nhwc_kernel(x.permute(0, 2, 3, 1), 3, 8).sum().backward()
    assert x.grad.is_contiguous(memory_format=torch.channels_last)


LEGACY_SHAPES = [(2, 17, 16, 16, 16), (2, 17, 8, 16, 32)]


@pytest.mark.parametrize("kind", ["random", "peaks"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("z_scale", [2.5, 2.0, 1.0])
@pytest.mark.parametrize("shape", LEGACY_SHAPES, ids=["16^3", "8x16x32"])
def test_plain_legacy_matches_jax_kernel(shape, z_scale, dtype, kind):
    """``soft_argmax_3d_pallas`` on the CPU (its plain version) vs the JAX
    ``soft_argmax_3d_pallas`` in interpret mode (kernel ``_kernel``)."""
    from pose3d_tpu.ops.pallas_softargmax import soft_argmax_3d_pallas

    b, j, d, h, w = shape
    x = _volumes(*shape, kind, seed=d + h + w)
    want = np.asarray(soft_argmax_3d_pallas(_jnp(x, dtype), j, d, h, w, z_scale=z_scale,
                                            interpret=True))
    before = SA.soft_argmax_3d_pallas.launches
    got = SA.soft_argmax_3d_pallas(_torch(x, dtype), j, d, h, w, z_scale=z_scale)
    assert SA.soft_argmax_3d_pallas.launches == before
    assert got.dtype == torch.float32 and got.shape == (b, j * 3)
    if kind == "peaks":
        assert got.std() >= MIN_SPREAD
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "peaks"])
def test_legacy_backward_matches_jax_vjp(kind, dtype):
    """``soft_argmax_3d_backward_reference`` vs the JAX backward ``_vjp_bwd``
    on the same logits, expectations (the JAX kernel's) and gradient, in
    the logits' dtype."""
    import jax.numpy as jnp

    from pose3d_tpu.ops import pallas_softargmax as ps

    b, j, d, h, w = LEGACY_SHAPES[1]
    flat = _jnp(_volumes(b, j, d, h, w, kind, seed=21), dtype).reshape(b * j, d, h, w)
    e = ps._expectations(flat, True)
    g = np.random.default_rng(22).standard_normal((b * j, 3)).astype(np.float32)
    want = np.asarray(ps._vjp_bwd(True, (flat, e), jnp.asarray(g))[0].astype(jnp.float32))
    got = SA.soft_argmax_3d_backward_reference(
        _torch(np.array(flat.astype(jnp.float32)), dtype), torch.from_numpy(np.array(e)),
        torch.from_numpy(g))
    assert got.dtype == getattr(torch, dtype)
    assert_grad_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "peaks"])
def test_legacy_backward_matches_jax_grad(kind, dtype):
    """The gradient of ``soft_argmax_3d_pallas`` vs ``jax.grad`` of the JAX
    function, end to end, in the logits' dtype. f32: 2^-16·max|want|. bf16:
    each side's expectations come from its own forward, and the JAX
    kernel's lie up to 27x farther from float64 than the plain version's
    (measured 1.5e-4 against 5.5e-6 on the planted peaks), which moves dx
    where its bracket nearly cancels by ~2^-15.7·max|want|: the port's dx
    is held to a float64 gradient at most 1.5x as far as JAX's is, plus
    2^-16·max|want|."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.ops.pallas_softargmax import soft_argmax_3d_pallas

    b, j, d, h, w = LEGACY_SHAPES[1]
    x = _volumes(b, j, d, h, w, kind, seed=21)
    ct = np.random.default_rng(22).standard_normal((b, j * 3)).astype(np.float32)
    want = jax.grad(lambda a: jnp.vdot(soft_argmax_3d_pallas(a, j, d, h, w, interpret=True),
                                       jnp.asarray(ct)))(_jnp(x, dtype))
    want = np.asarray(want.astype(jnp.float32))
    xt = _torch(x, dtype).requires_grad_()
    coords = SA.soft_argmax_3d_pallas(xt, j, d, h, w)
    coords.backward(torch.from_numpy(ct))
    assert xt.grad.dtype == xt.dtype and xt.grad.shape == xt.shape
    got = xt.grad.float().numpy()
    if dtype == "float32":
        assert_grad_close(got, want, dtype)
        return
    x64 = xt.detach().double().requires_grad_()
    SA.soft_argmax_3d_pallas(x64, j, d, h, w).backward(torch.from_numpy(ct).double())
    ref = x64.grad.numpy()
    err_port, err_jax = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert err_port <= 1.5 * err_jax + 2 ** -16 * np.abs(ref).max(), (err_port, err_jax)


@pytest.mark.parametrize("shape", LEGACY_SHAPES, ids=["16^3", "8x16x32"])
def test_plain_legacy_matches_plain_nhwc(shape):
    """The same volumes through the legacy and the NHWC plain decodes."""
    b, j, d, h, w = shape
    x = torch.from_numpy(_volumes(*shape, "peaks", seed=23))
    nhwc = x.permute(0, 3, 4, 1, 2).reshape(b, h, w, j * d)
    torch.testing.assert_close(SA.soft_argmax_3d_pallas(x, j, d, h, w),
                               SA.soft_argmax_3d_nhwc_reference(nhwc, j, d), atol=1e-5, rtol=0)


class TestWrapperRules:
    def test_refuses_grad_and_other_devices(self):
        """Grad is taken (kernel 11b repaired the refusal of the forward-only
        wrapper); any device but the CPU and CUDA is refused."""
        x = torch.zeros(1, 4, 4, 16, requires_grad=True)
        SA.soft_argmax_3d_nhwc_kernel(x, 2, 8).sum().backward()
        assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()
        with torch.no_grad():
            assert SA.soft_argmax_3d_nhwc_kernel(x, 2, 8).shape == (1, 6)
        with pytest.raises(ValueError, match="no soft-argmax kernel for device meta"):
            SA.soft_argmax_3d_nhwc_kernel(torch.zeros(1, 4, 4, 16, device="meta"), 2, 8)

    def test_legacy_rejects_bad_shapes_and_devices(self):
        with pytest.raises(ValueError, match="do not hold"):
            SA.soft_argmax_3d_pallas(torch.zeros(2, 17, 8, 8, 7), 17, 8, 8, 8)
        with pytest.raises(ValueError, match="no soft-argmax kernel for device meta"):
            SA.soft_argmax_3d_pallas(torch.zeros(1, 2, 8, 8, 8, device="meta"), 2, 8, 8, 8)
        with pytest.raises(ValueError, match="no soft-argmax kernel for device cpu"):
            SA.soft_argmax_3d_volume_expectations(torch.zeros(2, 8, 8, 8))

    def test_rejects_a_channel_count_that_is_not_j_times_d(self):
        with pytest.raises(ValueError, match="logits must be"):
            SA.soft_argmax_3d_nhwc_kernel(torch.zeros(1, 4, 4, 15), 2, 8)
        with pytest.raises(ValueError, match="channels are not"):
            H.soft_argmax_3d_nhwc(torch.zeros(1, 4, 4, 15), 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 17, 64), (3, 13, 11, 3, 8), (2, 64, 64, 17, 64),
                                   (5, 61, 67, 17, 64)])
def test_kernel_matches_plain_version_on_the_card(shape, dtype):
    """Coordinates within 1e-3 of the plain version (143 pixels: a ragged
    second tile; 5 x 4087 pixels: 160 tiles, more than the card's SMs, so
    that a persistent CTA takes several, each sample's last tile ragged),
    a finite result at logits of ~100, two calls bitwise equal and one
    count per call."""
    dev = cuda_device()
    b, h, w, j, d = shape
    x = _torch(_logits(b, h, w, j, d, seed=11), dtype).to(dev)
    before = SA.soft_argmax_3d_nhwc_kernel.launches
    got = SA.soft_argmax_3d_nhwc_kernel(x, j, d)
    again = SA.soft_argmax_3d_nhwc_kernel(x, j, d)
    torch.cuda.synchronize()
    assert SA.soft_argmax_3d_nhwc_kernel.launches == before + 2
    want = SA.soft_argmax_3d_nhwc_reference(x, j, d)
    assert torch.isfinite(got).all() and torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_reads_a_channels_last_conv_output():
    """The layout PoseNet3D hands it: a channels_last (B, J*D, H, W)
    tensor, permuted to NHWC as a view; a transposed copy is refused."""
    dev = cuda_device()
    x = torch.from_numpy(_logits(2, 8, 8, 3, 64, seed=12)).to(dev, torch.bfloat16)
    nchw = x.permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    got = SA.soft_argmax_3d_nhwc_kernel(nchw.permute(0, 2, 3, 1), 3, 64)
    torch.testing.assert_close(got, SA.soft_argmax_3d_nhwc_reference(x, 3, 64),
                               atol=KERNEL_ATOL, rtol=0)
    with pytest.raises(ValueError, match="contiguous in NHWC order"):
        SA.soft_argmax_3d_nhwc_kernel(nchw.contiguous().permute(0, 2, 3, 1), 3, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 17, 64), (3, 13, 11, 3, 8), (2, 64, 64, 1, 64)])
def test_backward_kernel_matches_plain_version_on_the_card(shape, dtype):
    """Kernel 11b through the wrapper's backward: dx against the plain
    backward (logits ~100, a ragged second tile at 143 pixels), in the
    logits' dtype and channels_last layout, one backward count per
    backward, two backward calls bitwise equal."""
    dev = cuda_device()
    b, h, w, j, d = shape
    x = _torch(_logits(b, h, w, j, d, seed=13), dtype).to(dev)
    g = torch.randn(b, j * 3, generator=torch.Generator().manual_seed(14)).to(dev)
    grads = []
    for _ in range(2):
        nchw = x.permute(0, 3, 1, 2).detach().requires_grad_()
        before = SA.soft_argmax_3d_nhwc_backward.launches
        SA.soft_argmax_3d_nhwc_kernel(nchw.permute(0, 2, 3, 1), j, d).backward(g)
        assert SA.soft_argmax_3d_nhwc_backward.launches == before + 1
        assert nchw.grad.is_contiguous(memory_format=torch.channels_last)
        grads.append(nchw.grad.permute(0, 2, 3, 1))
    torch.cuda.synchronize()
    e = H.nhwc_expectations(x, j, d)
    de = g.view(b, j, 3) * torch.tensor([2.0 / w, 2.0 / h, 2.5 / d], device=dev)  # dcoords/dE
    want = SA.soft_argmax_3d_nhwc_backward_reference(x, e, de, j, d)
    assert grads[0].dtype == x.dtype and torch.equal(grads[0], grads[1])
    assert_grad_close(grads[0].float().cpu().numpy(), want.float().cpu().numpy(), dtype,
                      f32_rel=2 ** -14)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 17, 16, 16, 16), (3, 3, 8, 16, 32), (2, 17, 64, 64, 64)])
def test_legacy_kernel_matches_plain_version_on_the_card(shape, dtype):
    """Kernel 12: coordinates within 1e-3 of the plain version on logits of
    ~100 with planted peaks of +30 (a +12 peak holds too little of a 64^3
    volume's mass for the coordinates to spread; 16^3 bf16 is half a 16 KB
    tile), two calls bitwise equal, one count a call; the backward (the
    XLA formula) runs on the card and gives finite gradients in the
    logits' dtype."""
    dev = cuda_device()
    b, j, d, h, w = shape
    x = _torch(_volumes(*shape, "peaks", seed=24, peak=30.0), dtype).to(dev)
    before = SA.soft_argmax_3d_pallas.launches
    got = SA.soft_argmax_3d_pallas(x, j, d, h, w)
    again = SA.soft_argmax_3d_pallas(x, j, d, h, w)
    torch.cuda.synchronize()
    assert SA.soft_argmax_3d_pallas.launches == before + 2
    e = SA.soft_argmax_3d_expectations_reference(x.reshape(b * j, d, h, w))
    want = H.coords_from_expectations(e.view(b, j, 3), h, w, d)
    assert torch.isfinite(got).all() and torch.equal(got, again) and got.std() >= MIN_SPREAD
    torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=0)
    xr = x.detach().requires_grad_()
    SA.soft_argmax_3d_pallas(xr, j, d, h, w).sum().backward()
    assert xr.grad.dtype == x.dtype and torch.isfinite(xr.grad.float()).all()


@pytest.mark.cuda
def test_legacy_kernel_refuses_what_it_cannot_read():
    dev = cuda_device()
    with pytest.raises(TypeError, match="bf16 or f32"):
        SA.soft_argmax_3d_pallas(torch.zeros(1, 2, 8, 8, 8, device=dev, dtype=torch.float16),
                                 2, 8, 8, 8)
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        SA.soft_argmax_3d_pallas(torch.zeros(1, 2, 8, 8, 6, device=dev), 2, 8, 8, 6)
