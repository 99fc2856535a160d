"""The port's direct image->3D model (``pose3d_tpu_torch/models/
{norm,resnet,heads}.py``), its weight bridge, its eval steps
(``train/image_steps.py``), ``synthetic_frames`` and ``DirectConfig``
against the JAX package.

The flax ``PoseNet3D`` (ResNet-18 and ResNet-50, 17 joints, depth 64) is
initialised once per architecture, with seeded biases, BN scales and BN
statistics, and its final 1x1 conv scaled by 32 so that the coordinates
spread (``torch_port_util.flax_posenet``): with the init's scale every
coordinate sits near -1/32 and a comparison says little. Each test
asserts a spread (std over samples and joints) of at least 0.1. Frames
are 64 x 64, B = 2. Tolerances:

- the f32 ResNet's features vs flax: atol 1e-4 + rtol 1e-4 (f32 convs
  summed in another order; measured up to 9.5e-6 on features up to
  |7.5|);
- the f32 PoseNet3D's coordinates, every route, vs flax (the fused route
  through the Pallas kernel in interpret mode): atol 1e-4 (measured up to
  2.9e-5, on the NHWC route, whose decode sums in another order than
  XLA's); the heatmap route's heatmap: atol 1e-6 (measured 8.0e-7);
- the bf16 model's plain routes vs the flax f32 apply: atol 5e-2, the JAX
  package's bf16 budget (measured up to 5.6e-3);
- the eval steps vs the JAX steps on uint8 frames: pred atol 1e-4, loss
  and MPJPE sums rtol 1e-4.

Tests marked ``cuda`` run the model on the card and skip without one.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import (cuda_device, flax_apply, flax_posenet, flax_posenet_apply,
                             torch_posenet)

from pose3d_tpu_torch.models.heads import PoseNet3D
from pose3d_tpu_torch.models.norm import F32BatchNorm2d
from pose3d_tpu_torch.ops import conv_decode, softargmax

torch.set_num_threads(2)

F32_ATOL = 1e-4
BF16_ATOL = 5e-2
MIN_SPREAD = 0.1
ROUTES = {
    "heatmap": {},
    "nhwc": {"return_heatmap": False},
    "fused": {"return_heatmap": False, "fuse_final_conv": True},
}


def _frames(b=2, size=64, seed=1):
    return np.random.default_rng(seed).random((b, size, size, 3)).astype(np.float32)


def _flax_model(arch, route):
    from pose3d_tpu.models.heads import PoseNet3D as FlaxPoseNet3D

    return FlaxPoseNet3D(architecture=arch, use_pallas=False, **ROUTES[route])


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_bridge_equals_the_jax_package_export(arch):
    """posenet3d_from_flax == the JAX package's posenet3d_to_torch key for
    key and bit for bit, BatchNorm's num_batches_tracked included; the
    port's module takes it strictly and has no other key."""
    from pose3d_tpu.interop.torch_weights import posenet3d_to_torch

    from pose3d_tpu_torch.interop.weights import posenet3d_from_flax

    params, stats = flax_posenet(arch)
    got = posenet3d_from_flax(params, stats)
    want = posenet3d_to_torch({"params": params, "batch_stats": stats})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].is_contiguous()
        assert got[k].dtype == (torch.int64 if k.endswith("num_batches_tracked")
                                else torch.float32)
    model = PoseNet3D(arch, device="cpu")
    model.load_state_dict(got, strict=True)
    assert set(model.state_dict()) == set(got)
    stage1 = {k.split(".")[3] for k in got if k.startswith("preact.layer1.0.")}
    assert ("downsample" in stage1) == (arch == "resnet50")  # 64 -> 256 channels


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_flax(arch):
    from pose3d_tpu.models.resnet import ResNet as FlaxResNet

    from pose3d_tpu_torch.interop.weights import resnet_from_flax
    from pose3d_tpu_torch.models.resnet import ResNet

    params, stats = flax_posenet(arch)
    x = _frames()
    want = flax_apply(FlaxResNet(arch), params["backbone"], x, stats["backbone"])
    model = ResNet(arch, device="cpu")
    model.load_state_dict(resnet_from_flax(params["backbone"], stats["backbone"]), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2, 2, model.feature_channels)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_module_matches_flax_f32(arch, route):
    params, stats = flax_posenet(arch)
    x = _frames()
    want, want_hm = flax_posenet_apply(_flax_model(arch, route), params, stats, x)
    model = torch_posenet(params, stats, architecture=arch, **ROUTES[route])
    with torch.no_grad():
        got, hm = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 51)
    assert want.std() >= MIN_SPREAD
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    if route == "heatmap":
        assert hm.shape == want_hm.shape == (2, 17, 64, 16, 16)
        np.testing.assert_allclose(hm.numpy(), want_hm, atol=1e-6, rtol=0)
    else:
        assert hm is None and want_hm is None


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_bf16_module_close_to_flax_f32(route):
    """The bf16 model (BatchNorm f32, the fused route's bias rounded to
    bf16) on its plain routes, the CPU's, vs the f32 flax apply."""
    params, stats = flax_posenet("resnet50")
    x = _frames(seed=2)
    want, _ = flax_posenet_apply(_flax_model("resnet50", route), params, stats, x)
    model = torch_posenet(params, stats, torch.bfloat16, architecture="resnet50",
                          **ROUTES[route])
    assert model.dtype == torch.bfloat16
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.std() >= MIN_SPREAD
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_eval_steps_match_the_jax_steps():
    """make_direct_eval_step / make_direct_eval_chunk_step on uint8 frames
    (divided by 256) through the fused route, vs the JAX steps."""
    import jax.numpy as jnp

    from pose3d_tpu.train import image_steps as J
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState as JaxState

    from pose3d_tpu_torch.train import image_steps as P
    from pose3d_tpu_torch.train.state import create_train_state

    params, stats = flax_posenet("resnet18")
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, 2, 64, 64, 3), dtype=np.uint8)  # K = 2 batches
    kp3d = rng.uniform(-1, 1, (2, 2, 17, 3)).astype(np.float32)
    flax_model = _flax_model("resnet18", "fused")
    jstate = JaxState(step=jnp.asarray(0), params=params, batch_stats=stats, opt_state=None,
                      plateau=plateau_init(1e-3), tx=None, apply_fn=flax_model.apply)
    state = create_train_state(torch_posenet(params, stats, architecture="resnet18",
                                             **ROUTES["fused"]), lr=1e-3)

    want = J.make_direct_eval_step("mse")(jstate, jnp.asarray(frames[0]), jnp.asarray(kp3d[0]))
    got = P.make_direct_eval_step("mse")(state, torch.from_numpy(frames[0]),
                                         torch.from_numpy(kp3d[0]))
    assert np.asarray(want["pred"]).std() >= MIN_SPREAD
    np.testing.assert_allclose(got["pred"].numpy(), np.asarray(want["pred"]), atol=1e-4)
    for k in ("loss", "mpjpe_sums"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, err_msg=k)

    want = J.make_direct_eval_chunk_step("mse")(jstate, jnp.asarray(frames), jnp.asarray(kp3d))
    got = P.make_direct_eval_chunk_step("mse")(state, torch.from_numpy(frames),
                                               torch.from_numpy(kp3d))
    assert set(got) == set(want) == {"loss", "mpjpe_sums"}
    for k in ("loss", "mpjpe_sums"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, err_msg=k)


def test_normalize_divides_integers_by_256():
    from pose3d_tpu_torch.train.image_steps import _normalize

    u8 = torch.tensor([[0, 128, 255]], dtype=torch.uint8)
    assert torch.equal(_normalize(u8), torch.tensor([[0.0, 0.5, 255 / 256]]))
    f = torch.rand(2, 3)
    assert _normalize(f) is f


def test_synthetic_frames_equal_the_jax_package():
    from pose3d_tpu.data.synthetic import synthetic_frames as jax_frames

    from pose3d_tpu_torch.data.synthetic import synthetic_frames

    got = synthetic_frames(3, size=32, seed=5)
    assert got.dtype == np.float32 and got.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(got, jax_frames(3, size=32, seed=5))


def test_direct_config_has_the_jax_fields():
    from pose3d_tpu.config import DirectConfig as JaxConfig

    from pose3d_tpu_torch.config import DirectConfig, parse_config

    ours = {f.name: f.default for f in dataclasses.fields(DirectConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert set(ours) == set(theirs) | {"device"}
    assert all(ours[k] == v for k, v in theirs.items() if k != "data")
    cfg = parse_config(DirectConfig, ["--cpu", "--fuse_final_conv", "true",
                                      "--weight_decay", "1e-8"])
    assert cfg.device == "cpu" and cfg.fuse_final_conv and cfg.weight_decay == 1e-8


class TestRoutes:
    def _model(self, dtype=torch.float32, **fields):
        return PoseNet3D("resnet18", device="cpu", dtype=dtype, **fields).init_weights(
            torch.Generator().manual_seed(0)).eval()

    def test_fused_route_gates_on_bf16(self, monkeypatch):
        """The fused route calls the kernel wrapper where the compute dtype
        is bf16 (a bf16 model, or an f32 model under autocast, whose f32
        weight and bias it rounds to bf16) and the plain version, by an
        explicit gate, for any other dtype."""
        calls = []
        real = conv_decode.conv_soft_argmax_3d_fused

        def spy(*args, **kwargs):
            calls.append((args[0].dtype, args[1].dtype, args[2].dtype))
            return real(*args, **kwargs)

        monkeypatch.setattr(conv_decode, "conv_soft_argmax_3d_fused", spy)
        x = torch.from_numpy(_frames(1))
        with torch.no_grad():
            for dtype in (torch.float32, torch.bfloat16):
                coords, hm = self._model(dtype, return_heatmap=False, fuse_final_conv=True)(x)
                assert coords.shape == (1, 51) and hm is None
            model = self._model(return_heatmap=False, fuse_final_conv=True)
            with torch.autocast("cpu", torch.bfloat16):
                coords, _ = model(x)
            assert coords.dtype == torch.float32
        bf16_call = (torch.bfloat16, torch.bfloat16, torch.float32)
        assert calls == [bf16_call, bf16_call]

    @pytest.mark.parametrize("use_kernels,train,want,kernels_train",
                             [(True, False, 1, False), (False, False, 0, False),
                              (True, True, 0, False), (True, True, 1, True),
                              (False, True, 0, True)])
    def test_nhwc_route_takes_the_kernel_wrapper_in_eval(self, monkeypatch, use_kernels,
                                                         train, want, kernels_train):
        """In eval mode under ``use_kernels``, in training only with
        ``use_kernels_train`` as well (JAX's ``use_pallas_train``)."""
        calls = []
        real = softargmax.soft_argmax_3d_nhwc_kernel
        monkeypatch.setattr(softargmax, "soft_argmax_3d_nhwc_kernel",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        model = self._model(return_heatmap=False, use_kernels=use_kernels,
                            use_kernels_train=kernels_train).train(train)
        with torch.no_grad():
            model(torch.from_numpy(_frames(2)))
        assert len(calls) == want

    def test_training_route_is_differentiable_and_kernel_routes_refuse_grad(self):
        """Every route differentiates: the plain training route, and the two
        kernel routes that refused grad before their backwards were ported
        (the NHWC kernel route in eval mode, the fused route of a bf16
        model) give finite gradients to every parameter, and the kernel
        routes' gradients are the plain routes' within relative L2 1e-4
        (their Functions run the plain backwards on the CPU, whose f32 sums
        run in another order than autograd's)."""
        x = torch.from_numpy(_frames(2))

        def grads(model):
            coords, _ = model(x)
            coords.square().sum().backward()
            return {n: p.grad for n, p in model.named_parameters()}

        plain = grads(self._model(return_heatmap=False).train())
        assert all(g is not None and torch.isfinite(g).all() for g in plain.values())
        for kernel_route, plain_route in (({}, {"use_kernels": False}),
                                          ({"fuse_final_conv": True}, {})):
            got = grads(self._model(return_heatmap=False, **kernel_route))
            want = grads(self._model(return_heatmap=False, **plain_route))
            for n, g in want.items():
                assert ((got[n] - g).norm() / g.norm()).item() <= 1e-4, n
        bf16 = grads(self._model(torch.bfloat16, return_heatmap=False, fuse_final_conv=True))
        assert all(g is not None and torch.isfinite(g.float()).all() for g in bf16.values())

    def test_runs_channels_last(self):
        model = self._model(return_heatmap=False)
        assert model.final_layer.weight.is_contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            feats = model.features(torch.from_numpy(_frames(1)))
            logits = model.final_layer(feats)
        assert feats.shape == (1, 256, 16, 16)
        for t in (feats, logits):
            assert t.is_contiguous(memory_format=torch.channels_last)
            assert t.permute(0, 2, 3, 1).is_contiguous()

    def test_init_weights_is_seeded(self):
        a = self._model().state_dict()
        b = self._model().state_dict()
        c = PoseNet3D("resnet18", device="cpu").init_weights(
            torch.Generator().manual_seed(1)).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["final_layer.weight"], c["final_layer.weight"])
        for k, v in a.items():
            if k.endswith("running_var"):
                assert (v >= 0.5).all() and (v < 1.5).all(), k
            elif k.endswith("running_mean") or k.endswith("bias"):
                assert (v != 0).all(), k


class TestBatchNorm2d:
    def test_stays_f32_and_channels_last_in_a_bf16_model(self):
        model = PoseNet3D("resnet18", device="cpu").to(torch.bfloat16)
        norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
        assert norms and all(isinstance(m, F32BatchNorm2d) for m in norms)
        for bn in norms:
            assert bn.eps == 1e-5 and bn.momentum == 0.1
            assert all(t.dtype == torch.float32 for t in
                       (bn.weight, bn.bias, bn.running_mean, bn.running_var))
        bn = norms[0].eval()
        x = torch.randn(2, 64, 5, 5, generator=torch.Generator().manual_seed(0))
        x = x.bfloat16().contiguous(memory_format=torch.channels_last)
        got = bn(x)
        assert got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, bn(x.float()).bfloat16())

    def test_train_step_matches_the_jax_batch_norm(self):
        """Train mode on an NHWC batch: normalised by the batch statistics,
        the running variance updated with the unbiased one (the JAX
        package's models/norm.py)."""
        import jax.numpy as jnp

        from pose3d_tpu.models.norm import BatchNorm

        rng = np.random.default_rng(6)
        x = (rng.standard_normal((4, 5, 3, 8)) * 2 + 1).astype(np.float32)  # NHWC
        flax_bn = BatchNorm(use_running_average=False)
        variables = {"params": {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)},
                     "batch_stats": {"mean": np.zeros(8, np.float32),
                                     "var": np.ones(8, np.float32)}}
        want, upd = flax_bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        bn = F32BatchNorm2d(8, device="cpu").train()
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]), atol=1e-5)


@pytest.mark.cuda
def test_batch_norm_on_the_card_is_the_f32_cast():
    """F32BatchNorm2d on a bf16 channels_last CUDA tensor (PyTorch's mixed-
    precision batch norm) vs the cast to f32 and back: within one bf16
    step of the value, in eval and in train mode (running statistics
    within 1e-6)."""
    dev = cuda_device()
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(8, 64, 16, 16, generator=gen) * 3 + 1).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    for train in (False, True):
        bn, ref = (F32BatchNorm2d(64, device=dev).train(train) for _ in range(2))
        got, want = bn(x), ref(x.float()).bfloat16()
        assert got.dtype == torch.bfloat16
        assert got.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(got.float(), want.float(), atol=2 ** -8, rtol=2 ** -7)
        torch.testing.assert_close(bn.running_var, ref.running_var, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_routes_on_the_card():
    """The bf16 ResNet-18 model at 64 x 64, B = 2: each route's launches
    (one soft-argmax call on the NHWC route, one conv-decode call on the
    fused route, none on the heatmap route, none for an f32 model's fused
    route) and its coordinates against the same route on the plain
    versions (atol 1e-3)."""
    from pose3d_tpu_torch.ops.heatmap import soft_argmax_3d_nhwc

    dev = cuda_device()
    model = PoseNet3D("resnet18", device="cpu").init_weights(torch.Generator().manual_seed(0))
    model.final_layer.weight.data.mul_(16)
    model = model.to(dev, torch.bfloat16).eval()
    x = torch.from_numpy(_frames(2)).to(dev)
    kernels = (softargmax.soft_argmax_3d_nhwc_kernel, conv_decode.conv_soft_argmax_3d_fused)
    with torch.no_grad():
        feats = model.features(x)
        nhwc = model.final_layer(feats).permute(0, 2, 3, 1)
        plain = soft_argmax_3d_nhwc(nhwc, 17, 64)
        plain_fused = conv_decode.conv_soft_argmax_3d_reference(
            feats.permute(0, 2, 3, 1), model.final_layer.weight.view(17 * 64, -1),
            model.final_layer.bias.float(), 17, 64)
        for route, expect, want in (("heatmap", (0, 0), plain), ("nhwc", (1, 0), plain),
                                    ("fused", (0, 1), plain_fused)):
            model.return_heatmap = route == "heatmap"
            model.fuse_final_conv = route == "fused"
            before = [k.launches for k in kernels]
            coords, _ = model(x)
            torch.cuda.synchronize()
            assert tuple(k.launches - b for k, b in zip(kernels, before)) == expect, route
            torch.testing.assert_close(coords, want, atol=1e-3, rtol=0)
        model32 = model.float()
        before = [k.launches for k in kernels]
        model32(x)
        assert [k.launches for k in kernels] == before

