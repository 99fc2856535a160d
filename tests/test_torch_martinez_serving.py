"""The port's LifterService on the Martinez and AE lifters: the fused
Martinez route and the module route, against the JAX package.

- A bf16 MartinezLifter (BatchNorm, hidden 1024) takes the fused route:
  on the CPU the plain block, held bit for bit to ``martinez_infer_fused``
  called directly on the same padded batch, and to the JAX fused function
  (Pallas in interpret mode) at 5e-2, the JAX package's bf16 budget (the
  port's bf16 model has its Linear biases in bf16, the JAX packing keeps
  them f32, and f32 sums run in another order).
- Every stage is served: a three-stage model runs three blocks per batch
  (the JAX service would fold two, ``pallas_martinez.build_fused_params``'s
  default).
- f32 Martinez models and AE models take the module route and match the
  flax apply at 1e-5, as ``tests/test_serving.py`` holds the JAX service.

The test marked ``cuda`` serves through the Hopper kernel and skips
without a card.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, flax_apply, flax_bn_lifter, torch_bn_lifter

from pose3d_tpu_torch.models.lifters import AELifter, MartinezLifter
from pose3d_tpu_torch.ops import martinez as M
from pose3d_tpu_torch.serving import LifterService

torch.set_num_threads(2)

BF16_ATOL = 5e-2


def _kp(n, seed=0):
    return np.random.default_rng(seed).random((n, 17, 2)).astype(np.float32)


def _padded(kp, bucket):
    x = torch.zeros(bucket, 17, 2)
    x[:len(kp)] = torch.from_numpy(kp)
    return x


@pytest.fixture(scope="module")
def bf16_martinez():
    """(flax model, params, batch_stats, the port's bf16 model, its service)."""
    fmodel, params, stats = flax_bn_lifter("martinez", seed=0)
    model = torch_bn_lifter("martinez", params, stats, dtype=torch.bfloat16)
    return fmodel, params, stats, model, LifterService(model, None, device="cpu",
                                                       max_batch=128, min_bucket=64)


class TestFusedRoute:
    @pytest.mark.parametrize("n", [1, 33, 200])
    def test_matches_the_fused_function_and_jax(self, bf16_martinez, n):
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_martinez import build_fused_params, martinez_infer_fused

        _, params, stats, model, svc = bf16_martinez
        assert svc.fused
        kp = _kp(n, seed=n)
        got = svc.lift(kp)
        assert got.shape == (n, 17, 3) and got.dtype == np.float32
        fused = M.pack_martinez(model)
        chunks = [kp[i:i + 128] for i in range(0, n, 128)]
        with torch.no_grad():
            direct = np.concatenate([M.martinez_infer_fused(
                fused, _padded(c, svc._bucket(len(c))))[:len(c)].numpy() for c in chunks])
        np.testing.assert_array_equal(got, direct.reshape(n, 17, 3))
        want = martinez_infer_fused(build_fused_params(params, stats), jnp.asarray(kp),
                                    interpret=True)
        np.testing.assert_allclose(got, np.asarray(want).reshape(n, 17, 3),
                                   atol=BF16_ATOL, rtol=0)

    def test_close_to_f32_flax_apply(self, bf16_martinez):
        """bf16 vs f32: 0.1, the JAX package's test_close_to_f32_flax_apply."""
        fmodel, params, stats, _, svc = bf16_martinez
        kp = _kp(50, seed=2)
        want = flax_apply(fmodel, params, kp, stats).reshape(50, 17, 3)
        np.testing.assert_allclose(svc.lift(kp), want, atol=0.1, rtol=0)

    def test_padding_does_not_leak(self, bf16_martinez):
        svc = bf16_martinez[4]
        kp = _kp(64, seed=9)
        np.testing.assert_array_equal(svc.lift(kp[:33]), svc.lift(kp)[:33])

    def test_serves_every_stage(self, monkeypatch):
        """num_stages=3: three blocks per batch, and the answer is the JAX
        fused function's with all three stages folded, not two."""
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_martinez import build_fused_params, martinez_infer_fused

        _, params, stats = flax_bn_lifter("martinez", seed=1, num_stages=3)
        model = torch_bn_lifter("martinez", params, stats, dtype=torch.bfloat16,
                                num_stages=3)
        svc = LifterService(model, None, device="cpu", max_batch=64)
        assert svc.fused
        calls = []
        block = M.fused_residual_block
        monkeypatch.setattr(M, "fused_residual_block",
                            lambda *a: calls.append(a[0].shape) or block(*a))
        kp = _kp(40, seed=4)
        got = svc.lift(kp)
        assert calls == [(64, 1024)] * 3
        want3, want2 = (np.asarray(martinez_infer_fused(
            build_fused_params(params, stats, num_stages=k), jnp.asarray(kp),
            interpret=True)).reshape(40, 17, 3) for k in (3, 2))
        np.testing.assert_allclose(got, want3, atol=BF16_ATOL, rtol=0)
        assert np.abs(got - want2).max() > 10 * BF16_ATOL

    def test_warmup_and_buckets(self, bf16_martinez):
        svc = bf16_martinez[4]
        assert svc.warmup() is svc
        assert svc.buckets == [64, 128]
        assert svc.in_shape == (17, 2) and svc.out_shape == (17, 3)


@pytest.mark.parametrize("kind,fields", [
    ("martinez", {"hidden": 64}),
    ("martinez", {"hidden": 64, "num_stages": 3, "use_bn": False}),
    ("ae", {"hidden": 64}),
    ("ae", {}),
])
def test_module_route_matches_flax(kind, fields):
    """f32 models run their module forward: 1e-5, as tests/test_serving.py
    holds the JAX service to the flax apply."""
    fmodel, params, stats = flax_bn_lifter(kind, seed=2, **fields)
    model = torch_bn_lifter(kind, params, stats, **fields)
    svc = LifterService(model, None, device="cpu", max_batch=64, min_bucket=32)
    assert not svc.fused
    kp = _kp(40, seed=6)
    want = flax_apply(fmodel, params, kp, stats).reshape(40, 17, 3)
    np.testing.assert_allclose(svc.lift(kp), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cls,fields", [
    (MartinezLifter, {"hidden": 512}),
    (MartinezLifter, {"use_bn": False}),
    (AELifter, {}),
], ids=["hidden_512", "no_bn", "ae"])
def test_gate_takes_only_bf16_martinez_with_bn_at_1024(cls, fields):
    """bf16 models the kernel cannot take run their module forward; the
    default bf16 Martinez is fused unless the caller opts out."""
    model = cls(**fields, device="cpu", dtype=torch.bfloat16)
    assert not LifterService(model, None, device="cpu", max_batch=64).fused
    default = MartinezLifter(device="cpu")
    assert not LifterService(default, None, device="cpu", max_batch=64).fused  # f32
    default = default.to(torch.bfloat16)
    assert LifterService(default, None, device="cpu", max_batch=64).fused
    assert not LifterService(default, None, device="cpu", max_batch=64,
                             use_fused_martinez=False).fused


def test_rejects_malformed_requests_and_widths():
    svc = LifterService(AELifter(hidden=64, device="cpu"), None, device="cpu", max_batch=64)
    for bad in (np.zeros((3, 17, 3)), np.zeros((3, 34)), np.zeros((17, 2))):
        with pytest.raises(ValueError, match="kp2d must be"):
            svc.lift(bad)
    with pytest.raises(ValueError, match="split over 17 joints"):
        LifterService(MartinezLifter(in_dim=30, hidden=64, device="cpu"), None, device="cpu")


@pytest.mark.cuda
def test_service_serves_martinez_through_the_kernel():
    dev = cuda_device()
    model = MartinezLifter(device="cpu").init_weights(torch.Generator().manual_seed(0))
    f32 = MartinezLifter(device=dev)
    f32.load_state_dict(model.state_dict())
    svc = LifterService(model.to(torch.bfloat16), None, device=dev, max_batch=256).warmup()
    assert svc.fused
    kp = _kp(300, seed=1)
    before = M.fused_residual_block.launches
    got = svc.lift(kp)
    assert M.fused_residual_block.launches == before + 4  # 2 blocks x (256 + a 64 tail)
    with torch.no_grad():
        want = f32.eval()(torch.from_numpy(kp).to(dev)).cpu().numpy()
    np.testing.assert_allclose(got, want.reshape(300, 17, 3), atol=0.1, rtol=0)
