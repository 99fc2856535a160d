"""The port's LifterService (``pose3d_tpu_torch/serving.py``): bucketed
inference equals the model, any N is served, and the fused gate follows
the trunk kernel's tile.

On the CPU a bf16 default-architecture model serves through the plain
trunk path and is held to the same path called directly (bit-equal: the
same computation on the same padded batch, padding rows never mix into
real ones) and to the bf16 module (5e-2, the bf16 budget). The tests
marked ``cuda`` serve through the Hopper kernel and skip without a card.
"""

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, flax_vit, torch_vit

from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.ops import lifter as L
from pose3d_tpu_torch.serving import LifterService, fused_vit_buckets_ok

torch.set_num_threads(2)


def _kp(n, seed=0):
    return np.random.default_rng(seed).random((n, 17, 2)).astype(np.float32)


def _module(model, kp):
    with torch.no_grad():
        return model(torch.from_numpy(kp)).numpy()


def _fused(model, kp):
    """lifter_forward_fused on kp zero-padded to its service bucket."""
    n = len(kp)
    b = max(64, 1 << (n - 1).bit_length())
    x = torch.zeros(b, 17, 2)
    x[:n] = torch.from_numpy(kp)
    with torch.no_grad():
        return L.lifter_forward_fused(model, x)[:n].numpy()


@pytest.fixture(scope="module")
def narrow():
    """The JAX package's serving-test model: hidden 64, 1 block, 2 heads,
    f32, so it runs the module forward."""
    fields = {"hidden": 64, "n_blocks": 1, "heads": 2}
    fmodel, params = flax_vit(seed=0, **fields)
    model = torch_vit(params, **fields)
    svc = LifterService(model, None, device="cpu", max_batch=128, min_bucket=32)
    return fmodel, params, model, svc


@pytest.fixture(scope="module")
def fused_svc():
    model = JointTransformerLifter(device="cpu").init_weights(
        torch.Generator().manual_seed(0)).to(torch.bfloat16)
    return model, LifterService(model, None, device="cpu", max_batch=128,
                                min_bucket=64)


class TestModuleRoute:
    @pytest.mark.parametrize("n", [1, 33, 128, 200])
    def test_matches_module(self, narrow, n):
        """f32 GEMMs of another batch shape sum in another order: 1e-5."""
        _, _, model, svc = narrow
        assert not svc.fused
        kp = _kp(n, seed=n)
        got = svc.lift(kp)
        assert got.shape == (n, 17, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, _module(model, kp), atol=1e-5, rtol=0)

    def test_matches_flax(self, narrow):
        fmodel, params, _, svc = narrow
        kp = _kp(50, seed=2)
        want = np.asarray(fmodel.apply({"params": params}, kp, train=False))
        np.testing.assert_allclose(svc.lift(kp), want, atol=1e-4, rtol=0)

    def test_padding_does_not_leak(self, narrow):
        """A 33-frame request equals the first 33 frames of a full 64."""
        _, _, _, svc = narrow
        kp = _kp(64, seed=5)
        np.testing.assert_array_equal(svc.lift(kp[:33]), svc.lift(kp)[:33])

    def test_rejects_malformed_requests(self, narrow):
        svc = narrow[3]
        for bad in (np.zeros((3, 17, 3)), np.zeros((3, 16, 2)), np.zeros((17, 2))):
            with pytest.raises(ValueError, match="kp2d must be"):
                svc.lift(bad)

    def test_warmup_returns_self(self, narrow):
        svc = narrow[3]
        assert svc.warmup() is svc
        assert svc.buckets == [32, 64, 128]

    def test_f32_default_model_keeps_f32(self):
        model = JointTransformerLifter(device="cpu").init_weights(
            torch.Generator().manual_seed(3))
        svc = LifterService(model, None, device="cpu", max_batch=64)
        assert not svc.fused
        kp = _kp(64)
        np.testing.assert_array_equal(svc.lift(kp), _module(model, kp))

    def test_loads_state_dict_strictly(self, narrow):
        _, _, model, _ = narrow
        sd = dict(model.state_dict())
        other = JointTransformerLifter(hidden=64, n_blocks=1, heads=2, device="cpu")
        svc = LifterService(other, sd, device="cpu", max_batch=64)
        kp = _kp(64)
        np.testing.assert_array_equal(svc.lift(kp), _module(model, kp))
        sd["extra"] = torch.zeros(1)
        with pytest.raises(RuntimeError, match="extra"):
            LifterService(other, sd, device="cpu")


class TestFusedRoute:
    @pytest.mark.parametrize("n", [1, 33, 128, 200])
    def test_matches_plain_path_and_module(self, fused_svc, n):
        model, svc = fused_svc
        assert svc.fused
        kp = _kp(n, seed=n)
        got = svc.lift(kp)
        assert got.shape == (n, 17, 3)
        # the plain path on the same padded batches, called directly
        want = np.concatenate([
            _fused(model, kp[i:i + 128]) for i in range(0, n, 128)])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, _module(model, kp), atol=5e-2, rtol=0)

    def test_padding_does_not_leak(self, fused_svc):
        _, svc = fused_svc
        kp = _kp(64, seed=9)
        np.testing.assert_array_equal(svc.lift(kp[:33]), svc.lift(kp)[:33])

    def test_opt_out_runs_the_module(self, fused_svc):
        model, _ = fused_svc
        svc = LifterService(model, None, device="cpu", max_batch=64,
                            use_fused_vit=False)
        assert not svc.fused
        kp = _kp(64)
        np.testing.assert_array_equal(svc.lift(kp), _module(model, kp))


def test_fused_gate_matches_kernel_contract():
    """The gate accepts exactly the bucket sizes the trunk accepts: the
    gate reads the kernel's tile constant, so changing FRAMES_PER_CTA
    cannot let a bucket through that the kernel then refuses."""
    model = JointTransformerLifter(device="cpu").to(torch.bfloat16)
    weights = L.pack_weights(model)
    for bucket in (1, 2, 3, 16, 17, 33, 64, 96):
        tokens = torch.zeros(bucket * 17, 256, dtype=torch.bfloat16)
        try:
            L._check_operands(tokens, model.pe, weights)
            accepted = True
        except ValueError:
            accepted = False
        assert fused_vit_buckets_ok([bucket]) == accepted, bucket
        assert accepted == (bucket % L.FRAMES_PER_CTA == 0)
    assert fused_vit_buckets_ok([64 * 2 ** i for i in range(8)])


@pytest.mark.parametrize("field", [{"heads": 8}, {"n_blocks": 1}, {"class_token": True},
                                   {"in_dim": 3, "out_dim": 2}])
def test_gate_takes_only_the_default_architecture(field):
    """bf16 models that differ from the default in any field the kernel
    bakes in run their module forward."""
    model = JointTransformerLifter(**field, device="cpu").to(torch.bfloat16)
    assert not LifterService(model, None, device="cpu", max_batch=64).fused
    assert LifterService(JointTransformerLifter(device="cpu").to(torch.bfloat16),
                         None, device="cpu", max_batch=64).fused


def test_cuda_service_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = JointTransformerLifter(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LifterService(model, None, device="cuda")


@pytest.mark.cuda
def test_service_serves_through_the_kernel():
    dev = cuda_device()
    model = JointTransformerLifter(device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    f32 = JointTransformerLifter(device=dev)
    f32.load_state_dict(model.state_dict())
    svc = LifterService(model.to(torch.bfloat16), None, device=dev,
                        max_batch=256).warmup()
    assert svc.fused
    kp = _kp(300, seed=1)
    before = L.trunk.launches
    got = svc.lift(kp)
    assert L.trunk.launches == before + 2  # 256 + a 64-bucket tail
    with torch.no_grad():
        want = f32(torch.from_numpy(kp).to(dev)).cpu().numpy()
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
