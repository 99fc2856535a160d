"""The port's Martinez and AE lifters, their weight bridge, and the fused
Martinez block (``pose3d_tpu_torch/ops/martinez.py``) against the JAX
package.

One set of seeded numpy inputs and flax weights, whose biases, BN scales
and BN statistics are seeded too (``torch_port_util.flax_bn_lifter``),
goes through the flax module or the JAX fused functions (Pallas in
interpret mode) and through the port. Tolerances:

- f32 modules vs flax apply: 1e-4 (the same math, f32 sums in another
  order);
- the plain block vs the JAX kernel in f32: 1e-5, as
  ``tests/test_pallas_martinez.py``; in bf16 at F = 1024: one bf16 step
  of the value (2^-8 + 2^-7 |want|), since both round at the same points
  and only the f32 summation order differs;
- the plain fused inference vs the JAX one in bf16: 5e-2, the JAX
  package's bf16 budget (outputs reach |4|, where one bf16 step of the
  output product is 2^-6).

Tests marked ``cuda`` run the Hopper kernel and skip without a card.
"""

import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import cuda_device, flax_apply, flax_bn_lifter, torch_bn_lifter

from pose3d_tpu_torch.models.lifters import AELifter, F32BatchNorm1d, MartinezLifter
from pose3d_tpu_torch.ops import martinez as M

torch.set_num_threads(2)

F32_ATOL = 1e-4
BF16_ATOL = 5e-2

CONFIGS = {  # (kind, fields)
    "martinez": ("martinez", {}),
    "martinez_narrow": ("martinez", {"hidden": 64}),
    "martinez_3_stages": ("martinez", {"hidden": 64, "num_stages": 3}),
    "martinez_no_bn": ("martinez", {"hidden": 64, "use_bn": False}),
    "ae": ("ae", {}),
    "ae_narrow": ("ae", {"hidden": 64}),
}


def _kp(n, seed=0):
    return np.random.default_rng(seed).random((n, 17, 2)).astype(np.float32)


def _block_operands(f, b, seed):
    """Seeded block operands as numpy (x, w1, s1, b1, w2, s2, b2)."""
    rng = np.random.default_rng(seed)
    w = lambda: (rng.standard_normal((f, f)) * f ** -0.5).astype(np.float32)
    vec = lambda lo: (lo + rng.random(f)).astype(np.float32)
    x = rng.standard_normal((b, f)).astype(np.float32)
    return x, w(), vec(0.5), vec(-0.5), w(), vec(0.5), vec(-0.5)


def _torch_operands(ops, dtype):
    """numpy block operands -> torch, x and the matrices in ``dtype``."""
    return [torch.from_numpy(a).to(dtype if a.ndim == 2 else torch.float32) for a in ops]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_module_matches_flax_f32(name):
    kind, fields = CONFIGS[name]
    fmodel, params, stats = flax_bn_lifter(kind, seed=0, **fields)
    tmodel = torch_bn_lifter(kind, params, stats, **fields)
    kp = _kp(32, seed=7)
    want = flax_apply(fmodel, params, kp, stats)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(kp))
        flat = tmodel(torch.from_numpy(kp.reshape(32, 34)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (32, 51)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
    np.testing.assert_array_equal(flat.numpy(), got.numpy())


@pytest.mark.parametrize("kind,stages", [("martinez", 2), ("martinez", 3), ("ae", None)])
def test_weights_equal_the_jax_package_export(kind, stages):
    """martinez_lifter_from_flax / ae_lifter_from_flax == the JAX package's
    martinez_to_torch / ae_to_torch, key for key and bit for bit, and the
    port's module takes them strictly."""
    from pose3d_tpu.interop.torch_weights import ae_to_torch, martinez_to_torch

    from pose3d_tpu_torch.interop.weights import ae_lifter_from_flax, martinez_lifter_from_flax

    fields = {"hidden": 64} | ({"num_stages": stages} if stages else {})
    _, params, stats = flax_bn_lifter(kind, seed=3, **fields)
    variables = {"params": params, "batch_stats": stats}
    if kind == "martinez":
        got, want = martinez_lifter_from_flax(params, stats), martinez_to_torch(variables, stages)
        model = MartinezLifter(**fields, device="cpu")
    else:
        got, want = ae_lifter_from_flax(params, stats), ae_to_torch(variables)
        model = AELifter(**fields, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].is_contiguous()
        assert got[k].dtype == (torch.int64 if k.endswith("num_batches_tracked")
                                else torch.float32)
    model.load_state_dict(got, strict=True)
    assert set(model.state_dict()) == set(want)


def test_bridge_reads_stages_and_bn_from_the_tree():
    from pose3d_tpu_torch.interop.weights import martinez_lifter_from_flax

    _, params, _ = flax_bn_lifter("martinez", hidden=64, num_stages=3, use_bn=False)
    sd = martinez_lifter_from_flax(params)
    assert not any("batch_norm" in k for k in sd)
    assert {k.split(".")[1] for k in sd if k.startswith("linear_stages.")} == {"0", "1", "2"}
    MartinezLifter(hidden=64, num_stages=3, use_bn=False, device="cpu").load_state_dict(
        sd, strict=True)


def test_batch_norm_train_step_matches_the_jax_package():
    """Train mode (dropout 0): batch statistics normalise, and the running
    variance takes the unbiased batch variance with momentum 0.1, as the
    JAX package's BatchNorm (models/norm.py) does with its 0.9."""
    fmodel, params, stats = flax_bn_lifter("martinez", seed=4, hidden=64, dropout=0.0)
    tmodel = torch_bn_lifter("martinez", params, stats, hidden=64, dropout=0.0).train()
    kp = _kp(16, seed=8)
    want, updated = fmodel.apply({"params": params, "batch_stats": stats}, kp, train=True,
                                 mutable=["batch_stats"])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(kp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)
    new = updated["batch_stats"]
    pairs = [(tmodel.batch_norm1, new["BatchNorm_0"])]
    for i, stage in enumerate(tmodel.linear_stages):
        pairs += [(stage.batch_norm1, new[f"MartinezBlock_{i}"]["BatchNorm_0"]),
                  (stage.batch_norm2, new[f"MartinezBlock_{i}"]["BatchNorm_1"])]
    for bn, s in pairs:
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]), atol=1e-5)


class TestParityHazards:
    def test_batch_norm_stays_f32_in_a_bf16_model(self):
        model = MartinezLifter(hidden=64, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        var = model.batch_norm1.running_var.clone()
        for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.bfloat16(),
                     lambda m: m.half(), lambda m: m.to("cpu", torch.bfloat16)):
            cast(model)
            norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm1d)]
            assert len(norms) == 5 and all(m.eps == 1e-5 and m.momentum == 0.1 for m in norms)
            for bn in norms:
                assert all(t.dtype == torch.float32 for t in
                           (bn.weight, bn.bias, bn.running_mean, bn.running_var))
            assert model.dtype != torch.float32
            assert torch.equal(model.batch_norm1.running_var, var)  # never rounded
        model.float()
        assert model.dtype == torch.float32

    def test_f32_batch_norm_on_bf16_rows(self):
        """bf16 in, bf16 out, f32 inside, as the flax BatchNorm."""
        bn = F32BatchNorm1d(8, device="cpu").eval()
        nn.init.normal_(bn.running_mean)
        x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1)).bfloat16()
        got = bn(x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, bn(x.float()).bfloat16())

    def test_dropout_only_in_training(self):
        model = MartinezLifter(hidden=64, device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        x = torch.from_numpy(_kp(8))
        with torch.no_grad():
            model.eval()
            assert torch.equal(model(x), model(x))
            model.train()
            torch.manual_seed(0)
            a = model(x)
            assert not torch.equal(a, model(x))

    def test_ae_has_no_tanh_and_no_bn_switch(self):
        model = AELifter(hidden=64, device="cpu").init_weights(torch.Generator().manual_seed(2))
        assert not any(isinstance(m, nn.Tanh) for m in model.modules())
        assert isinstance(model.decoder2[-1], nn.Linear)
        with torch.no_grad():
            assert model.eval()(torch.from_numpy(_kp(64))).abs().max() > 1.0
        plain = MartinezLifter(hidden=64, use_bn=False, device="cpu")
        assert not any(isinstance(m, nn.BatchNorm1d) for m in plain.modules())

    def test_init_weights_is_seeded_with_real_statistics(self):
        def draw(seed):
            model = MartinezLifter(hidden=64, device="cpu")
            return model.init_weights(torch.Generator().manual_seed(seed)).state_dict()

        a, b, c = draw(5), draw(5), draw(6)
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["w1.bias"], c["w1.bias"])
        for k, v in a.items():
            if k.endswith("running_var"):
                assert (v >= 0.5).all() and (v < 1.5).all() and (v != 1).all(), k
            elif k.endswith("running_mean") or k.endswith("bias"):
                assert (v != 0).all(), k


def test_fold_bn_equals_the_jax_package():
    import jax.numpy as jnp

    from pose3d_tpu.ops.pallas_martinez import fold_bn

    _, params, stats = flax_bn_lifter("martinez", seed=5, hidden=64)
    model = torch_bn_lifter("martinez", params, stats, hidden=64)
    scale, shift = M.fold_bn(model.w1.bias, model.batch_norm1)
    want = fold_bn(jnp.asarray(params["Dense_0"]["bias"]), params["BatchNorm_0"],
                   stats["BatchNorm_0"])
    assert scale.dtype == shift.dtype == torch.float32
    np.testing.assert_allclose(scale.detach().numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_allclose(shift.detach().numpy(), np.asarray(want[1]), rtol=1e-6,
                               atol=1e-7)


class TestBlock:
    def test_plain_block_matches_jax_kernel_f32(self):
        """tests/test_pallas_martinez.py's shapes: F = 256, B = 64."""
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_martinez import fused_residual_block

        ops = _block_operands(256, 64, seed=0)
        want = fused_residual_block(*map(jnp.asarray, ops), interpret=True)
        got = M.fused_residual_block(*_torch_operands(ops, torch.float32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    def test_plain_block_matches_jax_kernel_bf16(self):
        """The kernel's width and dtype: F = 1024, B = 64, bf16 rows and
        weights, f32 scale and shift."""
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_martinez import fused_residual_block

        ops = _block_operands(M.WIDTH, 64, seed=1)
        jops = [jnp.asarray(a, jnp.bfloat16 if a.ndim == 2 else jnp.float32) for a in ops]
        want = np.asarray(fused_residual_block(*jops, interpret=True).astype(jnp.float32))
        got = M.fused_residual_block(*_torch_operands(ops, torch.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -8, rtol=2 ** -7)

    def test_rows_are_independent_and_any_batch_is_taken(self):
        ops = _torch_operands(_block_operands(128, 7, seed=2), torch.bfloat16)
        full = M.fused_residual_block(*ops)
        for lo, hi in ((0, 1), (2, 7)):
            part = M.fused_residual_block(ops[0][lo:hi], *ops[1:])
            assert torch.equal(part, full[lo:hi])
        assert M.fused_residual_block(ops[0][:0], *ops[1:]).shape == (0, 128)

    def test_rejects_bad_operands(self):
        ops = _torch_operands(_block_operands(64, 4, seed=3), torch.float32)
        with pytest.raises(ValueError, match="w2 must be"):
            M.fused_residual_block(*ops[:4], ops[4][:32], *ops[5:])
        with pytest.raises(ValueError, match="x must be"):
            M.fused_residual_block(ops[0][None], *ops[1:])

    def test_other_device_raises(self):
        ops = [t.to("meta") for t in _torch_operands(_block_operands(64, 4, seed=4),
                                                     torch.bfloat16)]
        with pytest.raises(ValueError, match="no Martinez block kernel for device meta"):
            M.fused_residual_block(*ops)


class TestFusedInference:
    @pytest.mark.parametrize("stages,batch", [(2, 64), (2, 96), (3, 96)])
    def test_plain_fused_matches_jax_fused_bf16(self, stages, batch):
        """Packed from the f32 model in bf16, as build_fused_params packs
        the flax tree: the same operands, so only the summation order
        differs."""
        import jax.numpy as jnp

        from pose3d_tpu.ops.pallas_martinez import build_fused_params, martinez_infer_fused

        _, params, stats = flax_bn_lifter("martinez", seed=1, num_stages=stages)
        model = torch_bn_lifter("martinez", params, stats, num_stages=stages)
        fused = M.pack_martinez(model)
        assert len(fused.blocks) == stages
        kp = _kp(batch, seed=batch)
        want = martinez_infer_fused(build_fused_params(params, stats, num_stages=stages),
                                    jnp.asarray(kp), interpret=True)
        got = M.martinez_infer_fused(fused, torch.from_numpy(kp))
        assert got.dtype == torch.float32 and got.shape == (batch, 51)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_ATOL, rtol=0)

    def test_f32_fused_equals_the_module(self):
        """In f32 the fused inference is the module with BN folded (the
        JAX package's test_exact_parity_with_flax_eval: 1e-5)."""
        model = MartinezLifter(hidden=64, num_stages=3, device="cpu").init_weights(
            torch.Generator().manual_seed(7)).eval()
        fused = M.pack_martinez(model, torch.float32)
        x = torch.from_numpy(_kp(96, seed=3))
        with torch.no_grad():
            np.testing.assert_allclose(M.martinez_infer_fused(fused, x).numpy(),
                                       model(x).numpy(), atol=1e-5, rtol=0)

    def test_pack_layout_and_gate(self):
        model = MartinezLifter(device="cpu").init_weights(torch.Generator().manual_seed(0))
        model = model.to(torch.bfloat16)
        fused = M.pack_martinez(model)
        w1, s1, b1, w2, s2, b2 = fused.blocks[1]
        assert torch.equal(w2, model.linear_stages[1].w2.weight.t())
        assert w1.is_contiguous() and w1.dtype == torch.bfloat16
        assert fused.w_in.shape == (34, 1024) and fused.w_out.shape == (1024, 51)
        assert all(t.dtype == torch.float32 for t in (s1, b1, s2, b2, fused.b_out))
        assert M.supports(model)
        for other in (MartinezLifter(hidden=512, device="cpu"),
                      MartinezLifter(use_bn=False, device="cpu"), AELifter(device="cpu")):
            assert not M.supports(other)
        with pytest.raises(ValueError, match="with BatchNorm"):
            M.pack_martinez(MartinezLifter(hidden=64, use_bn=False, device="cpu"))


def _tolerance_excess(got, want):
    return ((got.float() - want.float()).abs()
            - (5e-2 + 2 ** -5 * want.float().abs())).max().item()


def _block_f64(x, w1, s1, b1, w2, s2, b2):
    """The block in float64 throughout (h not rounded): a yardstick."""
    x = x.double()
    h = torch.relu(x @ w1.double() * s1.double() + b1.double())
    return x + torch.relu(h @ w2.double() * s2.double() + b2.double())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card():
    """Rows: 5e-2 + 2^-5 |want| (chip_smoke.py's bound for bf16 rows), the
    kernel's error against an f32 block at most 1.5x the plain version's,
    and against a float64 block at most 1.5x the plain version's + 2^-16
    of the largest float64 value; a ragged batch; row isolation; one count
    per call."""
    dev = cuda_device()
    for batch in (64, 200):
        ops = [t.to(dev) for t in _torch_operands(_block_operands(M.WIDTH, batch, seed=5),
                                                  torch.bfloat16)]
        before = M.fused_residual_block.launches
        got = M.fused_residual_block(*ops)
        torch.cuda.synchronize()
        assert M.fused_residual_block.launches == before + 1
        want = M.fused_residual_block_reference(*ops)
        ref32 = M.fused_residual_block_reference(ops[0].float(), ops[1].float(), ops[2],
                                                 ops[3], ops[4].float(), ops[5], ops[6])
        assert torch.isfinite(got).all() and _tolerance_excess(got, want) <= 0
        err = (got.float() - ref32).abs().max().item()
        assert err <= 1.5 * (want.float() - ref32).abs().max().item()
        ref64 = _block_f64(*ops)
        err64 = (got.double() - ref64).abs().max().item()
        assert err64 <= (1.5 * (want.double() - ref64).abs().max().item()
                         + 2 ** -16 * ref64.abs().max().item())
    pert = ops[0].clone()
    pert[3] += 1.0
    out = M.fused_residual_block(pert, *ops[1:])
    assert torch.equal(out[:3], got[:3]) and torch.equal(out[4:], got[4:])
    assert not torch.equal(out[3], got[3])


@pytest.mark.cuda
def test_kernel_rejects_f32_operands():
    dev = cuda_device()
    ops = [t.to(dev) for t in _torch_operands(_block_operands(M.WIDTH, 16, seed=6),
                                              torch.float32)]
    with pytest.raises(TypeError, match="bfloat16"):
        M.fused_residual_block(*ops)
