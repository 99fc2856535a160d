"""Gradients of the port's ``PoseNet3D`` on every decode route, in train
and in eval mode, against ``jax.grad`` of the flax model: the kernel
routes differentiate (their autograd Functions run the plain backwards on
the CPU), as the JAX ``custom_vjp`` routes do.

ResNet-18, 64 x 64 frames, B = 2, the flax weights of
``torch_port_util.flax_posenet`` (seeded biases and BN statistics, the
final conv x32 so that the coordinates spread; std >= 0.1 asserted), MSE
against seeded poses. The JAX side: ``PoseNet3D(dtype=...)`` with f32
parameters, its fused route through the Pallas kernel in interpret mode;
the port's: the f32 model, and for bf16 the same f32 model under
``torch.autocast`` (``image_steps.bf16_apply``). Tolerances:

- f32: every parameter's gradient within relative L2 1e-3 of the JAX
  one (measured up to 5.1e-4 in train mode, where the JAX BatchNorm takes
  the f32 variance as E[x²] − E[x]² and torch in another way; up to
  1.2e-4 in eval mode); the loss within rtol 1e-5;
- bf16: two bf16 computations differ by where they round, and train-mode
  BatchNorm over a few pixels amplifies that (both the port's and the
  JAX bf16 gradients lie ~0.7 in relative L2 from the f32 ones in train
  mode, ~0.06 in eval mode). So each is held to the JAX f32 gradient as
  a yardstick: the port's error at most 1.5x the JAX bf16 gradient's per
  parameter (floor 2^-8) and 1.25x over all parameters together
  (measured up to 1.31x and 1.04x).
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_util import flax_posenet, torch_posenet

from pose3d_tpu_torch.interop.weights import posenet3d_from_flax
from pose3d_tpu_torch.train.image_steps import bf16_apply

torch.set_num_threads(2)

ROUTES = {
    "heatmap": {},
    "nhwc": {"return_heatmap": False},
    "fused": {"return_heatmap": False, "fuse_final_conv": True},
}
F32_REL = 1e-3
BF16_RATIO, BF16_GLOBAL_RATIO, BF16_FLOOR = 1.5, 1.25, 2 ** -8
MIN_SPREAD = 0.1


def _batch():
    rng = np.random.default_rng(3)
    return (rng.random((2, 64, 64, 3)).astype(np.float32),
            (rng.standard_normal((2, 17, 3)) * 0.4).astype(np.float32))


@functools.cache
def jax_grads(route: str, train: bool, dtype: str):
    """(loss, the port's parameter names -> numpy gradient) of the flax
    model's MSE, through ``posenet3d_from_flax``."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet3D

    params, stats = flax_posenet("resnet18")
    x, y = _batch()
    model = PoseNet3D(architecture="resnet18", dtype=getattr(jnp, dtype), **ROUTES[route])

    def loss(p):
        variables = {"params": p, "batch_stats": stats}
        if train:
            (coords, _), _ = model.apply(variables, x, train=True, mutable=["batch_stats"])
        else:
            coords, _ = model.apply(variables, x, train=False)
        return ((coords.reshape(y.shape) - y) ** 2).mean()

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    sd = posenet3d_from_flax(jax.tree.map(np.asarray, grads), stats)
    return float(value), {k: v.numpy().astype(np.float64) for k, v in sd.items()}


def port_grads(route: str, train: bool, dtype: str, **fields):
    """(loss, coordinates, parameter name -> numpy gradient) of the port."""
    params, stats = flax_posenet("resnet18")
    x, y = _batch()
    model = torch_posenet(params, stats, architecture="resnet18", **ROUTES[route],
                          **fields).train(train)
    apply = bf16_apply if dtype == "bfloat16" else (lambda m, t: m(t))
    coords, _ = apply(model, torch.from_numpy(x))
    loss = ((coords.reshape(y.shape) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    return loss.item(), coords.detach(), {n: p.grad.double().numpy()
                                          for n, p in model.named_parameters()}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_close_to_jax(got, route, train, dtype):
    """f32: each gradient within relative L2 F32_REL of the JAX one. bf16:
    as close to the JAX f32 gradients as the JAX bf16 gradients are."""
    _, ref = jax_grads(route, train, "float32")
    if dtype == "float32":
        worst = max(got, key=lambda n: _rel(got[n], ref[n]))
        assert _rel(got[worst], ref[worst]) <= F32_REL, worst
        return
    _, jax16 = jax_grads(route, train, "bfloat16")
    for name, g in got.items():
        assert np.isfinite(g).all(), name
        assert _rel(g, ref[name]) <= BF16_RATIO * max(_rel(jax16[name], ref[name]),
                                                      BF16_FLOOR), name
    names = sorted(got)
    flat = [np.concatenate([d[n].ravel() for n in names]) for d in (got, jax16, ref)]
    assert _rel(flat[0], flat[2]) <= BF16_GLOBAL_RATIO * _rel(flat[1], flat[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_gradients_match_jax(route, train, dtype):
    loss, coords, got = port_grads(route, train, dtype)
    assert coords.std() >= MIN_SPREAD
    assert set(got) <= set(jax_grads(route, train, "float32")[1])
    if dtype == "float32":
        np.testing.assert_allclose(loss, jax_grads(route, train, dtype)[0], rtol=1e-5)
    assert_close_to_jax(got, route, train, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nhwc_route_trains_through_the_kernel_wrapper_under_use_kernels_train(dtype,
                                                                              monkeypatch):
    """``use_kernels_train`` (JAX's ``use_pallas_train``) sends the NHWC
    route's training decode to the kernel wrapper, with bf16 logits under
    autocast (on the CPU its Function runs the plain backward); its
    gradients meet the same bounds."""
    from pose3d_tpu_torch.ops import softargmax

    calls = []
    real = softargmax.soft_argmax_3d_nhwc_kernel
    monkeypatch.setattr(softargmax, "soft_argmax_3d_nhwc_kernel",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    _, _, got = port_grads("nhwc", True, dtype, use_kernels_train=True)
    assert calls == [getattr(torch, dtype)]  # under autocast the logits are bf16
    port_grads("nhwc", True, dtype)
    assert len(calls) == 1
    assert_close_to_jax(got, "nhwc", True, dtype)
