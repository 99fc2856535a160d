"""The port's direct-model train steps (``pose3d_tpu_torch/train/
image_steps.py``: ``make_direct_train_step``, ``make_direct_chunk_step``,
``bf16_apply``) and heatmap targets (``ops/heatmap.py``) against the JAX
package's, on the CPU: ResNet-18, 64 x 64 uint8 frames, B = 2, the flax
weights of ``torch_port_util.flax_posenet`` (coordinates that spread),
Adam with weight decay 1e-8 at lr 2^-10 (exact in f32 and f64), as
``cli/train_direct.py`` trains.

Tolerances:

- one float64 step against the JAX step in float64 (x64 on; the JAX
  NHWC route, its plain decode; the port on the NHWC route, on it with
  ``use_kernels_train`` and on the fused route, which compute the same
  function): loss rtol 1e-10; every gradient atol 1e-9 (convolution
  gradients summed over 2 x 64^2 positions in other orders); the
  parameters after the step atol 1e-8 (Adam's first step is
  -lr·g/(|g| + eps): a gradient near eps moves by up to lr·δg/eps); the
  BatchNorm running mean and (unbiased) variance atol 1e-10;
- one f32 step (the NHWC and the fused route, the JAX fused route through
  its Pallas kernel in interpret mode): train-mode BatchNorm over two
  frames amplifies f32 rounding (the JAX one takes the variance as
  E[x²] − E[x]², torch in another way), so the port's and the JAX f32
  steps are each held to the JAX float64 step: the port's loss within
  rtol 1e-4 of it (measured 1.2e-5), its MPJPE sums within 1e-3
  (measured ~1e-4), each gradient no
  further from it (relative L2) than twice the JAX f32 step's, with a
  floor of 2e-3 (measured: the port's gradients up to 7.3e-4 from it,
  the JAX f32 ones up to 2.0e-2); the
  parameters after the step within 1e-6 where the float64 gradient
  exceeds 1e-3, else 2·lr + 1e-6 (Adam's first step is ±lr); running
  statistics atol 1e-4;
- the chunk step (K = 2) against ``make_direct_chunk_step`` in float64:
  losses and sums rtol 1e-10, parameters after both steps atol 1e-8,
  running statistics atol 1e-10;
- ``heatmap_targets`` against the JAX function: atol 1e-6; a heatmap-loss
  step (weight 0.5) in float64: loss rtol 1e-10.

Tests marked ``cuda`` run the train steps on the card and skip without
one.
"""

import functools

import numpy as np
import pytest
import torch

from torch_port_util import cuda_device, flax_posenet, torch_posenet

from pose3d_tpu_torch.interop.weights import posenet3d_from_flax
from pose3d_tpu_torch.models.heads import PoseNet3D
from pose3d_tpu_torch.ops import conv_decode, softargmax
from pose3d_tpu_torch.ops.heatmap import heatmap_targets, uvw_to_xyz, xyz_to_uvw
from pose3d_tpu_torch.train.image_steps import (bf16_apply, make_direct_chunk_step,
                                                make_direct_train_step)
from pose3d_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

LR = 2.0 ** -10
WD = 1e-8
ROUTES = {
    "heatmap": {},
    "nhwc": {"return_heatmap": False},
    "nhwc_kernels_train": {"return_heatmap": False, "use_kernels_train": True},
    "fused": {"return_heatmap": False, "fuse_final_conv": True},
}
MIN_SPREAD = 0.1


def _batches(k=1, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (k, 2, 64, 64, 3), dtype=np.uint8),
            (rng.standard_normal((k, 2, 17, 3)) * 0.4).astype(np.float32))


def _jax_state(route, dtype="float32"):
    """(JAX TrainState, its numpy params and batch_stats) of a flax
    PoseNet3D on ``route``, Adam(lr, weight decay 1e-8)."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet3D
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState, make_optimizer

    params, stats = flax_posenet("resnet18")
    cast = np.float64 if dtype == "float64" else np.float32
    params, stats = (jax.tree.map(lambda a: np.asarray(a, cast), t) for t in (params, stats))
    fields = {k: v for k, v in ROUTES[route].items() if k != "use_kernels_train"}
    model = PoseNet3D(architecture="resnet18", use_pallas=False, dtype=getattr(jnp, dtype),
                      **fields)
    tx = make_optimizer(LR, "adam", weight_decay=WD)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), plateau=plateau_init(LR), tx=tx,
                       apply_fn=model.apply)
    return state, params, stats


def _jax_grads(state, frames, kp3d):
    import jax

    def loss(p):
        (coords, _), _ = state.apply_fn({"params": p, "batch_stats": state.batch_stats},
                                        frames.astype(p["head"]["Conv_0"]["bias"].dtype) / 256.0,
                                        train=True, mutable=["batch_stats"])
        return ((coords.reshape(kp3d.shape) - kp3d) ** 2).mean()

    return jax.grad(loss)(state.params)


def _sd(tree, stats):
    """A flax params-shaped tree (and batch_stats) -> the port's state dict
    as float64 numpy."""
    import jax

    sd = posenet3d_from_flax(jax.tree.map(np.asarray, tree), jax.tree.map(np.asarray, stats))
    return {k: v.numpy().astype(np.float64) for k, v in sd.items()}


def _port_state(route, dtype=torch.float32, apply=None):
    params, stats = flax_posenet("resnet18")
    model = torch_posenet(params, stats, architecture="resnet18", **ROUTES[route]).to(dtype)
    return create_train_state(model, lr=LR, optimizer="adam", weight_decay=WD, apply=apply)


def _running(model):
    return {k: v.double().numpy() for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("route", ["nhwc", "nhwc_kernels_train", "fused"])
def test_f64_train_step_matches_the_jax_step(route):
    """Loss, every gradient, the parameters after the step and the
    BatchNorm running mean and variance, in float64 on both sides."""
    frames, kp3d = _batches()
    grads, jm, want = _jax_f64_step(3)
    want_loss = float(jm["loss"])
    state = _port_state(route, torch.float64)
    m = make_direct_train_step("mse")(state, torch.from_numpy(frames[0]),
                                      torch.from_numpy(kp3d[0]).double())
    model = state.model
    assert state.step == 1
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-10)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float64
        np.testing.assert_allclose(p.grad.numpy(), grads[name], atol=1e-9, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-8, rtol=0,
                                   err_msg=name)
    for name, v in _running(model).items():
        np.testing.assert_allclose(v, want[name], atol=1e-10, rtol=0, err_msg=name)


@functools.cache
def _jax_f64_step(seed, k=None):
    """The JAX NHWC route's float64 step on ``_batches(seed=seed)`` (the
    chunk step of k batches where k is given): (gradients of the first
    batch or None, metrics, the port's state dict after it)."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train import image_steps as J

    frames, kp3d = _batches(k or 1, seed)
    with jax.enable_x64(True):
        js, _, _ = _jax_state("nhwc", "float64")
        f, y = jnp.asarray(frames), jnp.asarray(kp3d, jnp.float64)
        if k is None:
            grads = _sd(_jax_grads(js, f[0], y[0]), js.batch_stats)
            js2, jm = J.make_direct_train_step("mse", donate=False)(js, f[0], y[0],
                                                                    jax.random.key(0))
        else:
            grads = None
            js2, jm = J.make_direct_chunk_step("mse", donate=False)(js, f, y, jax.random.key(0))
        return grads, jax.tree.map(np.asarray, jm), _sd(js2.params, js2.batch_stats)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("route", ["nhwc", "fused"])
def test_f32_train_step_is_as_accurate_as_the_jax_step(route):
    """One f32 step of the port and of the JAX package (its fused route
    through the Pallas kernel in interpret mode), each against the JAX
    float64 step: the port's loss and MPJPE sums within rtol 1e-4 and 1e-3
    of it,
    its gradients no further from it than twice the JAX f32 step's (floor
    2e-3 relative), the
    parameters after the step within 2·lr + 1e-6 (within 1e-6 where the
    float64 gradient exceeds 1e-3), the running statistics within 1e-4."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.image_steps import make_direct_train_step as jax_step

    frames, kp3d = _batches(seed=4)
    g64, m64, want = _jax_f64_step(4)
    js, _, _ = _jax_state(route)
    f, y = jnp.asarray(frames[0]), jnp.asarray(kp3d[0])
    g32 = _sd(_jax_grads(js, f, y), js.batch_stats)
    _, jm = jax_step("mse", donate=False)(js, f, y, jax.random.key(0))
    state = _port_state(route)
    m = make_direct_train_step("mse")(state, torch.from_numpy(frames[0]),
                                      torch.from_numpy(kp3d[0]))
    np.testing.assert_allclose(m["loss"].numpy(), m64["loss"], rtol=1e-4)
    np.testing.assert_allclose(m["mpjpe_sums"].numpy(), m64["mpjpe_sums"], rtol=1e-3)
    for name, p in state.model.named_parameters():
        assert _rel(p.grad.double().numpy(), g64[name]) <= max(2 * _rel(g32[name], g64[name]),
                                                               2e-3), name
        diff = np.abs(p.detach().double().numpy() - want[name])
        assert diff[np.abs(g64[name]) > 1e-3].max(initial=0) <= 1e-6, name
        assert diff.max() <= 2 * LR + 1e-6, name
    for name, v in _running(state.model).items():
        np.testing.assert_allclose(v, want[name], atol=1e-4, rtol=0, err_msg=name)


def test_chunk_step_matches_the_jax_chunk_step():
    """K = 2 batches in float64 against ``make_direct_chunk_step``: the
    mean and last losses and the summed MPJPE sums rtol 1e-10, the
    parameters after both steps atol 1e-8, the running statistics 1e-10."""
    frames, kp3d = _batches(k=2, seed=5)
    _, jm, want = _jax_f64_step(5, k=2)
    state = _port_state("nhwc", torch.float64)
    m = make_direct_chunk_step("mse")(state, torch.from_numpy(frames),
                                      torch.from_numpy(kp3d).double())
    assert set(m) == set(jm) == {"loss", "last_batch_loss", "mpjpe_sums"}
    assert state.step == 2
    for k, v in m.items():
        np.testing.assert_allclose(v.numpy(), jm[k], rtol=1e-10, err_msg=k)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-8, rtol=0,
                                   err_msg=name)
    for name, v in _running(state.model).items():
        np.testing.assert_allclose(v, want[name], atol=1e-10, rtol=0, err_msg=name)


@pytest.mark.parametrize("grid", [64, (64, 16, 16), (8, 5, 7)])
def test_heatmap_targets_match_jax(grid):
    from pose3d_tpu.ops.heatmap import heatmap_targets as jax_targets

    kp = np.random.default_rng(6).uniform(-1.2, 1.2, (2, 17, 3)).astype(np.float32)
    kp = np.clip(kp, -1, 1)
    want = np.asarray(jax_targets(kp, grid=grid))
    got = heatmap_targets(torch.from_numpy(kp), grid=grid)
    assert got.shape == want.shape and want.max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    xyz = torch.from_numpy(kp)
    assert torch.equal(uvw_to_xyz(xyz_to_uvw(xyz)), xyz)
    assert torch.equal(xyz_to_uvw(xyz)[..., 0], -xyz[..., 1])


def test_heatmap_loss_step_matches_the_jax_step():
    """heatmap_loss_weight 0.5 on the heatmap route, float64: the targets
    compared with the (D, H, W) heatmap in their (u, v, w) order, as the
    JAX step compares them."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.train.image_steps import make_direct_train_step as jax_step

    frames, kp3d = _batches(seed=7)
    with jax.enable_x64(True):
        js, _, _ = _jax_state("heatmap", "float64")
        _, jm = jax_step("mse", heatmap_loss_weight=0.5, donate=False)(
            js, jnp.asarray(frames[0]), jnp.asarray(kp3d[0], jnp.float64), jax.random.key(0))
        want, want_plain = float(jm["loss"]), None
        _, jm0 = jax_step("mse", donate=False)(
            js, jnp.asarray(frames[0]), jnp.asarray(kp3d[0], jnp.float64), jax.random.key(0))
        want_plain = float(jm0["loss"])
    state = _port_state("heatmap", torch.float64)
    m = make_direct_train_step("mse", heatmap_loss_weight=0.5)(
        state, torch.from_numpy(frames[0]), torch.from_numpy(kp3d[0]).double())
    assert want > want_plain  # the heatmap term counts
    np.testing.assert_allclose(m["loss"].item(), want, rtol=1e-10)


def test_bf16_step_steps_f32_parameters_through_one_bf16_rounding():
    """bf16 compute over f32 master weights (``bf16_apply``) on the fused
    route: every parameter and every Adam moment stays f32 after a step,
    the final conv's weight and bias gradients are bf16 values (the decode
    kernel's dW and db cast back to f32 by autograd), and the BatchNorms'
    running statistics stay f32."""
    frames, kp3d = _batches(seed=8)
    state = _port_state("fused", apply=bf16_apply)
    make_direct_train_step("mse")(state, torch.from_numpy(frames[0]),
                                  torch.from_numpy(kp3d[0]))
    model = state.model
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        for k, v in state.optimizer.state[p].items():
            if k != "step":
                assert v.dtype == torch.float32, (name, k)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert v.dtype == torch.float32, k
    for p in (model.final_layer.weight, model.final_layer.bias):
        assert torch.equal(p.grad, p.grad.bfloat16().float())
        assert p.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "nhwc_kernels_train"])
def test_train_steps_on_the_card(route):
    """The f32 ResNet-18 model at 64 x 64, B = 2, in bf16 under autocast
    (``bf16_apply``), Adam: two train steps launch the route's forward and
    backward kernels once a step each, give a finite loss, and leave every
    parameter f32."""
    dev = cuda_device()
    fields = ({"fuse_final_conv": True} if route == "fused" else {"use_kernels_train": True})
    wrappers = ((conv_decode.conv_soft_argmax_3d_fused, conv_decode.conv_soft_argmax_3d_backward)
                if route == "fused" else
                (softargmax.soft_argmax_3d_nhwc_kernel, softargmax.soft_argmax_3d_nhwc_backward))
    model = PoseNet3D("resnet18", return_heatmap=False, device="cpu", **fields).init_weights(
        torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, lr=1e-3, optimizer="adam", weight_decay=1e-8,
                               apply=bf16_apply)
    frames, kp3d = (torch.from_numpy(a[0]).to(dev) for a in _batches(seed=9))
    before = [f.launches for f in wrappers]
    step = make_direct_train_step("mse")
    losses = [step(state, frames, kp3d)["loss"].item() for _ in range(2)]
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(wrappers, before)] == [2, 2]
    assert all(np.isfinite(losses))
    assert all(p.dtype == torch.float32 for p in model.parameters())
