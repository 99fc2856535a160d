"""The port's SMPL-IK pose model (``pose3d_tpu_torch/models/smpl_pose.py``,
``interop/weights.py`` ``pose_smpl_net_from_flax``,
``train/smpl_steps.py``) against the JAX package, on the CPU.

The flax ``PoseSMPLNet`` (ResNet-18, 29 joints, volume depth 8) is
initialised once with seeded biases, BN scales and statistics, its final
1x1 conv scaled by 64 (``torch_port_util.flax_pose_smpl_net``): a fresh
init gives uvd within ~0.1 of 0, so each test asserts a uvd spread (std)
of at least 0.1. Frames are 64 x 64 from a numpy seed; the body is
``synthetic_model(300, seed=1)``; the cameras are ``tests/test_smpl_pose.py``'s.
Tolerances:

- the bridge: the state dict's keys are the reference
  ``Simple3DPoseBaseSMPL``'s (``preact``, ``deconv_layers``,
  ``final_layer``, ``fc1``, ``fc2``, ``decshape``, ``decphi``), and its
  backbone and head equal the JAX package's ``posenet3d_to_torch`` export
  bitwise;
- ``PoseSMPLNet`` vs flax: eval in f32, uvd, phis and shapes atol 1e-4
  (PoseNet3D's limit, PERF.md §2); train mode in float64 (f32 BatchNorm
  on the batch statistics of 4 small frames is ill-conditioned, ROADMAP
  §3 trap 6; dropout held deterministic: the port's Dropout layers in
  eval mode, the flax Dropout intercepted to return its input), the
  outputs and the running statistics after the batch atol 1e-10; the
  bf16 routes (autocast over the f32 model, and the
  model cast to bf16) vs flax f32: atol 5e-2 (the bf16 budget);
- ``uvd_to_cam``, ``flip_uvd_coord``, ``flip_phi`` (f32): atol 1e-5, and
  bitwise for the flips;
- ``HybrIKPose`` eval vs JAX's, f32, ``flip_test`` off and on: every
  output atol 1e-4;
- under a bf16 autocast the SMPL half's outputs are f32 and bitwise those
  of the SMPL half on the net's outputs with autocast off;
- one ``make_hybrik_train_step`` in float64 vs JAX's (x64, dropout held
  deterministic, Adam at lr 2^-10): the loss and the MPJPE sums rtol
  1e-10, the net's parameters after Adam atol 1e-8, the running
  statistics atol 1e-10 (PR 13's and 15's limits). The JAX module casts
  its outputs to f32 where the port keeps a float64 net's in float64, so
  the float64 tests have the JAX module's ``jnp.float32`` stand for
  float64, on their side;
- a few f32 steps on one batch: the loss falls.
"""

import types

import numpy as np
import pytest
import torch

from torch_port_util import flax_pose_smpl_net, torch_pose_smpl_net

from pose3d_tpu_torch.interop.weights import pose_smpl_net_from_flax
from pose3d_tpu_torch.models import smpl as ts
from pose3d_tpu_torch.models.smpl_pose import (HybrIKPose, PoseSMPLNet, flip_phi,
                                               flip_uvd_coord, uvd_to_cam)
from pose3d_tpu_torch.train.smpl_steps import make_hybrik_train_step
from pose3d_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

ARCH, DEPTH, SIZE = "resnet18", 8, 64
F32_ATOL, BF16_ATOL, MIN_SPREAD = 1e-4, 5e-2, 0.1
NET_KEYS = ("uvd29", "phis", "delta_shape", "pred_shape")
LR = 2.0 ** -10


def _flax_net(dtype=None):
    import jax.numpy as jnp

    from pose3d_tpu.models.smpl_pose import PoseSMPLNet as FlaxNet

    return FlaxNet(architecture=ARCH, depth=DEPTH, dtype=dtype or jnp.float32)


def _port_net(dtype=torch.float32):
    params, stats = flax_pose_smpl_net()
    return torch_pose_smpl_net(params, stats, dtype, architecture=ARCH, depth=DEPTH)


def _frames(b, seed=1):
    return np.random.default_rng(seed).random((b, SIZE, SIZE, 3)).astype(np.float32)


def _cam_args(b):
    """(trans_inv, k_inv, joint_root, depth_factor) as in
    ``tests/test_smpl_pose.py``: identity crop, 1/f = 1e-3, the root 3 m
    away, a 2.2 m depth factor."""
    trans_inv = np.broadcast_to(np.eye(2, 3), (b, 2, 3))
    k_inv = np.broadcast_to(np.diag([1e-3, 1e-3, 1.0]), (b, 3, 3))
    root = np.tile([[0.0, 0.0, 3000.0]], (b, 1))
    depth = np.full((b, 1), 2200.0)
    return tuple(np.ascontiguousarray(a, np.float32) for a in (trans_inv, k_inv, root, depth))


def _no_dropout(next_fun, args, kwargs, context):
    import flax.linen as nn

    if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _hold_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()


def _assert_close(got: dict, want: dict, keys, atol, what=""):
    for k in keys:
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        w = np.asarray(want[k])
        assert g.shape == w.shape, (what, k)
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"{what} {k}")


# --- the network ---------------------------------------------------------------

def test_bridge_keys_are_the_reference_names():
    from pose3d_tpu.interop.torch_weights import posenet3d_to_torch

    params, stats = flax_pose_smpl_net()
    sd = pose_smpl_net_from_flax(params, stats)
    model = PoseSMPLNet(ARCH, depth=DEPTH, device="cpu")
    assert set(model.state_dict()) == set(sd)
    assert {k.split(".")[0] for k in sd} == {"preact", "deconv_layers", "final_layer", "fc1",
                                            "fc2", "decshape", "decphi"}
    assert sd["final_layer.weight"].shape == (29 * DEPTH, 256, 1, 1)
    assert sd["fc1.weight"].shape == (1024, 512) and sd["decphi.weight"].shape == (46, 1024)
    np.testing.assert_array_equal(sd["decshape.weight"].numpy(), params["decshape"]["kernel"].T)
    head = {"params": {k: params[k] for k in ("backbone", "head")}, "batch_stats": stats}
    for k, v in posenet3d_to_torch(head).items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    assert model.preact.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def test_f32_matches_flax():
    import jax

    params, stats = flax_pose_smpl_net()
    x = _frames(2)
    want = jax.jit(_flax_net().apply)({"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = _port_net()(torch.from_numpy(x))
    assert np.asarray(want["uvd29"]).std() >= MIN_SPREAD
    assert all(got[k].dtype == torch.float32 for k in NET_KEYS)
    _assert_close(got, want, NET_KEYS, F32_ATOL, "eval")


def _float64_outputs(monkeypatch):
    """The JAX ``PoseSMPLNet`` casts its outputs to ``jnp.float32``; the
    port keeps a float64 net's in float64. For a float64 comparison the
    JAX module's ``jnp.float32`` stands for float64 (on the test's side)."""
    import jax.numpy as jnp

    from pose3d_tpu.models import smpl_pose as jsp

    x64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    x64.float32 = jnp.float64
    monkeypatch.setattr(jsp, "jnp", x64)


def test_train_mode_matches_flax_with_dropout_held(monkeypatch):
    """Train mode on one batch, in float64 (BatchNorm on the batch
    statistics of 4 small frames makes f32 ill-conditioned, ROADMAP §3 trap
    6): the outputs and the running statistics after the batch, atol
    1e-10."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from pose3d_tpu_torch.interop.weights import posenet3d_from_flax

    _float64_outputs(monkeypatch)
    params, stats = flax_pose_smpl_net()
    x = _frames(4, seed=2).astype(np.float64)

    def apply(variables, x):
        with nn.intercept_methods(_no_dropout):
            return _flax_net(jnp.float64).apply(variables, x, train=True, mutable=["batch_stats"])

    with jax.enable_x64(True):
        f64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), {"params": params,
                                                                   "batch_stats": stats})
        want, updates = jax.jit(apply)(f64, x)
        want = jax.tree.map(np.asarray, want)
        updates = jax.tree.map(np.asarray, updates["batch_stats"])
    port = _port_net().double().train()
    _hold_dropout(port)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert all(got[k].dtype == torch.float64 for k in NET_KEYS)
    _assert_close(got, want, NET_KEYS, 1e-10, "train")
    new_stats = posenet3d_from_flax(params, updates)
    state = port.state_dict()
    moved = 0
    for k, v in new_stats.items():
        if "running" in k:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-10, rtol=0, err_msg=k)
            moved += not np.allclose(v.numpy(), posenet3d_from_flax(params, stats)[k].numpy())
    assert moved > 0


@pytest.mark.parametrize("route", ["autocast", "bf16_model"])
def test_bf16_matches_flax_f32(route):
    import jax

    params, stats = flax_pose_smpl_net()
    x = _frames(2)
    want = jax.jit(_flax_net().apply)({"params": params, "batch_stats": stats}, x)
    with torch.inference_mode():
        if route == "autocast":
            model = _port_net()
            with torch.autocast("cpu", dtype=torch.bfloat16):
                got = model(torch.from_numpy(x))
        else:
            model = _port_net(torch.bfloat16)
            got = model(torch.from_numpy(x))
    assert all(got[k].dtype == torch.float32 for k in NET_KEYS)
    assert model.init_shape.dtype == torch.float32
    _assert_close(got, want, NET_KEYS, BF16_ATOL, route)


def test_init_shape_stays_f32_and_is_added():
    shape = tuple(0.1 * i for i in range(10))
    net = PoseSMPLNet(ARCH, depth=DEPTH, init_shape=shape, device="cpu")
    net.init_weights(torch.Generator().manual_seed(0)).eval()
    assert "init_shape" not in net.state_dict()
    net.to(torch.bfloat16)
    assert net.init_shape.dtype == torch.float32 and net.fc1.weight.dtype == torch.bfloat16
    with torch.no_grad():
        out = net(torch.from_numpy(_frames(1)))
    torch.testing.assert_close(out["pred_shape"] - out["delta_shape"],
                               torch.tensor([shape], dtype=torch.float32))


# --- the back-projection and the flips -------------------------------------------

def test_camera_and_flip_functions_match_jax():
    import jax.numpy as jnp

    from pose3d_tpu.models import smpl_pose as jsp

    rng = np.random.default_rng(3)
    uvd = rng.uniform(-0.5, 0.5, (2, 29, 3)).astype(np.float32)
    trans_inv = rng.standard_normal((2, 2, 3)).astype(np.float32)
    k_inv = (0.001 * rng.standard_normal((2, 3, 3))).astype(np.float32)
    root = rng.uniform(-100, 100, (2, 3)).astype(np.float32)
    root[:, 2] += 3000
    depth = np.full((2, 1), 2200.0, np.float32)
    cam = (trans_inv, k_inv, root, depth)
    for rel in (True, False):
        got = uvd_to_cam(*(torch.from_numpy(a) for a in (uvd, *cam)), return_relative=rel)
        want = jsp.uvd_to_cam(*(jnp.asarray(a) for a in (uvd, *cam)), return_relative=rel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    phis = rng.standard_normal((2, 23, 2)).astype(np.float32)
    for shift in (True, False):
        np.testing.assert_array_equal(
            flip_uvd_coord(torch.from_numpy(uvd), shift=shift).numpy(),
            np.asarray(jsp.flip_uvd_coord(jnp.asarray(uvd), shift=shift)))
    np.testing.assert_array_equal(flip_phi(torch.from_numpy(phis)).numpy(),
                                  np.asarray(jsp.flip_phi(jnp.asarray(phis))))
    np.testing.assert_array_equal(flip_phi(flip_phi(torch.from_numpy(phis))).numpy(), phis)


# --- the whole model -------------------------------------------------------------

def _port_assembly(dtype=torch.float32):
    return HybrIKPose(_port_net(dtype), ts.synthetic_model(300, seed=1))


@pytest.mark.parametrize("flip_test", [False, True], ids=["plain", "flip_test"])
def test_hybrik_pose_eval_matches_jax(flip_test):
    import jax

    from pose3d_tpu.models import smpl as js
    from pose3d_tpu.models.smpl_pose import HybrIKPose as FlaxHybrIKPose

    params, stats = flax_pose_smpl_net()
    x, cam = _frames(2, seed=4), _cam_args(2)
    assembly = FlaxHybrIKPose(net=_flax_net(), smpl=js.synthetic_model(300, seed=1))
    want = jax.jit(lambda v, x, *c: assembly.apply(v, x, *c, flip_test=flip_test))(
        {"params": params, "batch_stats": stats}, x, *cam)
    model = _port_assembly().eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x), *(torch.from_numpy(a) for a in cam),
                    flip_test=flip_test)
    assert set(got) == set(want)
    with torch.no_grad():
        assert model.net(torch.from_numpy(x))["uvd29"].std() >= MIN_SPREAD
    assert got["pred_vertices"].shape == (2, 300, 3) and got["pred_theta_quats"].shape == (2, 96)
    _assert_close(got, want, sorted(want), F32_ATOL, f"flip_test={flip_test}")


def test_smpl_half_is_f32_under_a_bf16_net():
    """Under a bf16 autocast the net computes in bf16 and the SMPL half in
    f32, as if autocast were off; a bf16 cast of the whole model leaves the
    body's buffers f32."""
    model = _port_assembly().eval()
    x = torch.from_numpy(_frames(2, seed=5))
    cam = [torch.from_numpy(a) for a in _cam_args(2)]
    with torch.no_grad():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = model(x, *cam)
            net_out = model.net(x)
        want = model._smpl_half(net_out, *cam)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], v), k
    model.to(torch.bfloat16)
    assert all(getattr(model.smpl, n).dtype == torch.float32 for n in ts.ARRAYS)


# --- the train step ----------------------------------------------------------------

def _jax_f64_step(monkeypatch, frames, cam, uvd_gt, xyz_gt):
    """The JAX step in float64 on the seeded weights, dropout intercepted:
    (metrics, the net's state dict after the step, as numpy)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models import smpl as js
    from pose3d_tpu.models import smpl_pose as jsp
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.smpl_steps import make_hybrik_train_step as jax_step
    from pose3d_tpu.train.state import TrainState, make_optimizer

    _float64_outputs(monkeypatch)
    params, stats = flax_pose_smpl_net()
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

        assembly = jsp.HybrIKPose(net=_flax_net(jnp.float64), smpl=js.synthetic_model(300, seed=1))
        tx = make_optimizer(LR, "adam")
        p64 = f64(params)
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=p64, batch_stats=f64(stats),
                           opt_state=tx.init(p64), plateau=plateau_init(LR), tx=tx,
                           apply_fn=None)
        step = jax_step(assembly, donate=False)
        with nn.intercept_methods(_no_dropout):
            state, m = step(state, jnp.asarray(frames), tuple(jnp.asarray(a) for a in cam),
                            jnp.asarray(uvd_gt), jnp.asarray(xyz_gt), jax.random.key(0))
        m = jax.tree.map(np.asarray, m)
        sd = pose_smpl_net_from_flax(jax.tree.map(np.asarray, state.params),
                                     jax.tree.map(np.asarray, state.batch_stats))
    return m, {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}


def _step_batch(b, dtype=np.float64):
    rng = np.random.default_rng(6)
    frames = rng.random((b, SIZE, SIZE, 3))
    cam = tuple(a.astype(dtype) for a in _cam_args(b))
    uvd_gt = rng.uniform(-0.4, 0.4, (b, 29, 3))
    xyz_gt = rng.uniform(-0.3, 0.3, (b, 17, 3))
    return frames.astype(dtype), cam, uvd_gt.astype(dtype), xyz_gt.astype(dtype)


def test_f64_train_step_matches_the_jax_step(monkeypatch):
    frames, cam, uvd_gt, xyz_gt = _step_batch(2)
    want_m, want_sd = _jax_f64_step(monkeypatch, frames, cam, uvd_gt, xyz_gt)
    model = _port_assembly().double()
    assert model.smpl.v_template.dtype == torch.float64
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0  # the JAX side's dropout is intercepted
    state = create_train_state(model, lr=LR, optimizer="adam")
    assert [p for p in model.parameters()] == [p for p in model.net.parameters()]
    t = torch.from_numpy
    m = make_hybrik_train_step()(state, t(frames), tuple(t(a) for a in cam), t(uvd_gt),
                                 t(xyz_gt), 0)
    assert set(m) == set(want_m) and state.step == 1
    for k, v in want_m.items():
        np.testing.assert_allclose(m[k].numpy(), v, rtol=1e-10, err_msg=k)
    got = model.net.state_dict()
    for name, w in want_sd.items():
        atol = 1e-10 if "running" in name else 1e-8
        np.testing.assert_allclose(got[name].numpy(), w, atol=atol, rtol=0, err_msg=name)


def test_train_steps_reduce_the_loss():
    """f32, 8 steps of Adam at 3e-4 on one batch (the JAX test's lr), one
    dropout seed: the mean of the last three losses below the first."""
    frames, cam, uvd_gt, xyz_gt = _step_batch(2, np.float32)
    model = HybrIKPose(PoseSMPLNet(ARCH, depth=DEPTH, device="cpu").init_weights(
        torch.Generator().manual_seed(0)), ts.synthetic_model(300, seed=1))
    state = create_train_state(model, lr=3e-4, optimizer="adam")
    step = make_hybrik_train_step()
    t = torch.from_numpy
    losses = [step(state, t(frames), tuple(t(a) for a in cam), t(uvd_gt), t(xyz_gt), 7)["loss"]
              .item() for _ in range(8)]
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0], losses
