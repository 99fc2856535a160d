"""Global BatchNorm under data parallelism for the phase-5 models, on the
CPU over two spawned ``gloo`` ranks (``torch_dist_cases.image_step``), in
float64 on every side, on a skewed batch (B = 4, 2 a rank, 64 x 64 float
frames, rank 0's bright and rank 1's dark, so a rank's own statistics are
not the global batch's):

- ``PoseNet2D`` (ResNet-18, the flax weights of
  ``torch_port_util.flax_posenet2d``), one AdamW step of the MSE on its
  coordinates with its BatchNorms global and the gradients averaged (the
  JAX mesh suite's step, ``tests/test_mesh_image.py``);
- ``make_loop_train_step(mesh=)`` with the triangle loss (``sep``), the
  flip (2·B/N frames a rank through each model, their statistics shared
  by the global BatchNorm) and the frozen projector: ``PoseNet2D`` and
  ``PoseNet3D`` (ResNet-18, depth 8), frozen ViTs (hidden 32, 1 block, 4
  heads), AdamW at lr 2^-10.

Each against the port's one-process step on the global batch and JAX's
GSPMD step on a 2-device mesh: loss and every term rtol 1e-10, MPJPE sums
rtol 1e-10, parameters atol 1e-8, running statistics 1e-10; both ranks'
parameters bitwise equal.
"""

import functools

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_util import spawn
from torch_port_util import _seeded_norms, flax_posenet, flax_posenet2d, flax_vit

from pose3d_tpu_torch.interop.weights import posenet3d_from_flax

torch.set_num_threads(2)

B, SIZE = 4, 64


@functools.cache
def _inputs(kind: str):
    rng = np.random.default_rng(11)
    frames = rng.random((B, SIZE, SIZE, 3)) * 0.4
    frames[:B // 2] += 0.6
    y1 = rng.random((B, 17, 2))
    y2 = 0.3 * rng.standard_normal((B, 17, 3))
    return (frames, y1) if kind == "posenet2d" else (frames, y1, y2)


@functools.cache
def _weights(kind: str):
    if kind == "posenet2d":
        return flax_posenet2d("resnet18")
    _, lifter = flax_vit(seed=1, **cases.LOOP_VIT)
    _, projector = flax_vit(seed=2, in_dim=3, out_dim=2, **cases.LOOP_VIT)
    return (flax_posenet2d("resnet18"), flax_posenet("resnet18", depth=cases.LOOP_DEPTH),
            _seeded_norms(lifter, np.random.default_rng(101), False),
            _seeded_norms(projector, np.random.default_rng(102), False))


def _job(kind):
    return (kind, None, _weights(kind), "float64", _inputs(kind))


KINDS = ("loop", "posenet2d")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res = spawn(cases.image_steps, 2, tmp_path_factory.mktemp("loop"), [_job(k) for k in KINDS])
    return {k: [r[i] for r in res] for i, k in enumerate(KINDS)}


def _f64(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _jax_train_state(model, params, stats):
    import jax.numpy as jnp

    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState, make_optimizer

    tx = make_optimizer(cases.IMAGE_LR, "adamw")
    params = _f64(params)
    return TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=_f64(stats),
                      opt_state=tx.init(params), plateau=plateau_init(cases.IMAGE_LR), tx=tx,
                      apply_fn=model.apply)


def _jax_sd(net) -> dict:
    import jax

    sd = posenet3d_from_flax(jax.tree.map(np.asarray, net.params),
                             jax.tree.map(np.asarray, net.batch_stats))
    return {k: v.numpy() for k, v in sd.items() if v.is_floating_point()}


@functools.cache
def _jax_gspmd(kind: str):
    """JAX's float64 step on a 2-device mesh (the state replicated, the
    batch sharded): (metrics, {state dict name: the port's state dict})."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet2D, PoseNet3D
    from pose3d_tpu.models.lifters import JointTransformerLifter
    from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pose3d_tpu.train.loop_steps import LoopState, make_loop_train_step

    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    with jax.enable_x64(True):
        arrays = [jax.device_put(jnp.asarray(a), batch_sharding(mesh)) for a in _inputs(kind)]
        if kind == "posenet2d":
            params, stats = _weights(kind)
            state = _jax_train_state(PoseNet2D(architecture="resnet18", dtype=jnp.float64),
                                     params, stats)

            @jax.jit
            def step(state, frames, kp2d):
                def loss_fn(p):
                    coords, updates = state.apply_fn(
                        {"params": p, "batch_stats": state.batch_stats}, frames, train=True,
                        mutable=["batch_stats"])
                    return jnp.mean((coords.reshape(kp2d.shape) - kp2d) ** 2), \
                        updates["batch_stats"]

                (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    state.params)
                return state.apply_gradients(grads, new_bs), {"loss": loss}

            state, m = step(jax.device_put(state, replicated(mesh)), *arrays)
            return jax.tree.map(np.asarray, m), {"sd": _jax_sd(state)}
        (p2, s2), (p3, s3), lifter, projector = _weights(kind)
        vit = JointTransformerLifter(**cases.LOOP_VIT, dtype=jnp.float64)
        proj = JointTransformerLifter(in_dim=3, out_dim=2, **cases.LOOP_VIT, dtype=jnp.float64)
        state = LoopState(
            net2d=_jax_train_state(PoseNet2D(architecture="resnet18", dtype=jnp.float64), p2,
                                   s2),
            net3d=_jax_train_state(PoseNet3D(architecture="resnet18", depth=cases.LOOP_DEPTH,
                                             dtype=jnp.float64), p3, s3),
            lifter_params=_f64(lifter), projector_params=_f64(projector))
        step = make_loop_train_step(vit.apply, proj.apply, triangle=True, flip=True,
                                    project=True, triangle_mode="sep", donate=False)
        state, m = step(jax.device_put(state, replicated(mesh)), *arrays, jax.random.key(0))
        return (jax.tree.map(np.asarray, m),
                {"sd2d": _jax_sd(state.net2d), "sd3d": _jax_sd(state.net3d)})


@functools.cache
def _one_process(kind: str):
    return cases.image_step(_job(kind))


def _assert_same(got: dict, want_m: dict, want_sds: dict):
    assert set(want_m) <= set(got["m"]), (set(want_m), set(got["m"]))
    for k, v in want_m.items():
        np.testing.assert_allclose(got["m"][k], v, rtol=1e-10, err_msg=k)
    for key, want in want_sds.items():
        for name, w in want.items():
            atol = 1e-10 if "running" in name else 1e-8
            np.testing.assert_allclose(got[key][name], w, atol=atol, rtol=0,
                                       err_msg=f"{key} {name}")


@pytest.mark.parametrize("kind", KINDS)
def test_global_bn_equals_the_global_batch_step(ranks, kind):
    res = ranks[kind]
    for key in res[0]:
        for name, v in res[1][key].items():
            np.testing.assert_array_equal(v, res[0][key][name], err_msg=f"{key} {name}")
    one = _one_process(kind)
    _assert_same(res[0], one["m"], {k: v for k, v in one.items() if k != "m"})


@pytest.mark.parametrize("kind", KINDS)
def test_global_bn_equals_jax_gspmd(ranks, kind):
    _assert_same(ranks[kind][0], *_jax_gspmd(kind))
