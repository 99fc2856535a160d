"""The port's BatchNorm contracts under data parallelism, direct model, on
the CPU over two spawned ``gloo`` ranks (``torch_dist_cases.image_step``):
``PoseNet3D`` (ResNet-18, the flax weights of
``torch_port_util.flax_posenet``), 64 x 64 float frames, B = 4 (2 a
rank), Adam (weight decay 1e-8) at lr 2^-10, the NHWC route and the
fused route (its decode's plain versions here; the same function). At
32 x 32 the last stage holds one pixel a frame, so local BatchNorm over
a rank's two frames maps every channel to ±1 and its float64 gradients
cancel to ~1e-13, which Adam's first step (-lr·g/(|g| + eps)) lifts past
1e-8: 64 x 64 keeps four pixels a frame, as the one-process float64
tests do.

- Local BatchNorm, ``make_dp_direct_train_step`` (the JAX ``shard_map``
  step): with identical shards it is the one-shard step, MPJPE sums x 2
  (f32: loss rtol 1e-5, sums rtol 1e-4, parameters and running
  statistics atol 1e-5 + rtol 1e-4, the JAX mesh suite's); on skewed
  shards (bright frames on rank 0, dark on rank 1) it is JAX's DP step on
  a 2-device mesh, in float64 on both sides (loss rtol 1e-10, MPJPE sums
  rtol 1e-10, parameters atol 1e-8, running statistics 1e-10), and its
  averaged running variance differs from the global batch's.
- Global BatchNorm, ``make_direct_train_step(mesh=)`` (JAX's GSPMD
  contract): on the skewed shards it is the port's one-process step on
  the global batch and JAX's GSPMD step on the 2-device mesh, float64,
  the same limits.

Both ranks' parameters are bitwise equal after every step.
"""

import functools

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_util import spawn
from torch_port_util import flax_posenet

from pose3d_tpu_torch.interop.weights import posenet3d_from_flax

torch.set_num_threads(2)

B, SIZE = 4, 64


def _batch(identical: bool, dtype):
    rng = np.random.default_rng(7)
    frames = rng.random((B, SIZE, SIZE, 3)) * 0.4
    kp3d = (rng.random((B, 17, 3)) - 0.5) * 1.5
    if identical:
        frames, kp3d = np.concatenate([frames[:2]] * 2), np.concatenate([kp3d[:2]] * 2)
    else:
        frames[:B // 2] += 0.6  # rank 0's shard bright, rank 1's dark
    return frames.astype(dtype), kp3d.astype(dtype)


JOBS = {  # name: (kind, route, dtype, identical shards)
    "local_nhwc_f32_identical": ("dp_direct", "nhwc", "float32", True),
    "local_fused_f32_identical": ("dp_direct", "fused", "float32", True),
    "local_nhwc_f64": ("dp_direct", "nhwc", "float64", False),
    "local_fused_f64": ("dp_direct", "fused", "float64", False),
    "global_nhwc_f64": ("direct", "nhwc", "float64", False),
    "global_fused_f64": ("direct", "fused", "float64", False),
}


def _job(name):
    kind, route, dtype, identical = JOBS[name]
    return (kind, route, flax_posenet("resnet18"), dtype, _batch(identical, np.dtype(dtype)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    names = sorted(JOBS)
    res = spawn(cases.image_steps, 2, tmp_path_factory.mktemp("bn"), [_job(n) for n in names])
    return {n: [r[i] for r in res] for i, n in enumerate(names)}


@functools.cache
def _one_process(name: str, shard: bool):
    """The port's one-process step of the job: on rank 0's shard or on the
    global batch, on one thread as the ranks (oneDNN's f32 convolutions
    round by their thread count, and train-mode BatchNorm over two frames
    amplifies that to ~1e-3)."""
    kind, route, weights, dtype, (frames, kp3d) = _job(name)
    if shard:
        frames, kp3d = frames[:B // 2], kp3d[:B // 2]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cases.image_step(("direct", route, weights, dtype, (frames, kp3d)))
    finally:
        torch.set_num_threads(threads)


def _jax_f64_state():
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.models.heads import PoseNet3D
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState, make_optimizer

    params, stats = (jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                     for t in flax_posenet("resnet18"))
    model = PoseNet3D(architecture="resnet18", use_pallas=False, return_heatmap=False,
                      dtype=jnp.float64)
    tx = make_optimizer(cases.IMAGE_LR, "adam", weight_decay=cases.IMAGE_WD)
    return TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                      opt_state=tx.init(params), plateau=plateau_init(cases.IMAGE_LR), tx=tx,
                      apply_fn=model.apply)


@functools.cache
def _jax_f64(kind: str):
    """JAX's float64 step on the skewed batch over a 2-device mesh: the
    ``shard_map`` DP step ("local") or the GSPMD step ("global"):
    (metrics, the port's state dict after it)."""
    import jax
    import jax.numpy as jnp

    from pose3d_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pose3d_tpu.train import image_steps as J

    frames, kp3d = _batch(False, np.float64)
    mesh = make_mesh(n_data=2, devices=jax.devices()[:2])
    with jax.enable_x64(True):
        state = _jax_f64_state()
        f, y = jnp.asarray(frames), jnp.asarray(kp3d)
        if kind == "local":
            state, m = J.make_dp_direct_train_step(mesh, donate=False)(state, f, y,
                                                                       jax.random.key(0))
        else:
            state = jax.device_put(state, replicated(mesh))
            f, y = (jax.device_put(a, batch_sharding(mesh)) for a in (f, y))
            state, m = J.make_direct_train_step(donate=False)(state, f, y, jax.random.key(0))
        sd = posenet3d_from_flax(jax.tree.map(np.asarray, state.params),
                                 jax.tree.map(np.asarray, state.batch_stats))
        return (jax.tree.map(np.asarray, m),
                {k: v.numpy() for k, v in sd.items() if v.is_floating_point()})


def _assert_bitwise_ranks(res):
    for k, v in res[1]["sd"].items():
        np.testing.assert_array_equal(v, res[0]["sd"][k], err_msg=k)
    for k, v in res[1]["m"].items():
        np.testing.assert_array_equal(v, res[0]["m"][k], err_msg=k)


def _assert_f64(got, want_m, want_sd):
    np.testing.assert_allclose(got["m"]["loss"], want_m["loss"], rtol=1e-10)
    np.testing.assert_allclose(got["m"]["mpjpe_sums"], want_m["mpjpe_sums"], rtol=1e-10)
    for name, w in want_sd.items():
        atol = 1e-10 if "running" in name else 1e-8
        np.testing.assert_allclose(got["sd"][name], w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("route", ["nhwc", "fused"])
def test_local_bn_identical_shards_equal_the_one_shard_step(ranks, route):
    res = ranks[f"local_{route}_f32_identical"]
    _assert_bitwise_ranks(res)
    want = _one_process(f"local_{route}_f32_identical", shard=True)
    got = res[0]
    np.testing.assert_allclose(got["m"]["loss"], want["m"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["m"]["mpjpe_sums"], 2 * want["m"]["mpjpe_sums"], rtol=1e-4)
    for name, w in want["sd"].items():
        np.testing.assert_allclose(got["sd"][name], w, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("route", ["nhwc", "fused"])
def test_local_bn_skewed_shards_equal_the_jax_dp_step(ranks, route):
    res = ranks[f"local_{route}_f64"]
    _assert_bitwise_ranks(res)
    _assert_f64(res[0], *_jax_f64("local"))
    # the local contract: the averaged variance leaves out the spread of
    # the shard means, so it is not the global batch's
    oracle = _one_process(f"global_{route}_f64", shard=False)["sd"]
    var = [k for k in oracle if k.endswith("running_var")]
    assert var[0] == "preact.bn1.running_var"  # the stem's, on the frames' skew
    assert not np.allclose(res[0]["sd"][var[0]], oracle[var[0]], atol=1e-6)


@pytest.mark.parametrize("route", ["nhwc", "fused"])
def test_global_bn_equals_the_global_batch_step_and_jax_gspmd(ranks, route):
    res = ranks[f"global_{route}_f64"]
    _assert_bitwise_ranks(res)
    one = _one_process(f"global_{route}_f64", shard=False)
    _assert_f64(res[0], one["m"], one["sd"])
    _assert_f64(res[0], *_jax_f64("global"))
