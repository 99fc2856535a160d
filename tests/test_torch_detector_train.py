"""The port's 2D-detector training (``pose3d_tpu_torch/train/
image_steps.py``: ``make_detector_chunk_step``, ``make_detector_eval_step``;
``cli/train_detector.py``) against the JAX package's, on the CPU.

The steps render their frames on the device; the JAX steps draw the
render noise from their key and the port's from a ``torch.Generator``, so
the parity tests render with ``noise=0`` on both sides (each factory
imports ``render_pose_frames`` when it is built, so patching the module
attribute around the factory call is enough; nothing in either package
changes). Under x64 the JAX renderer computes its Gaussians in float64
(its widths are Python floats), where the port's stays f32: their frames
differ by up to 6e-7, and the sharp heatmaps of the x256 final conv carry
that to ~4e-4 of the loss. So the port's steps are given the JAX
renderer's noise-free frames (``_jax_frames``); the port's own renderer
is held to JAX's in ``test_torch_detector.py``. Model: ``PoseNet2D``,
ResNet-18, the flax weights of ``torch_port_util.flax_posenet2d``, 64 x
64 frames, B = 2, K = 2 steps, Adam with weight decay 1e-8 at lr 2^-10
(exact in f32 and f64).

Tolerances, float64 on both sides (x64 on): the chunk step's mean loss,
last-batch loss and pixel error rtol 1e-10; the parameters after both
steps atol 1e-8 (Adam's first step is -lr·g/(|g| + eps): a gradient near
eps moves by up to lr·δg/eps); the BatchNorm running mean and (unbiased)
variance atol 1e-10; the eval step's pixel error rtol 1e-9 (the JAX eval
renders inside its jit and the test's frames come from an eager call, so
the float64 frames differ in their last bits, which the sharp heatmaps
carry to 6.8e-10).
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

from torch_port_util import flax_posenet2d, torch_posenet2d

import pose3d_tpu_torch.data.synthetic as port_synthetic
from pose3d_tpu_torch.cli import train_detector as cli
from pose3d_tpu_torch.config import DetectorConfig
from pose3d_tpu_torch.interop.weights import posenet2d_from_flax
from pose3d_tpu_torch.pipeline import run as video_run
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.image_steps import make_detector_chunk_step, make_detector_eval_step
from pose3d_tpu_torch.train.state import create_train_state

torch.set_num_threads(2)

LR = 2.0 ** -10
WD = 1e-8
SIZE = 64
B = 2
K = 2


def _poses(seed, k=K):
    kp2d, _ = port_synthetic.synthetic_h36m(k * B, seed=seed)
    return kp2d.astype(np.float64).reshape(k, B, 17, 2)


@functools.cache
def _jax_chunk(seed):
    """The JAX chunk step (noise 0) on ``_poses(seed)`` and its eval step on
    ``_poses(seed + 1)`` after it, float64: (metrics, eval pixel error, the
    port's state dict after the step)."""
    import jax
    import jax.numpy as jnp

    import pose3d_tpu.data.synthetic as jax_synthetic
    from pose3d_tpu.models.heads import PoseNet2D
    from pose3d_tpu.train import image_steps as J
    from pose3d_tpu.train.schedule import plateau_init
    from pose3d_tpu.train.state import TrainState, make_optimizer

    quiet = functools.partial(jax_synthetic.render_pose_frames, noise=0.0)
    with mock.patch.object(jax_synthetic, "render_pose_frames", quiet):
        step = J.make_detector_chunk_step(SIZE, donate=False)
        eval_fn = J.make_detector_eval_step(SIZE)
    with jax.enable_x64(True):
        params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                         for t in flax_posenet2d("resnet18"))
        tx = make_optimizer(LR, "adam", weight_decay=WD)
        state = TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), plateau=plateau_init(LR), tx=tx,
                           apply_fn=PoseNet2D(architecture="resnet18", dtype=jnp.float64).apply)
        state, m = step(state, jnp.asarray(_poses(seed)), jax.random.key(0))
        px = eval_fn(state, jnp.asarray(_poses(seed + 1)), jax.random.key(99))
        sd = posenet2d_from_flax(jax.tree.map(np.asarray, state.params),
                                 jax.tree.map(np.asarray, state.batch_stats))
        return (jax.tree.map(np.asarray, m), float(px),
                {k: v.numpy() for k, v in sd.items() if v.is_floating_point()})


def _port_state():
    model = torch_posenet2d(*flax_posenet2d("resnet18"), architecture="resnet18").double()
    return create_train_state(model, lr=LR, optimizer="adam", weight_decay=WD)


def _jax_frames(kp2d: torch.Tensor, generator=None, size: int = SIZE) -> torch.Tensor:
    """The JAX renderer's noise-free frames of ``kp2d`` under x64, as a
    tensor: what the JAX steps of ``_jax_chunk`` render."""
    import jax
    import jax.numpy as jnp

    import pose3d_tpu.data.synthetic as jax_synthetic

    with jax.enable_x64(True):
        frames = jax_synthetic.render_pose_frames(jnp.asarray(kp2d.numpy()), None, size,
                                                  noise=0.0)
        return torch.from_numpy(np.array(frames))


def _jax_frame_factories():
    """The port's chunk and eval steps, rendering through ``_jax_frames``."""
    with mock.patch.object(port_synthetic, "render_pose_frames", _jax_frames):
        return make_detector_chunk_step(SIZE), make_detector_eval_step(SIZE)


def test_f64_chunk_and_eval_steps_match_jax():
    jm, jpx, want = _jax_chunk(7)
    step, eval_fn = _jax_frame_factories()
    state = _port_state()
    m = step(state, torch.from_numpy(_poses(7)), torch.Generator())
    assert set(m) == set(jm) == {"loss", "last_batch_loss", "px_err"}
    assert state.step == K
    for k, v in jm.items():
        np.testing.assert_allclose(m[k].numpy(), v, rtol=1e-10, err_msg=k)
    got = state.model.state_dict()
    for name, w in want.items():
        atol = 1e-10 if "running" in name else 1e-8
        np.testing.assert_allclose(got[name].numpy(), w, atol=atol, rtol=0, err_msg=name)
    px = eval_fn(state, torch.from_numpy(_poses(8)), 99)
    np.testing.assert_allclose(px.item(), jpx, rtol=1e-9)
    assert not state.model.training


def test_noise_comes_from_the_generator():
    """With noise (the trainer's setting) the frames come from the
    generator: one seed gives one step, another seed another; the eval
    step's seed fixes its frames."""
    step, eval_fn = make_detector_chunk_step(SIZE), make_detector_eval_step(SIZE)
    kp = torch.from_numpy(_poses(9, k=1))
    losses = []
    for seed in (0, 0, 1):
        state = _port_state()
        losses.append(step(state, kp, torch.Generator().manual_seed(seed))["loss"].item())
    assert losses[0] == losses[1] != losses[2]
    state = _port_state()
    a, b, c = (eval_fn(state, kp, s).item() for s in (99, 99, 98))
    assert a == b != c


def _tiny_cfg(tmp_path, **kw):
    fields = {"architecture": "resnet18", "image_size": SIZE, "n_steps": 16, "chunk_steps": 4,
              "batch_size": 4, "n_train": 128, "n_eval": 16, "bf16": False,
              "run_name": "det", "device": "cpu", "log_dir": str(tmp_path / "logs")}
    return DetectorConfig(**{**fields, **kw})


def test_cli_trains_a_detector_the_pipeline_loads(tmp_path, capsys):
    """The trained checkpoint's eval error falls below the fresh init's,
    and ``pipeline/run.build_detector`` builds the detector from it with
    the meta keys it reads; ``--resume`` continues the run."""
    cfg = _tiny_cfg(tmp_path)
    fresh = cli.new_state(cfg)
    fresh_px = make_detector_eval_step(SIZE)(fresh, cli.eval_poses(cfg, "cpu"),
                                             cli.EVAL_SEED).item()
    state, px = cli.main(["--cpu", "--architecture", "resnet18", "--image_size", "64",
                          "--n_steps", "16", "--chunk_steps", "4", "--batch_size", "4",
                          "--n_train", "128", "--n_eval", "16", "--bf16", "false",
                          "--run_name", "det", "--log_dir", cfg.log_dir])
    assert state.step == 16 and np.isfinite(px) and px < fresh_px, (px, fresh_px)
    meta = ckpt.load_meta(cfg.log_dir, "det")
    assert meta["model"] == "posenet2d" and meta["architecture"] == "resnet18"
    assert meta["bf16"] is False and meta["eval_px_err"] == px
    det = video_run.build_detector(cfg.log_dir, "det", "cpu")
    assert "detector restored from det" in capsys.readouterr().out
    for k, v in state.model.state_dict().items():
        assert torch.equal(det.model.state_dict()[k], v), k

    state, _ = cli.train(_tiny_cfg(tmp_path, n_steps=20, resume=True))
    assert "resumed det at step 16" in capsys.readouterr().out
    assert state.step == 16 + 20


def test_bf16_checkpoint_builds_a_bf16_detector(tmp_path):
    cfg = _tiny_cfg(tmp_path, n_steps=4, bf16=True, n_eval=4)
    state, px = cli.train(cfg)
    assert np.isfinite(px)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    det = video_run.build_detector(cfg.log_dir, "det", "cpu")
    assert det.model.dtype == torch.bfloat16


def test_cli_needs_cuda_or_cpu_flag(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--log_dir", str(tmp_path)])
