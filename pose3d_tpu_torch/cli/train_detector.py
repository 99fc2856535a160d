"""Train the 2D detector, so that the video pipeline detects with trained
weights: the port of ``pose3d_tpu/cli/train_detector.py``.

``PoseNet2D`` (the phase-5 ``Model_2D``) learns image -> keypoints on
frames rendered on the device from synthetic Human3.6M-like poses
(``data/synthetic.render_pose_frames``), a closed world where the
detection error is measurable in pixels. MSE on the coordinates, Adam
with weight decay 1e-8, K optimizer steps a chunk
(``train/image_steps.make_detector_chunk_step``); the model keeps f32
parameters and, with ``--bf16 true`` (the default), computes in bf16 under
``torch.autocast``. Every eighth chunk, and at the end, the eval step
reports the pixel error on held-out poses rendered from one fixed seed.
The checkpoint's ``.meta.json`` carries what ``pipeline/run.
build_detector`` reads: ``model``, ``architecture``, ``bf16`` and
``eval_px_err``.

Usage:
  python -m pose3d_tpu_torch.cli.train_detector --run_name det1 --n_steps 600
  python -m pose3d_tpu_torch.pipeline.run --video v.mp4 --detector posenet2d \\
      --detector_checkpoint det1
  python -m pose3d_tpu_torch.cli.train_detector --cpu --image_size 64 --batch_size 4 \\
      --chunk_steps 2 --n_steps 4 --n_train 64 --n_eval 8 --bf16 false --log_dir logs/det
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pose3d_tpu_torch.config import DetectorConfig, parse_config
from pose3d_tpu_torch.data import synthetic
from pose3d_tpu_torch.models.heads import PoseNet2D
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.image_steps import (bf16_apply, make_detector_chunk_step,
                                                make_detector_eval_step)
from pose3d_tpu_torch.train.state import create_train_state

EVAL_SEED = 99  # the eval frames' noise: one seed, so every eval sees the same frames


def build_detector(cfg: DetectorConfig) -> PoseNet2D:
    """The f32 ``PoseNet2D`` of ``cfg.architecture`` from ``cfg.seed``, on
    the CPU."""
    model = PoseNet2D(cfg.architecture, device="cpu")
    return model.init_weights(torch.Generator().manual_seed(cfg.seed))


def eval_poses(cfg: DetectorConfig, device) -> torch.Tensor:
    """The held-out poses, (n_eval // B, B, 17, 2) on ``device``."""
    kp2d, _ = synthetic.synthetic_h36m(cfg.n_eval, seed=cfg.seed + 1)
    kb = cfg.n_eval // cfg.batch_size
    return torch.from_numpy(kp2d[: kb * cfg.batch_size].reshape(kb, cfg.batch_size, 17, 2)
                            ).to(device)


def new_state(cfg: DetectorConfig):
    """The train state of ``build_detector(cfg)`` on cfg's device: Adam with
    weight decay 1e-8 and the apply of cfg's compute dtype."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to train on the CPU")
    return create_train_state(build_detector(cfg).to(device), lr=cfg.lr, optimizer="adam",
                              weight_decay=1e-8, apply=bf16_apply if cfg.bf16 else None)


def train(cfg: DetectorConfig):
    """Train for ``cfg.n_steps`` steps; returns (state, the last eval pixel
    error)."""
    state = new_state(cfg)
    device = next(state.model.parameters()).device
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed {cfg.run_name} at step {state.step}")

    # the pose pool stays on the host: only (K, B, 17, 2) keypoints go to the
    # device, where the frames are rendered
    kp2d_pool, _ = synthetic.synthetic_h36m(cfg.n_train, seed=cfg.seed)
    kp2d_eval = eval_poses(cfg, device)
    step_fn = make_detector_chunk_step(cfg.image_size)
    eval_fn = make_detector_eval_step(cfg.image_size)
    rng = np.random.default_rng(cfg.seed)
    k, b = cfg.chunk_steps, cfg.batch_size

    t0 = time.time()
    done, px = 0, float("nan")
    while done < cfg.n_steps:
        idx = rng.integers(0, len(kp2d_pool), size=(k, b))
        generator = torch.Generator(device).manual_seed(cfg.seed * 7919 + done)
        m = step_fn(state, torch.from_numpy(kp2d_pool[idx]).to(device), generator)
        done += k
        if done % (k * 8) == 0 or done >= cfg.n_steps:
            px = float(eval_fn(state, kp2d_eval, EVAL_SEED))
            print(f"step {done}/{cfg.n_steps} loss {float(m['loss']):.5f} "
                  f"train_px {float(m['px_err']):.2f} eval_px {px:.2f} "
                  f"({time.time() - t0:.0f}s)", flush=True)

    path = ckpt.save(state, cfg.log_dir, cfg.run_name, batch_size=cfg.batch_size,
                     extra={"model": "posenet2d", "architecture": cfg.architecture,
                            "bf16": cfg.bf16, "eval_px_err": px})
    print(f"saved {path} (eval pixel error {px:.2f}px @ {cfg.image_size})")
    return state, px


def main(argv=None):
    return train(parse_config(DetectorConfig, argv))


if __name__ == "__main__":
    main()
