"""Projector trainer, the learned 3D -> 2D camera projection (the phase-5
side model): the port of ``pose3d_tpu/cli/train_project.py`` (the
reference ``phase5_loop/train_project.py``).

Trains a ViT projector (``JointTransformerLifter(in_dim=3, out_dim=2)``,
the reference ``MyViT(chw=(1, 17, 3), out_d=2)``) on ground-truth (3D, 2D)
pairs from ``cli/train_lift.load_split``: 3D poses in, 2D keypoints as
targets, through the lifter's epoch functions (``train/epoch.py``), with
bare Adam (the reference uses Adam, not AdamW) and the plateau schedule
on the last batch's loss. The 2D metric is the mean L2 error over joints
1: in the keypoints' units, x 1000 ("millipixels" where the keypoints are
in pixels / 1000). The checkpoint is what ``cli/train_loop --project true
--projector_checkpoint <run>`` freezes. The default run name is
``project_run``.

Usage:
  python -m pose3d_tpu_torch.cli.train_project --run_name proj1 --n_epochs 30
  python -m pose3d_tpu_torch.cli.train_project --cpu --n_epochs 1 \\
      --data.synthetic_frames 256 --log_dir logs/plog
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pose3d_tpu_torch.cli.train_lift import load_split
from pose3d_tpu_torch.config import LiftConfig, parse_config
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.epoch import (make_lifter_epoch_fn, make_lifter_eval_epoch_fn,
                                          stack_batches)
from pose3d_tpu_torch.train.logging import MetricLogger
from pose3d_tpu_torch.train.state import create_train_state


def _millipixels(sums: torch.Tensor, n: int) -> float:
    """Per-joint L2 sums -> the mean over joints 1: a frame, x 1000."""
    return float(sums[1:].mean() / n * 1000)


def train(cfg: LiftConfig):
    """Train for ``cfg.n_epochs`` epochs, logging each; returns the state."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to train on the CPU")
    model = JointTransformerLifter(n_joints=cfg.data.num_joints, in_dim=3, out_dim=2,
                                   device="cpu")
    model = model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    train_ds = load_split(cfg, is_train=True)
    test_ds = load_split(cfg, is_train=False)
    state = create_train_state(model, lr=cfg.lr, optimizer="adam")
    epoch_fn = make_lifter_epoch_fn(cfg.loss)
    eval_fn = make_lifter_eval_epoch_fn(cfg.loss)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": "projector", "epochs": cfg.n_epochs,
    })

    def on_device(*arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    rng = np.random.default_rng(cfg.seed)
    # the projector's direction: 3D poses in, 2D keypoints out
    vy1, vy2 = on_device(*stack_batches((test_ds.kp3d, test_ds.kp2d), cfg.batch_size))
    n_train = (len(train_ds) // cfg.batch_size) * cfg.batch_size
    n_val = vy1.shape[0] * cfg.batch_size

    for epoch in range(cfg.n_epochs):
        y1, y2 = on_device(*stack_batches((train_ds.kp3d, train_ds.kp2d), cfg.batch_size, rng))
        m = epoch_fn(state, y1, y2, cfg.seed * 31 + epoch)
        state.plateau.step(float(m["last_batch_loss"]))
        vm = eval_fn(state, vy1, vy2)
        logger.log_epoch(epoch, cfg.n_epochs, float(m["loss"]),
                         _millipixels(m["mpjpe_sums"], n_train), float(vm["loss"]),
                         _millipixels(vm["mpjpe_sums"], n_val), lr=state.lr)

    path = ckpt.save(state, cfg.log_dir, cfg.run_name, batch_size=cfg.batch_size)
    logger.finish()
    print(f"saved {path}")
    return state


def main(argv=None):
    cfg = parse_config(LiftConfig, argv)
    if cfg.run_name == "lift_run":
        cfg = dataclasses.replace(cfg, run_name="project_run")
    return train(cfg)


if __name__ == "__main__":
    main()
