"""Phase-1 trainer, 2D -> 3D lifting on Human3.6M keypoints: the port of
``pose3d_tpu/cli/train_lift.py`` (the reference ``train_1.py``).

The lifter zoo (``vit``, the reference MyViT, by default; ``martinez``;
``ae``), MSE (or L1) and AdamW with an optional global-norm clip, the
plateau schedule stepped on the last batch's training loss, subjects S1,
S5-S8 for training and S9, S11 for validation with an action filter
(``Posing`` by default), the MPJPE in mm each epoch, validation with the
flip test-time augmentation (``--flip true``), checkpoints with resume,
and an ``interrupt_<run>`` checkpoint on Ctrl-C (``ctlc_save``). Without
a Human3.6M export at ``data.data_dir`` it trains on synthetic poses.
The statistics of the training split go under
``<log_dir>/run_time_utils``.

Each epoch's batch stack is on the device, and the host reads the
metrics once an epoch (``train/epoch.py``). At the end, the first and
the last pose of the first validation batch, ground truth against
prediction, go to ``<log_dir>/visualizations/<run>/3d_test_{a,b}.png``
(``utils/visualize.py``); where they cannot be drawn (no matplotlib on
the host) the trainer says so and carries on.

Usage:
  python -m pose3d_tpu_torch.cli.train_lift --run_name my_run --n_epochs 50
  python -m pose3d_tpu_torch.cli.train_lift --data.data_dir /data/h3.6
  python -m pose3d_tpu_torch.cli.train_lift --cpu --n_epochs 1 --data.synthetic_frames 256
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.config import LiftConfig, parse_config
from pose3d_tpu_torch.data import h36m, synthetic
from pose3d_tpu_torch.models.lifters import AELifter, JointTransformerLifter, MartinezLifter
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.epoch import (make_lifter_epoch_fn, make_lifter_eval_epoch_fn,
                                          stack_batches)
from pose3d_tpu_torch.train.logging import MetricLogger
from pose3d_tpu_torch.train.state import create_train_state


def build_lifter(name: str, num_joints: int = 17):
    """The lifter ``name`` (vit | martinez | ae) for ``num_joints`` joints at
    its default widths, f32, on the CPU."""
    if name == "vit":
        return JointTransformerLifter(n_joints=num_joints, device="cpu")
    if name == "martinez":
        return MartinezLifter(in_dim=num_joints * 2, out_dim=num_joints * 3, device="cpu")
    if name == "ae":
        return AELifter(in_dim=num_joints * 2, out_dim=num_joints * 3, device="cpu")
    raise ValueError(name)


def load_split(cfg: LiftConfig, is_train: bool) -> h36m.KeypointDataset:
    """The training or validation split, preprocessed; the training split
    saves its statistics under ``<log_dir>/run_time_utils`` and the
    validation split loads them."""
    d = cfg.data
    stats_dir = pathlib.Path(cfg.log_dir) / "run_time_utils"
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        subjects = d.train_subjects if is_train else d.test_subjects
        kp2d, kp3d, paths, cams = h36m.read_data(d.data_dir, subjects, d.action, d.mono_3d_file,
                                                 d.camera_view, d.all_cameras)
    else:
        n = d.synthetic_frames if is_train else d.synthetic_frames // 4
        kp2d, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
        paths = cams = None
    return h36m.preprocess(
        kp2d, kp3d, stats_dir, is_train=is_train, zero_centre=d.zero_centre,
        standardize_2d=d.standardize_2d, standardize_3d=d.standardize_3d,
        normalize=d.normalize, num_joints=d.num_joints, split_rate=d.split_rate,
        frame_paths=paths, cam_ids=cams)


def train(cfg: LiftConfig):
    """Train for ``cfg.n_epochs`` epochs, logging each; returns the state."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to train on the CPU")
    d = cfg.data
    model = build_lifter(cfg.model, d.num_joints)
    model = model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    train_ds = load_split(cfg, is_train=True)
    test_ds = load_split(cfg, is_train=False)
    print(f"frames: train {len(train_ds)}, val {len(test_ds)}")

    state = create_train_state(model, lr=cfg.lr, grad_clip=cfg.grad_clip)
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed {cfg.run_name} at step {state.step}")

    epoch_fn = make_lifter_epoch_fn(cfg.loss)
    eval_fn = make_lifter_eval_epoch_fn(cfg.loss, flip_tta=cfg.flip)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": cfg.model,
        "dataset": "H3.6" if d.data_dir else "synthetic", "epochs": cfg.n_epochs,
    })

    def on_device(*arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    rng = np.random.default_rng(cfg.seed)
    # the validation batches are fixed (the reference's test loader does
    # not shuffle)
    vy1, vy2 = on_device(*stack_batches((test_ds.kp2d, test_ds.kp3d), cfg.batch_size))
    n_train = (len(train_ds) // cfg.batch_size) * cfg.batch_size
    n_val = vy1.shape[0] * cfg.batch_size

    try:
        for epoch in range(cfg.n_epochs):
            y1, y2 = on_device(*stack_batches((train_ds.kp2d, train_ds.kp3d), cfg.batch_size,
                                              rng))
            m = epoch_fn(state, y1, y2, cfg.seed * 100003 + epoch)
            # the reference steps its scheduler on the last batch's loss
            state.plateau.step(float(m["last_batch_loss"]))
            vm = eval_fn(state, vy1, vy2)
            logger.log_epoch(
                epoch, cfg.n_epochs, float(m["loss"]),
                float(losses.mpjpe_mm(m["mpjpe_sums"], n_train, d.num_joints, d.zero_centre)),
                float(vm["loss"]),
                float(losses.mpjpe_mm(vm["mpjpe_sums"], n_val, d.num_joints, d.zero_centre)),
                lr=state.lr)
    except KeyboardInterrupt:
        if cfg.ctlc_save:
            path = ckpt.save(state, cfg.log_dir, "interrupt_" + cfg.run_name,
                             batch_size=cfg.batch_size)
            print(f"interrupted; saved {path}")
        raise

    path = ckpt.save(state, cfg.log_dir, cfg.run_name, batch_size=cfg.batch_size,
                     extra={"model": cfg.model})
    _save_visualizations(cfg, state, vy1, vy2)
    logger.finish()
    print(f"saved {path}")
    return state


def _save_visualizations(cfg: LiftConfig, state, vy1, vy2) -> None:
    """The end-of-run renders (train_1.py:159-184): the first and last
    samples of the first validation batch, ground truth against the eval
    prediction, into ``<log_dir>/visualizations/<run>/``."""
    try:
        from pose3d_tpu_torch.utils.visualize import visualize_3d

        state.model.eval()
        with torch.no_grad():
            pred = state.apply(state.model, vy1[0])
        pred = pred.reshape(-1, vy2.shape[-2], 3).cpu().numpy()
        gt = vy2[0].cpu().numpy()
        out_dir = pathlib.Path(cfg.log_dir) / "visualizations" / cfg.run_name
        visualize_3d(gt[0], pred[0], out_dir / "3d_test_a.png")
        visualize_3d(gt[-1], pred[-1], out_dir / "3d_test_b.png")
    except Exception as e:  # a render must never end a training run
        print(f"visualization skipped: {e}")


if __name__ == "__main__":
    train(parse_config(LiftConfig))
