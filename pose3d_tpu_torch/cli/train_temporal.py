"""Temporal sequence-lifter trainer: the port of
``pose3d_tpu/cli/train_temporal.py``.

Trains the ``TemporalLifter`` on clips of ``clip_len`` frames of the
Human3.6M export at ``data.data_dir`` (``data/h36m.read_data``: the
subjects of ``data.train_subjects`` / ``data.test_subjects``, the action
filter ``data.action``), or of synthetic Human3.6M-like poses where there
is none.
On a CUDA device at the kernels' widths (17 joints, hidden 256, 8 heads)
the step runs the fused sub-block kernels in bf16 over f32 parameters
(``ops/stblock_train``); otherwise it differentiates the module in f32.

Under a launcher (``torchrun --nproc_per_node=N -m
pose3d_tpu_torch.cli.train_temporal``) every rank joins the world's mesh
(``parallel/mesh.py``), the batch is trimmed to a multiple of N, each rank
stages its shard, and the step is the data-parallel one
(``train.steps.make_lifter_train_step(mesh=)``, on the fused apply where
the kernels serve); validation runs on the shards and reduces its metrics;
rank 0 writes the log and the checkpoint.

Usage:
  python -m pose3d_tpu_torch.cli.train_temporal --run_name t1 --clip_len 243
  python -m pose3d_tpu_torch.cli.train_temporal --cpu --n_blocks 1 --clip_len 12 \\
      --data.synthetic_frames 480 --n_epochs 2
"""

from __future__ import annotations

import pathlib

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.config import TemporalConfig, parse_config
from pose3d_tpu_torch.data import h36m, synthetic
from pose3d_tpu_torch.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu_torch.models.temporal import TemporalLifter, make_clips
from pose3d_tpu_torch.ops.stblock import supports
from pose3d_tpu_torch.ops.stblock_train import temporal_train_forward_fused
from pose3d_tpu_torch.parallel.mesh import (broadcast_parameters, data_size, launched_mesh,
                                            pmean_, psum_)
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.logging import MetricLogger
from pose3d_tpu_torch.train.state import create_train_state
from pose3d_tpu_torch.train.steps import make_lifter_eval_step, make_lifter_train_step


def load_clips(cfg: TemporalConfig, is_train: bool):
    """(2D clips, root-centred 3D clips) of the train or validation split."""
    d = cfg.data
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        subjects = d.train_subjects if is_train else d.test_subjects
        kp2d, kp3d, _, _ = h36m.read_data(d.data_dir, subjects, d.action)
    else:
        n = d.synthetic_frames if is_train else max(d.synthetic_frames // 4, cfg.clip_len)
        kp2d, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
    kp3d = kp3d - kp3d[:, :1]
    return make_clips(kp2d, cfg.clip_len, cfg.clip_len), make_clips(kp3d, cfg.clip_len,
                                                                    cfg.clip_len)


def _trim(n: int, n_shards: int) -> int:
    """n rounded down to a multiple of the data axis; raises where none is
    left."""
    n -= n % n_shards
    if n <= 0:
        raise ValueError(f"a batch smaller than the {n_shards} data ranks")
    return n


def train(cfg: TemporalConfig, mesh=None):
    """Train for ``cfg.n_epochs`` epochs, logging each; returns the state.
    ``mesh``: data parallelism over its data axis (``main`` under a
    launcher)."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to train on the CPU")
    model = TemporalLifter(clip_len=cfg.clip_len, hidden=cfg.hidden, n_blocks=cfg.n_blocks,
                           heads=cfg.heads, device="cpu")
    model = model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    n_shards = 1
    if mesh is not None:
        broadcast_parameters(model, mesh)
        n_shards = data_size(mesh)
    c2, c3 = load_clips(cfg, True)
    v2, v3 = load_clips(cfg, False)
    print(f"clips: train {c2.shape}, val {v2.shape}")

    fused = cfg.use_kernels_train and device.type == "cuda" and supports(model)
    state = create_train_state(model, lr=cfg.lr,
                               apply=temporal_train_forward_fused if fused else None)
    if fused:
        print("train step: fused sub-block kernels")
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed at step {state.step}")
    step = make_lifter_train_step(cfg.loss, mesh)
    if mesh is not None:
        print(f"train step: data parallel over {n_shards} ranks")
    eval_step = make_lifter_eval_step(cfg.loss)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": "temporal_transformer",
        "clip_len": cfg.clip_len, "epochs": cfg.n_epochs,
    })

    bs = _trim(min(cfg.batch_size, len(c2)), n_shards)
    vbs = _trim(min(bs, len(v2)), n_shards)
    n_train = (len(c2) // bs) * bs * cfg.clip_len
    for epoch in range(cfg.n_epochs):
        it = prefetch_to_device(batch_iterator((c2, c3), bs, shuffle=True, seed=cfg.seed + epoch,
                                               epochs=1), device, mesh=mesh)
        loss_acc, sums_acc, last = [], [], None
        for y1, y2 in it:
            m = step(state, y1, y2)
            loss_acc.append(m["loss"])
            sums_acc.append(m["mpjpe_sums"])
            last = m["loss"]
        # the reference steps its scheduler on the last train batch's loss
        state.plateau.step(float(last))

        vloss, vsums, n_val = [], [], 0
        for y1, y2 in prefetch_to_device(batch_iterator((v2, v3), vbs, shuffle=False, epochs=1),
                                         device, mesh=mesh):
            vm = eval_step(state, y1, y2)
            if mesh is not None:
                pmean_([vm["loss"]], mesh)
                psum_([vm["mpjpe_sums"]], mesh)
            vloss.append(vm["loss"])
            vsums.append(vm["mpjpe_sums"])
            n_val += vbs * cfg.clip_len
        logger.log_epoch(
            epoch, cfg.n_epochs,
            float(torch.stack(loss_acc).mean()),
            float(losses.mpjpe_mm(torch.stack(sums_acc).sum(0), n_train)),
            float(torch.stack(vloss).mean()),
            float(losses.mpjpe_mm(torch.stack(vsums).sum(0), n_val)),
            lr=state.lr,
        )

    # heads cannot be read back from parameter shapes: the sidecar keeps it
    path = ckpt.save(state, cfg.log_dir, cfg.run_name, batch_size=cfg.batch_size,
                     extra={"heads": cfg.heads, "hidden": cfg.hidden,
                            "n_blocks": cfg.n_blocks, "clip_len": cfg.clip_len})
    logger.finish()
    print(f"saved {path}")
    return state


def main(argv=None):
    cfg = parse_config(TemporalConfig, argv)
    with launched_mesh(cfg.device) as mesh:
        return train(cfg, mesh)


if __name__ == "__main__":
    main()
