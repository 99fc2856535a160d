"""Phase-5 trainer, the 2D + 3D + frozen-lifter consistency loop: the port of
``pose3d_tpu/cli/train_loop.py`` (the reference ``phase5_loop/
train_5.py``).

``PoseNet2D`` and ``PoseNet3D`` (``return_heatmap=True``, the plain
heatmap decode, as the JAX trainer builds it) trained together, each with
AdamW at lr 5e-4 (the torch-default decoupled decay 1e-2) and its plateau
schedule stepped on the epoch's last batch loss; with ``--triangle true``
a frozen phase-1 ViT lifter (``cli/train_lift`` checkpoint
``--lifter_checkpoint``) and the triangle loss (``--triangle_mode sep``
or ``cycle``); with ``--project true`` a frozen ViT projector
(``cli/train_project`` checkpoint ``--projector_checkpoint``); with
``--flip true`` the flip as one batch of twice the size
(``train/loop_steps.py``). A frozen checkpoint that is missing is a fresh
init from seed 0, and the trainer says so. The image models keep f32
parameters and, with ``--bf16 true`` (the default), compute in bf16 under
``torch.autocast``; the frozen ViTs stay f32.

Data: Human3.6M frames of the ``Walking`` action, every 64th frame
(``data.data_dir``: S1 trains, S11 validates, the frames through
``cli/train_direct.load_image_split``, uint8, divided by 256 in the
step), or synthetic poses with random float frames where the export is
absent. Each epoch's JSONL record carries the averages of the loss
terms. On an interrupt the models go to ``interrupt_<run>_2d`` / ``_3d``;
at the end to ``<run>_2d`` / ``<run>_3d``. Under a launcher (``torchrun
--nproc_per_node=N -m pose3d_tpu_torch.cli.train_loop``) every rank joins
the world's mesh, takes its rows of each batch and steps with both image
models' BatchNorms global (``train.loop_steps.make_loop_train_step(mesh=)``,
the JAX trainer's GSPMD contract); validation runs on the shards and
reduces its metrics; rank 0 writes the log and the checkpoints.

Usage:
  python -m pose3d_tpu_torch.cli.train_loop --triangle true --flip true \\
      --lifter_checkpoint lift_run --run_name loop1
  python -m pose3d_tpu_torch.cli.train_loop --cpu --architecture resnet18 --image_size 64 \\
      --batch_size 4 --n_epochs 1 --data.synthetic_frames 16 --log_dir logs/loop
"""

from __future__ import annotations

import pathlib

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.config import DirectConfig, LoopConfig, parse_config
from pose3d_tpu_torch.data import h36m, synthetic
from pose3d_tpu_torch.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu_torch.models.heads import PoseNet2D, PoseNet3D
from pose3d_tpu_torch.models.lifters import JointTransformerLifter
from pose3d_tpu_torch.models.norm import sync_batch_norm
from pose3d_tpu_torch.parallel.mesh import (broadcast_parameters, data_size, launched_mesh,
                                            pmean_, psum_)
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.image_steps import bf16_apply
from pose3d_tpu_torch.train.logging import MetricLogger
from pose3d_tpu_torch.train.loop_steps import (LoopState, freeze, loop_plateau_step,
                                               make_loop_eval_step, make_loop_train_step)
from pose3d_tpu_torch.train.state import create_train_state


def _load_frozen(model: torch.nn.Module, log_dir, run_name: str | None) -> torch.nn.Module:
    """``model`` holding a port checkpoint's parameters (``run_name`` under
    ``log_dir``, whatever optimizer it was trained with), or its fresh init
    from seed 0 where there is none; frozen."""
    model.init_weights(torch.Generator().manual_seed(0))
    if run_name and ckpt.exists(log_dir, run_name):
        ckpt.restore_params(log_dir, run_name, model)
        print(f"frozen model restored from {run_name}")
    else:
        print(f"frozen checkpoint {run_name!r} not found; fresh init")
    return freeze(model)


def load_frames_split(cfg: LoopConfig, is_train: bool):
    """-> (frames (N, S, S, 3) uint8 or f32 in [0, 1), kp2d (N, 17, 2), kp3d
    (N, 17, 3)). The Human3.6M branch reads the 2D keypoints of the same
    subject and order as its frames (S1 or S11)."""
    d = cfg.data
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        from pose3d_tpu_torch.cli.train_direct import load_image_split

        dcfg = DirectConfig(log_dir=cfg.log_dir, image_size=cfg.image_size, data=d)
        frames, kp3d, _ = load_image_split(dcfg, is_train)
        subjects = ("S1",) if is_train else ("S11",)
        kp2d, _, _, _ = h36m.read_data(d.data_dir, subjects, d.action)
        if d.split_rate:
            kp2d = kp2d[::d.split_rate]
        if len(kp2d) < len(frames):
            raise ValueError(f"{len(kp2d)} 2D poses for {len(frames)} frames")
        return frames, kp2d[: len(frames)], kp3d
    n = d.synthetic_frames if is_train else max(d.synthetic_frames // 4, 8)
    kp2d, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
    kp3d = kp3d - kp3d[:, :1]
    frames = synthetic.synthetic_frames(n, cfg.image_size, seed=4 if is_train else 5)
    return frames, kp2d, kp3d


def build_state(cfg: LoopConfig) -> LoopState:
    """Both image models from the seed (2D: ``cfg.seed``, 3D: ``cfg.seed +
    1``) with their AdamW and plateau schedules, and the frozen models
    the config asks for, on cfg's device."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to train on the CPU")
    apply = bf16_apply if cfg.bf16 else None
    model2d = PoseNet2D(cfg.architecture, device="cpu")
    model2d.init_weights(torch.Generator().manual_seed(cfg.seed))
    model3d = PoseNet3D(cfg.architecture, return_heatmap=True, device="cpu")
    model3d.init_weights(torch.Generator().manual_seed(cfg.seed + 1))
    lifter = projector = None
    if cfg.triangle:
        lifter = _load_frozen(JointTransformerLifter(device="cpu"), cfg.log_dir,
                              cfg.lifter_checkpoint).to(device)
    if cfg.project:
        projector = _load_frozen(JointTransformerLifter(in_dim=3, out_dim=2, device="cpu"),
                                 cfg.log_dir, cfg.projector_checkpoint).to(device)
    return LoopState(
        net2d=create_train_state(model2d.to(device), lr=cfg.lr, apply=apply),
        net3d=create_train_state(model3d.to(device), lr=cfg.lr, apply=apply),
        lifter=lifter, projector=projector)


def _mean(values) -> float:
    return float(torch.stack(values).mean())


def train(cfg: LoopConfig, mesh=None) -> LoopState:
    """Train for ``cfg.n_epochs`` epochs, logging each; returns the state.
    ``mesh``: data parallelism with global BatchNorm over its data axis
    (``main`` under a launcher); the batch size must split over it."""
    state = build_state(cfg)
    device = next(state.net2d.model.parameters()).device
    if mesh is not None:
        for net in (state.net2d, state.net3d):
            broadcast_parameters(net.model, mesh)
            sync_batch_norm(net.model, mesh)  # global BatchNorm; local again at the end
        if cfg.batch_size % data_size(mesh):
            raise ValueError(f"--batch_size {cfg.batch_size} does not split over "
                             f"{data_size(mesh)} ranks")
    frames, kp2d, kp3d = load_frames_split(cfg, True)
    vframes, vkp2d, vkp3d = load_frames_split(cfg, False)

    step = make_loop_train_step(triangle=cfg.triangle, flip=cfg.flip, project=cfg.project,
                                triangle_mode=cfg.triangle_mode, mesh=mesh)
    eval_step = make_loop_eval_step(flip=cfg.flip)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": cfg.architecture, "dataset": "H3.6",
        "epochs": cfg.n_epochs, "triangle": cfg.triangle, "flip": cfg.flip,
        "project": cfg.project,
    })
    n_train = (len(frames) // cfg.batch_size) * cfg.batch_size

    try:
        for epoch in range(cfg.n_epochs):
            it = prefetch_to_device(batch_iterator((frames, kp2d, kp3d), cfg.batch_size,
                                                   shuffle=True, seed=cfg.seed + epoch,
                                                   epochs=1), device, mesh=mesh)
            loss_acc, sums_acc, term_acc, last = [], [], [], None
            for f, y1, y2 in it:
                m = step(state, f, y1, y2)
                loss_acc.append(m["loss"])
                sums_acc.append(m["mpjpe_sums"])
                term_acc.append({k: v for k, v in m.items() if k.startswith("loss_")})
                last = m["loss"]
            loop_plateau_step(state, last)

            vloss, vsums, n_val = [], [], 0
            for f, y1, y2 in prefetch_to_device(batch_iterator(
                    (vframes, vkp2d, vkp3d), cfg.batch_size, shuffle=False, epochs=1), device,
                    mesh=mesh):
                vm = eval_step(state, f, y1, y2)
                if mesh is not None:
                    pmean_([vm["loss"]], mesh)
                    psum_([vm["mpjpe_sums"]], mesh)
                vloss.append(vm["loss"])
                vsums.append(vm["mpjpe_sums"])
                n_val += cfg.batch_size

            # the per-term averages (the reference's TriangleLoss.report_losses)
            terms = ({k: _mean([t[k] for t in term_acc]) for k in term_acc[0]}
                     if term_acc else {})
            logger.log_epoch(
                epoch, cfg.n_epochs, _mean(loss_acc),
                float(losses.mpjpe_mm(torch.stack(sums_acc).sum(0), n_train)),
                _mean(vloss), float(losses.mpjpe_mm(torch.stack(vsums).sum(0), n_val)),
                lr=state.net3d.lr, **terms)
            if device.type == "cuda":
                print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
                      "GiB", flush=True)
    except KeyboardInterrupt:
        for tag, net in (("2d", state.net2d), ("3d", state.net3d)):
            ckpt.save(net, cfg.log_dir, f"interrupt_{cfg.run_name}_{tag}",
                      batch_size=cfg.batch_size)
        print("interrupted; saved interrupt checkpoints")
        raise
    finally:
        for net in (state.net2d, state.net3d):
            sync_batch_norm(net.model, None)  # the mesh's group ends with main

    paths = [ckpt.save(net, cfg.log_dir, f"{cfg.run_name}_{tag}", batch_size=cfg.batch_size)
             for tag, net in (("2d", state.net2d), ("3d", state.net3d))]
    logger.finish()
    print(f"saved {paths[0]} and {paths[1]}")
    return state


def main(argv=None):
    cfg = parse_config(LoopConfig, argv)
    with launched_mesh(cfg.device) as mesh:
        return train(cfg, mesh)


if __name__ == "__main__":
    main()
