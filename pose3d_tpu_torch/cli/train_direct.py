"""Direct image -> 3D trainer (phases 3 and 4): the port of
``pose3d_tpu/cli/train_direct.py``.

Trains ``PoseNet3D`` (ResNet backbone, deconv head, a 64-deep volume per
joint, soft-argmax) with MSE on the coordinates, Adam (weight decay 1e-8
for phase 3, none for phase 4's video source) and the plateau schedule,
K optimizer steps a chunk (``--chunk_steps``). The model keeps f32
parameters and, with ``--bf16 true`` (the default), computes in bf16
under ``torch.autocast`` (``train.image_steps.bf16_apply``). With
``--fuse_final_conv true`` the decode runs the fused conv-decode kernels
(``ops/conv_decode``) forward and backward; the NHWC route trains on the
plain decode, as the JAX trainer's default does. ``--infer`` restores the
run's checkpoint and reports the validation MPJPE (the reference's
``train_3.py`` ``infer``).

Data: Human3.6M frames (``data.data_dir``: S1 trains, S11 validates, as
``train_3.py:41-42``; the keypoints through ``data/h36m.py``, the JPEG
frames decoded to uint8 by ``data/native_loader.py``, with cv2 where the
native library is not built), synthetic Human3.6M-like poses with random
frames where ``data.data_dir`` is unset or missing, or ``--source video``
(the phase-2 pipeline's frames and MotionBERT poses,
``data/video_dataset.py``).

Under a launcher (``torchrun --nproc_per_node=N -m
pose3d_tpu_torch.cli.train_direct``) every rank joins the world's mesh:
each batch of a chunk is split over the ranks, the BatchNorms are global
(``train.image_steps.make_direct_chunk_step(mesh=)``, the JAX trainer's
GSPMD contract), validation runs on the shards and reduces its metrics,
and rank 0 writes the log and the checkpoint. ``--infer`` stays one
process a rank.

Usage:
  python -m pose3d_tpu_torch.cli.train_direct --run_name d1 --n_epochs 5
  python -m pose3d_tpu_torch.cli.train_direct --infer --run_name d1
  python -m pose3d_tpu_torch.cli.train_direct --cpu --architecture resnet18 \\
      --image_size 64 --batch_size 4 --chunk_steps 2 --data.synthetic_frames 32 \\
      --n_epochs 1 --log_dir logs/dlog
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.config import DirectConfig, parse_config
from pose3d_tpu_torch.data import h36m, synthetic
from pose3d_tpu_torch.data.feed import batch_iterator, prefetch_to_device
from pose3d_tpu_torch.models.heads import PoseNet3D
from pose3d_tpu_torch.models.norm import sync_batch_norm
from pose3d_tpu_torch.parallel.mesh import (broadcast_parameters, data_size, launched_mesh,
                                            pmean_, psum_, shard_batch)
from pose3d_tpu_torch.train import checkpoint as ckpt
from pose3d_tpu_torch.train.epoch import stack_batches
from pose3d_tpu_torch.train.image_steps import (bf16_apply, make_direct_chunk_step,
                                                make_direct_eval_chunk_step,
                                                make_direct_eval_step)
from pose3d_tpu_torch.train.logging import MetricLogger
from pose3d_tpu_torch.train.state import create_train_state


def load_image_split(cfg: DirectConfig, is_train: bool):
    """-> (frames (N, S, S, 3) uint8 or f32 in [0, 1), kp3d (N, 17, 3), the
    3D statistics or None). A Human3.6M training split writes its
    statistics under ``<log_dir>/run_time_utils``, and its validation split
    reads them there."""
    d = cfg.data
    if cfg.source == "video":
        from pose3d_tpu_torch.data.video_dataset import load_video_dataset

        _, poses, frames = load_video_dataset(cfg.pipeline_root, cfg.video)
        split = int(len(poses) * 0.9)
        sl = slice(0, split) if is_train else slice(split, None)
        return frames[sl], poses[sl], None
    if d.data_dir and pathlib.Path(d.data_dir).exists():
        from pose3d_tpu_torch.data.native_loader import NativeImageLoader

        subjects = ("S1",) if is_train else ("S11",)  # train_3.py:41-42
        kp2d, kp3d, paths, cams = h36m.read_data(d.data_dir, subjects, d.action,
                                                 d.mono_3d_file, d.camera_view,
                                                 load_frame_paths=True)
        ds = h36m.preprocess(kp2d, kp3d, pathlib.Path(cfg.log_dir) / "run_time_utils",
                             is_train=is_train, zero_centre=d.zero_centre,
                             standardize_3d=d.standardize_3d, num_joints=d.num_joints,
                             split_rate=d.split_rate, frame_paths=paths, cam_ids=cams)
        # uint8 to the device; the step divides by 256 there
        frames = NativeImageLoader(cfg.image_size).decode_batch(ds.frame_paths, dtype=np.uint8)
        return frames, ds.kp3d, ds.stats3d
    n = d.synthetic_frames if is_train else max(d.synthetic_frames // 4, 8)
    _, kp3d = synthetic.synthetic_h36m(n, seed=0 if is_train else 1)
    kp3d = kp3d - kp3d[:, :1]
    frames = synthetic.synthetic_frames(n, cfg.image_size, seed=2 if is_train else 3)
    return (frames * 256.0).astype(np.uint8), kp3d, None


def _weight_decay(cfg: DirectConfig) -> float:
    """cfg.weight_decay=None -> the reference phase's optimizer default:
    phase 3 uses Adam(weight_decay=1e-8) (train_3.py:31), phase 4 a bare
    Adam(lr) with no decay (phase4_joined/train.py:39)."""
    if cfg.weight_decay is not None:
        return cfg.weight_decay
    return 0.0 if cfg.source == "video" else 1e-8


def _state(cfg: DirectConfig, return_heatmap: bool):
    """The f32 model from the seed on cfg's device, its optimizer and
    plateau schedule, and the apply of cfg's compute dtype."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --cpu to run on the CPU")
    model = PoseNet3D(cfg.architecture, z_scale=cfg.z_scale, return_heatmap=return_heatmap,
                      fuse_final_conv=cfg.fuse_final_conv, device="cpu")
    model = model.init_weights(torch.Generator().manual_seed(cfg.seed)).to(device)
    return create_train_state(model, lr=cfg.lr, optimizer=cfg.optimizer,
                              weight_decay=_weight_decay(cfg),
                              apply=bf16_apply if cfg.bf16 else None)


def _rank_major(batch, k: int, n_shards: int):
    """A chunk of k batches, rows reordered so that ``shard_batch`` gives
    each rank its rows of every batch: (k·B, ...) -> rank-major (N, k,
    B/N, ...) order, flattened."""
    return tuple(a.reshape(k, n_shards, -1, *a.shape[1:]).swapaxes(0, 1).reshape(a.shape)
                 for a in batch)


def train(cfg: DirectConfig, mesh=None):
    """Train for ``cfg.n_epochs`` epochs, logging each; returns the state.
    ``mesh``: data parallelism with global BatchNorm over its data axis
    (``main`` under a launcher); the batch size must split over it."""
    # the (B, J, 64^3) heatmap only where it is supervised; otherwise the
    # head decodes straight from NHWC (no layout transpose)
    state = _state(cfg, return_heatmap=cfg.heatmap_loss_weight > 0)
    device = next(state.model.parameters()).device
    n_shards = 1 if mesh is None else data_size(mesh)
    if mesh is not None:
        broadcast_parameters(state.model, mesh)
        sync_batch_norm(state.model, mesh)  # global BatchNorm; local again at the end
    if cfg.batch_size % n_shards:
        raise ValueError(f"--batch_size {cfg.batch_size} does not split over {n_shards} ranks")
    frames, kp3d, _ = load_image_split(cfg, is_train=True)
    vframes, vkp3d, _ = load_image_split(cfg, is_train=False)
    if cfg.resume and ckpt.exists(cfg.log_dir, cfg.run_name):
        state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
        print(f"resumed {cfg.run_name} at step {state.step}")

    k = max(cfg.chunk_steps, 1)
    step = make_direct_chunk_step(cfg.loss, cfg.heatmap_loss_weight, mesh)
    eval_step = make_direct_eval_chunk_step(cfg.loss)
    logger = MetricLogger(cfg.log_dir, cfg.run_name, config={
        "learning_rate": cfg.lr, "architecture": cfg.architecture,
        "dataset": "H3.6", "epochs": cfg.n_epochs,
    })
    chunk_frames = k * cfg.batch_size
    n_train = (len(frames) // chunk_frames) * chunk_frames
    if n_train == 0:
        raise ValueError(f"need >= {chunk_frames} frames (chunk_steps x batch_size); got "
                         f"{len(frames)}: lower --chunk_steps or --batch_size")
    # the validation set stacked into batches (this rank's rows of each)
    # and staged on the device once
    vb = min(cfg.batch_size, len(vframes))
    vb -= vb % n_shards
    vf_stack, vy_stack = stack_batches((vframes, vkp3d), vb)
    n_val = vf_stack.shape[0] * vf_stack.shape[1]
    if mesh is not None:
        vf_stack, vy_stack = (a.swapaxes(0, 1) for a in shard_batch(
            (vf_stack.swapaxes(0, 1), vy_stack.swapaxes(0, 1)), mesh))
    vf_stack, vy_stack = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                          for a in (vf_stack, vy_stack))
    b = cfg.batch_size // n_shards

    try:
        for epoch in range(cfg.n_epochs):
            chunks = batch_iterator((frames, kp3d), chunk_frames, shuffle=True,
                                    seed=cfg.seed + epoch, epochs=1)
            if mesh is not None:
                chunks = (_rank_major(c, k, n_shards) for c in chunks)
            loss_acc, mpjpe_acc, last_loss = [], [], None
            for f, y in prefetch_to_device(chunks, device, mesh=mesh):
                m = step(state, f.reshape(k, b, *f.shape[1:]), y.reshape(k, b, *y.shape[1:]))
                loss_acc.append(m["loss"])
                mpjpe_acc.append(m["mpjpe_sums"])
                last_loss = m["last_batch_loss"]
            # the reference steps its scheduler on the last train batch's loss
            state.plateau.step(float(last_loss))
            vm = eval_step(state, vf_stack, vy_stack)
            if mesh is not None:
                pmean_([vm["loss"]], mesh)
                psum_([vm["mpjpe_sums"]], mesh)
            logger.log_epoch(
                epoch, cfg.n_epochs,
                float(torch.stack(loss_acc).mean()),
                float(losses.mpjpe_mm(torch.stack(mpjpe_acc).sum(0), n_train)),
                float(vm["loss"]), float(losses.mpjpe_mm(vm["mpjpe_sums"], n_val)),
                lr=state.lr,
            )
    except KeyboardInterrupt:
        path = ckpt.save(state, cfg.log_dir, "interrupt_" + cfg.run_name,
                         batch_size=cfg.batch_size)
        print(f"interrupted; saved {path}")
        raise
    finally:
        sync_batch_norm(state.model, None)  # the mesh's group ends with main

    path = ckpt.save(state, cfg.log_dir, cfg.run_name, batch_size=cfg.batch_size)
    logger.finish()
    print(f"saved {path}")
    return state


def infer(cfg: DirectConfig) -> float:
    """Eval-only path (``train_3.py:173-232`` ``infer``): restore the run's
    checkpoint, return and print the validation MPJPE in mm."""
    # the JAX infer builds the default head (return_heatmap=True)
    state = _state(cfg, return_heatmap=True)
    device = next(state.model.parameters()).device
    vframes, vkp3d, _ = load_image_split(cfg, is_train=False)
    state, _ = ckpt.restore(state, cfg.log_dir, cfg.run_name)
    eval_step = make_direct_eval_step(cfg.loss)
    sums, n = None, 0
    for f, y in prefetch_to_device(batch_iterator((vframes, vkp3d), cfg.batch_size,
                                                  shuffle=False, epochs=1), device):
        m = eval_step(state, f, y)
        sums = m["mpjpe_sums"] if sums is None else sums + m["mpjpe_sums"]
        n += f.shape[0]
    mpjpe = float(losses.mpjpe_mm(sums, n))
    print(f"infer MPJPE(val): {mpjpe:.2f} mm over {n} frames")
    return mpjpe


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--infer" in argv:
        argv.remove("--infer")
        return infer(parse_config(DirectConfig, argv))
    cfg = parse_config(DirectConfig, argv)
    with launched_mesh(cfg.device) as mesh:
        return train(cfg, mesh)


if __name__ == "__main__":
    main()
