"""Eval steps of the direct image->3D models: the port of ``_normalize``,
``make_direct_eval_step`` and ``make_direct_eval_chunk_step`` of
``pose3d_tpu/train/image_steps.py`` (the train steps come with the
direct-training slice).

A step runs ``state.apply(state.model, frames)``, which returns
(coordinates, heatmap or None) as ``PoseNet3D`` does, without grads (the
decode kernels have no backward yet), and returns the loss and the
per-joint MPJPE sums (``losses.loss_mpjpe``); the caller sums those over
the eval set and finishes with ``losses.mpjpe_mm``.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch import losses


def _normalize(frames: torch.Tensor) -> torch.Tensor:
    """Integer (uint8) frames -> f32 / 256, the reference's convention
    (``H36_dataset.py``); float frames pass through, already normalised."""
    if not frames.is_floating_point():
        return frames.float() / 256.0
    return frames


def make_direct_eval_step(loss: str = "mse"):
    """(state, frames (B, H, W, 3) float or uint8, kp3d (B, 17, 3)) ->
    {"loss", "mpjpe_sums", "pred"}."""
    loss_fn = losses.LOSS_FNS[loss]

    @torch.no_grad()
    def step(state, frames: torch.Tensor, kp3d: torch.Tensor) -> dict:
        coords, _ = state.apply(state.model, _normalize(frames))
        pred = coords.reshape(kp3d.shape)
        return {"loss": loss_fn(pred, kp3d), "mpjpe_sums": losses.loss_mpjpe(pred, kp3d),
                "pred": pred}

    return step


def make_direct_eval_chunk_step(loss: str = "mse"):
    """Whole-eval-set step: (state, frames (K, B, H, W, 3), kp3d (K, B, 17,
    3)) -> {"loss": the mean of the K batch losses, "mpjpe_sums": their
    sum}, batch after batch."""
    eval_step = make_direct_eval_step(loss)

    def step(state, frames: torch.Tensor, kp3d: torch.Tensor) -> dict:
        out = [eval_step(state, f, y) for f, y in zip(frames, kp3d)]
        return {"loss": torch.stack([o["loss"] for o in out]).mean(),
                "mpjpe_sums": torch.stack([o["mpjpe_sums"] for o in out]).sum(0)}

    return step
