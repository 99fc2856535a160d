"""Losses and the MPJPE metric: the port of ``l1``, ``mse``,
``loss_mpjpe`` and ``mpjpe_mm`` of ``pose3d_tpu/losses.py`` (the triangle
losses come with the consistency-loop trainers).

``loss_mpjpe`` is the reference's ``loss_MPJPE``: per-joint L2 errors
summed over every leading axis -> (J,). Trainers sum it over an epoch and
``mpjpe_mm`` turns the sums into millimetres: the mean over joints 1:,
times (17/16)·1000 when the root is zero-centred.
"""

from __future__ import annotations

import torch


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean()


LOSS_FNS = {"mse": mse, "l1": l1}


def loss_mpjpe(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(..., J, D) -> (J,): per-joint L2 error summed over leading axes."""
    err = torch.linalg.vector_norm(pred - target, dim=-1)
    return err.sum(dim=tuple(range(err.dim() - 1)))


def mpjpe_mm(per_joint_sums: torch.Tensor, dataset_size, num_joints: int = 17,
             zero_centred: bool = True) -> torch.Tensor:
    """Accumulated per-joint sums -> the reference's metric in mm."""
    metric = (per_joint_sums[1:num_joints] / dataset_size).mean()
    if num_joints == 17 and zero_centred:
        metric = metric * (17.0 / 16.0) * 1000.0
    return metric
