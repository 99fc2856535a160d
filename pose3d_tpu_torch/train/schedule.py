"""Reduce-LR-on-plateau with the reference's settings (train_1.py:41):
the port of ``pose3d_tpu/train/schedule.py``, whose ``plateau_update``
reproduces ``torch.optim.lr_scheduler.ReduceLROnPlateau``; here the torch
scheduler itself is the state. It writes the reduced lr into the
optimizer's parameter groups, so every later step reads it, as the JAX
step writes ``plateau.lr`` into the optimizer (``TrainState.with_lr``).
"""

from __future__ import annotations

import torch

PLATEAU = {"mode": "min", "factor": 0.7, "patience": 3, "cooldown": 2, "min_lr": 5e-6,
           "threshold": 1e-4, "threshold_mode": "rel"}


def make_plateau(optimizer: torch.optim.Optimizer):
    """The plateau scheduler of ``optimizer``; step it once an epoch with
    the metric (lower is better)."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(optimizer, **PLATEAU)
