"""Whole-epoch lifter training and evaluation: the port of
``make_lifter_epoch_fn``, ``make_lifter_eval_epoch_fn`` and
``stack_batches`` of ``pose3d_tpu/train/epoch.py``.

The JAX epoch is one program that scans the step over the epoch's batch
stack. Here the stack lies on the device and a Python loop takes one
batch after another; each batch's loss and per-joint MPJPE sums stay on
the device, and the host reads the metrics once an epoch, as after the
scan. The conventions are the reference's: the epoch loss is the mean of
the batch losses, the MPJPE the per-joint sums over the epoch, finished
by ``losses.mpjpe_mm``. With a mesh each batch goes through the
data-parallel step (``train.steps.make_lifter_train_step(mesh=)``): the
batch stack holds this rank's shards, and the metrics are the global
batches'.
"""

from __future__ import annotations

import numpy as np
import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.parallel.mesh import data_rank, shard_seed
from pose3d_tpu_torch.train.state import TrainState
from pose3d_tpu_torch.train.steps import eval_predict, make_lifter_train_step


def make_lifter_epoch_fn(loss: str = "mse", mesh=None):
    """(state, y1_batches, y2_batches, seed) -> metrics, after one
    optimizer step a batch. y1_batches (n_batches, B, 17, 2) and y2_batches
    (n_batches, B, 17, 3) on the model's device. Dropout draws its masks
    from the device's generator seeded with ``seed`` for the epoch (the
    callers' state outside is restored), so one seed gives one run.
    Metrics: ``loss`` (the mean of the batch losses), ``last_batch_loss``
    (what the plateau schedule steps on) and ``mpjpe_sums`` (J,), tensors
    on the device.

    ``mesh``: epochs of ``make_lifter_train_step(mesh=)`` (a BatchNorm
    model bound global over the data axis, a sharded model over the mesh
    it was cut for). The stacks hold this rank's shard of each batch; the
    generator is seeded with ``shard_seed(seed, data_rank)``, so the
    model ranks of one data rank draw one stream, and the metrics are the
    global batches'."""
    step = make_lifter_train_step(loss, mesh)

    def epoch(state: TrainState, y1_batches: torch.Tensor, y2_batches: torch.Tensor,
              seed: int) -> dict:
        device = y1_batches.device
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                   device_type="cuda"):
            torch.manual_seed(shard_seed(seed, 0 if mesh is None else data_rank(mesh)))
            ms = [step(state, y1, y2) for y1, y2 in zip(y1_batches, y2_batches)]
        batch_losses = torch.stack([m["loss"] for m in ms])
        return {"loss": batch_losses.mean(), "last_batch_loss": batch_losses[-1],
                "mpjpe_sums": torch.stack([m["mpjpe_sums"] for m in ms]).sum(0)}

    return epoch


def make_lifter_eval_epoch_fn(loss: str = "mse", flip_tta: bool = False):
    """(state, y1_batches, y2_batches) -> {"loss", "mpjpe_sums"} in eval mode
    without grads; ``flip_tta`` as ``train.steps.make_lifter_eval_step``."""
    loss_fn = losses.LOSS_FNS[loss]

    @torch.no_grad()
    def epoch(state: TrainState, y1_batches: torch.Tensor, y2_batches: torch.Tensor) -> dict:
        batch_losses, sums = [], []
        for y1, y2 in zip(y1_batches, y2_batches):
            pred = eval_predict(state, y1, y2.shape, flip_tta)
            batch_losses.append(loss_fn(pred, y2))
            sums.append(losses.loss_mpjpe(pred, y2))
        return {"loss": torch.stack(batch_losses).mean(),
                "mpjpe_sums": torch.stack(sums).sum(0)}

    return epoch


def stack_batches(arrays, batch_size: int, rng=None):
    """Shuffle (with ``rng``, a numpy Generator) and reshape (N, ...)
    arrays into (n_batches, batch_size, ...), dropping the remainder (the
    reference's DataLoader keeps a partial batch, a documented deviation
    that only moves the epoch's boundary)."""
    n = len(arrays[0])
    idx = rng.permutation(n) if rng is not None else np.arange(n)
    n_batches = n // batch_size
    idx = idx[: n_batches * batch_size]
    return tuple(a[idx].reshape(n_batches, batch_size, *a.shape[1:]) for a in arrays)
