"""Train and eval steps of the lifters: the port of
``make_lifter_train_step`` / ``make_lifter_eval_step`` of
``pose3d_tpu/train/steps.py``.

A step returns the loss and the batch's per-joint MPJPE sums
(``losses.loss_mpjpe``); the epoch loop sums them and finishes with
``losses.mpjpe_mm``. The train step puts the model in train mode
(dropout on, BatchNorm on batch statistics), the eval step in eval mode.

Flip test-time augmentation: the reference's validation flip
(``train_1.py:128-134``) averages the flip of the unflipped input's
prediction, an operand bug. The eval step implements the documented
intent, as the JAX step does: predict on the flipped input, flip the
prediction back, average it with the plain prediction.

With a mesh the train step is the JAX package's step on a mesh:
each rank runs ``state.apply`` on its shard of the batch (on the fused
apply, the training kernels), one backward, then the loss and the
gradients are averaged and the MPJPE sums summed over the mesh's data
axis before the optimizer step, so every rank takes the global-batch
step. Dropout draws from the rank's generator as the caller left it; the
epoch seeds it per data rank (``train.epoch.make_lifter_epoch_fn``).

- ``make_lifter_train_step(mesh=)`` is JAX's GSPMD step
  (``make_lifter_train_step`` jitted over sharded inputs): a BatchNorm
  model's BatchNorms must be bound global over the data axis
  (``models/norm.sync_batch_norm``), and the model may be cut over the
  model axis (``parallel/sharding.shard_params``), whose shards the
  global-norm clip sums over the model group. The math is the
  one-process step on the global batch.
- ``make_dp_lifter_train_step`` is JAX's ``shard_map`` step: stats-free
  models with replicated parameters only, as JAX's refuses batch stats.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.core.transforms import flip_pose
from pose3d_tpu_torch.models.norm import require_batch_norm
from pose3d_tpu_torch.parallel.mesh import pmean_, psum_, psum_model_, require_group
from pose3d_tpu_torch.parallel.sharding import (require_sequence_mesh, require_tp_mesh,
                                                sequence_mesh, tp_layout, tp_shards)
from pose3d_tpu_torch.train.debug import span
from pose3d_tpu_torch.train.state import TrainState, clip_by_global_norm


def apply_gradients(loss_val: torch.Tensor, *states: TrainState, mesh=None) -> None:
    """One backward from ``loss_val``, then, for each state, the global-norm
    clip where set and one optimizer step at the lr the plateau schedule
    left in its optimizer. Several states take their gradients from the
    one backward, as the JAX loop step takes both models' gradients from
    one ``value_and_grad``: their parameters are disjoint. With ``mesh``
    every state's gradients are averaged over its data axis in one
    ``pmean_`` before the clip; a model cut over the model axis
    (``parallel.sharding.shard_params``) has its shards' squares summed
    over the model group in the clip, and a model whose frames are split
    over it (``parallel.sharding.sequence_parallel``) has its gradients,
    each rank's over its own frames, summed over the model group first."""
    for state in states:
        state.optimizer.zero_grad(set_to_none=True)
    with span("pose3d.train.backward"):
        loss_val.backward()
        if mesh is not None:
            for state in states:
                if sequence_mesh(state.model) is not None:
                    psum_model_([p.grad for p in state.model.parameters()
                                 if p.grad is not None], mesh)
            pmean_([p.grad for state in states for p in state.model.parameters()
                    if p.grad is not None], mesh)
    with span("pose3d.train.optimizer"):
        for state in states:
            if state.grad_clip:
                clip_by_global_norm(list(state.model.parameters()), state.grad_clip,
                                    *tp_shards(state.model))
            state.optimizer.step()
            state.step += 1


def make_lifter_train_step(loss: str = "mse", mesh=None):
    """(state, y1, y2) -> {"loss", "mpjpe_sums"}: forward through
    ``state.apply`` in train mode, loss, backward, optimizer step at the lr
    the plateau schedule left in the optimizer. y1: model inputs; y2:
    targets, to whose shape the prediction is reshaped.

    ``mesh``: y1, y2 are this rank's shard (``parallel.mesh.shard_batch``)
    of a global batch split evenly over its data axis; the gradients are
    averaged (``pmean_``) before the clip and the step, and the returned
    loss (``pmean_``) and MPJPE sums (``psum_``) are the global batch's,
    the same on every rank, so every rank's plateau schedule takes the
    same decision. A BatchNorm model's BatchNorms must be bound global
    over the mesh's data axis (``sync_batch_norm(model, mesh)``), else it
    raises; a model cut by ``shard_params``, or whose frames
    ``sequence_parallel`` split, runs over the mesh it was bound to, and
    only there."""
    loss_fn = losses.LOSS_FNS[loss]

    def step(state: TrainState, y1: torch.Tensor, y2: torch.Tensor) -> dict:
        with span("pose3d.train.step"):
            if mesh is not None:
                require_group(mesh)
                if has_batch_stats(state.model):
                    require_batch_norm(state.model, mesh)
            require_tp_mesh(state.model, mesh)
            require_sequence_mesh(state.model, mesh)
            state.model.train()
            with span("pose3d.train.forward"):
                pred = state.apply(state.model, y1).reshape(y2.shape)
                loss_val = loss_fn(pred, y2)
            apply_gradients(loss_val, state, mesh=mesh)
            with torch.no_grad():
                out = loss_val.detach()
                sums = losses.loss_mpjpe(pred, y2)
            if mesh is not None:
                out = out.clone()
                pmean_([out], mesh)
                psum_([sums], mesh)
            return {"loss": out, "mpjpe_sums": sums}

    return step


def make_dp_lifter_train_step(mesh, loss: str = "mse"):
    """JAX's ``shard_map`` step: ``make_lifter_train_step(loss, mesh)`` for
    stats-free models with replicated parameters, the fused training
    apply's route. A BatchNorm model raises, as JAX's step refuses batch
    stats, and so does a model cut over the model axis or whose frames are
    split over it."""
    step = make_lifter_train_step(loss, mesh)

    def dp_step(state: TrainState, y1: torch.Tensor, y2: torch.Tensor) -> dict:
        if has_batch_stats(state.model):
            raise ValueError("the DP lifter step supports stats-free models only; BatchNorm "
                             "models go through make_lifter_train_step(mesh=), bound global")
        if tp_layout(state.model)[0] is not None or sequence_mesh(state.model) is not None:
            raise ValueError("the DP lifter step takes replicated parameters and whole clips; "
                             "a sharded or sequence-parallel model goes through "
                             "make_lifter_train_step(mesh=)")
        return step(state, y1, y2)

    return dp_step


def has_batch_stats(model: torch.nn.Module) -> bool:
    """True where a module of ``model`` keeps running statistics."""
    return any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm) and m.track_running_stats
               for m in model.modules())


def eval_predict(state: TrainState, y1: torch.Tensor, shape, flip_tta: bool = False):
    """The model's prediction for y1 in eval mode, reshaped to ``shape``;
    with ``flip_tta`` averaged with the flip of its prediction for the
    flipped y1."""
    state.model.eval()
    pred = state.apply(state.model, y1).reshape(shape)
    if flip_tta:
        pred_f = state.apply(state.model, flip_pose(y1)).reshape(shape)
        pred = (flip_pose(pred_f) + pred) / 2.0
    return pred


def make_lifter_eval_step(loss: str = "mse", flip_tta: bool = False):
    """(state, y1, y2) -> {"loss", "mpjpe_sums", "pred"}, without grads."""
    loss_fn = losses.LOSS_FNS[loss]

    @torch.no_grad()
    def step(state: TrainState, y1: torch.Tensor, y2: torch.Tensor) -> dict:
        pred = eval_predict(state, y1, y2.shape, flip_tta)
        return {"loss": loss_fn(pred, y2), "mpjpe_sums": losses.loss_mpjpe(pred, y2),
                "pred": pred}

    return step
