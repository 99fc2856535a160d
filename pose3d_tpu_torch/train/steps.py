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
prediction back, average it with the plain prediction. The data-parallel
step comes with the port's ``torch.distributed`` work.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.core.transforms import flip_pose
from pose3d_tpu_torch.train.state import TrainState, clip_by_global_norm


def apply_gradients(loss_val: torch.Tensor, *states: TrainState) -> None:
    """One backward from ``loss_val``, then, for each state, the global-norm
    clip where set and one optimizer step at the lr the plateau schedule
    left in its optimizer. Several states take their gradients from the
    one backward, as the JAX loop step takes both models' gradients from
    one ``value_and_grad``: their parameters are disjoint."""
    for state in states:
        state.optimizer.zero_grad(set_to_none=True)
    loss_val.backward()
    for state in states:
        if state.grad_clip:
            clip_by_global_norm(list(state.model.parameters()), state.grad_clip)
        state.optimizer.step()
        state.step += 1


def make_lifter_train_step(loss: str = "mse"):
    """(state, y1, y2) -> {"loss", "mpjpe_sums"}: forward through
    ``state.apply`` in train mode, loss, backward, optimizer step at the lr
    the plateau schedule left in the optimizer. y1: model inputs; y2:
    targets, to whose shape the prediction is reshaped."""
    loss_fn = losses.LOSS_FNS[loss]

    def step(state: TrainState, y1: torch.Tensor, y2: torch.Tensor) -> dict:
        state.model.train()
        pred = state.apply(state.model, y1).reshape(y2.shape)
        loss_val = loss_fn(pred, y2)
        apply_gradients(loss_val, state)
        with torch.no_grad():
            sums = losses.loss_mpjpe(pred, y2)
        return {"loss": loss_val.detach(), "mpjpe_sums": sums}

    return step


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
