"""The phase-5 consistency loop's steps: the port of
``pose3d_tpu/train/loop_steps.py`` (the reference ``phase5_loop/
train_5.py``).

Two trained image models, ``Model_2D`` (``PoseNet2D``) and ``Model_3D``
(``PoseNet3D``), each with its AdamW and plateau schedule, a frozen
phase-1 ViT lifter and an optional frozen ViT projector, combined by
``losses.triangle_loss_sep`` (``triangle_mode="sep"``), by
``losses.triangle_loss`` (``"cycle"``), or by the two models' MSE.

- The frozen models take no gradient of their own parameters, but the
  loss differentiates through them with respect to the image models'
  predictions: ``freeze`` sets ``requires_grad_(False)`` and eval mode,
  and their calls on the predictions run with autograd on. Their calls on
  the ground truth need no graph. They run outside the image models'
  ``torch.autocast`` region (``state.apply``), in their own dtype, as the
  JAX loop applies f32 flax modules beside bf16 image models.
- The flip runs as one batch of twice the size: the frames and their
  horizontal flip (NHWC's W axis) through each image model once, so
  BatchNorm's batch statistics span all 2B frames and its running
  statistics update once a step; each prediction is averaged with the
  flip (``core/transforms.flip_pose``) of its twin's.
- One backward over the combined loss gives both models' gradients
  (``train/steps.apply_gradients`` with both states), as one
  ``value_and_grad`` does in JAX.
- Frames pass through ``image_steps._normalize``: uint8 frames are
  divided by 256 and float frames pass as they are. The JAX loop steps
  feed uint8 Human3.6M frames to the models unnormalised (0-255); the port
  does not carry that fault over. On float frames the steps compute JAX's
  function.

Nothing on this path has dropout (the deconv head has none, and the
frozen ViTs run in eval mode), so a step is a deterministic function and
takes no rng.

Under a mesh (``make_loop_train_step(mesh=)``) each rank steps on its
shard of the global batch with both image models' BatchNorms bound global
over the data axis by the caller (``models/norm.sync_batch_norm``, the
JAX package's GSPMD contract; the step checks it): the flip batch of
2·B/N frames on each rank shares its statistics with every rank's
through the global BatchNorm. The frozen models stay in eval mode, with
no collective. Both models' gradients are averaged in one ``pmean_``;
the loss and its terms are the global batch's and the MPJPE sums are
summed over the ranks.
"""

from __future__ import annotations

import dataclasses

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.core.transforms import flip_pose
from pose3d_tpu_torch.models.norm import require_batch_norm
from pose3d_tpu_torch.parallel.mesh import pmean_, psum_
from pose3d_tpu_torch.train.image_steps import _normalize
from pose3d_tpu_torch.train.state import TrainState
from pose3d_tpu_torch.train.steps import apply_gradients


@dataclasses.dataclass
class LoopState:
    net2d: TrainState
    net3d: TrainState
    lifter: torch.nn.Module | None = None     # frozen
    projector: torch.nn.Module | None = None  # frozen


def freeze(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in eval mode with no parameter that takes a gradient."""
    return model.requires_grad_(False).eval()


def _predict(state: LoopState, frames: torch.Tensor, flip: bool):
    """(y1_hat (B, 17, 2), y2_hat (B, 17, 3)) of both image models in the
    mode they are in, flip-averaged through one batch of 2B frames."""
    b = frames.shape[0]
    frames = _normalize(frames)
    if flip:
        frames = torch.cat([frames, frames.flip(2)], 0)
    y1_hat = state.net2d.apply(state.net2d.model, frames).reshape(-1, 17, 2)
    y2_hat = state.net3d.apply(state.net3d.model, frames)[0].reshape(-1, 17, 3)
    if flip:
        y1_hat = (y1_hat[:b] + flip_pose(y1_hat[b:])) / 2.0
        y2_hat = (y2_hat[:b] + flip_pose(y2_hat[b:])) / 2.0
    return y1_hat, y2_hat


def make_loop_train_step(*, triangle: bool = False, flip: bool = False, project: bool = False,
                         triangle_mode: str = "sep", mesh=None):
    """(LoopState, frames (B, H, W, 3) float or uint8, y1 (B, 17, 2), y2 (B,
    17, 3)) -> {"loss", "mpjpe_sums", and each loss term}, after one step
    of each image model's optimizer. ``triangle`` needs ``state.lifter``;
    ``project`` adds the projection terms where ``state.projector`` is
    set. With ``mesh`` the arrays are this rank's shard and the step is
    the global batch's (both image models bound global with
    ``sync_batch_norm``, averaged gradients, global metrics)."""
    if triangle_mode not in ("sep", "cycle"):
        raise ValueError(f"triangle_mode must be sep|cycle, got {triangle_mode}")

    def step(state: LoopState, frames: torch.Tensor, y1: torch.Tensor, y2: torch.Tensor) -> dict:
        if mesh is not None:
            require_batch_norm(state.net2d.model, mesh)
            require_batch_norm(state.net3d.model, mesh)
        state.net2d.model.train()
        state.net3d.model.train()
        y1_hat, y2_hat = _predict(state, frames, flip)
        if triangle:
            if state.lifter is None:
                raise ValueError("the triangle loss needs a frozen lifter")
            projector = state.projector if project else None
            lift_pred = state.lifter(y1_hat).reshape(y2.shape)
            proj_pred = proj_gt = None
            if projector is not None:
                proj_pred = projector(y2_hat).reshape(y1.shape)
            if triangle_mode == "cycle":
                total, terms = losses.triangle_loss(y1_hat, y2_hat, lift_pred, y1, y2, proj_pred)
            else:
                with torch.no_grad():
                    lift_gt = state.lifter(y1).reshape(y2.shape)
                    if projector is not None:
                        proj_gt = projector(y2).reshape(y1.shape)
                total, terms = losses.triangle_loss_sep(y1_hat, y2_hat, lift_gt, lift_pred,
                                                        y1, y2, proj_pred, proj_gt)
        else:
            terms = {"loss_2d": losses.mse(y1_hat, y1), "loss_3d": losses.mse(y2_hat, y2)}
            total = terms["loss_2d"] + terms["loss_3d"]
        apply_gradients(total, state.net2d, state.net3d, mesh=mesh)
        with torch.no_grad():
            sums = losses.loss_mpjpe(y2_hat, y2)
            out = {"loss": total.detach().clone(), **{k: v.detach().clone()
                                                      for k, v in terms.items()}}
        if mesh is not None:
            pmean_(out.values(), mesh)
            psum_([sums], mesh)
        return {**out, "mpjpe_sums": sums}

    return step


def make_loop_eval_step(flip: bool = False):
    """(LoopState, frames, y1, y2) -> {"loss": the 3D MSE, "loss_2d",
    "mpjpe_sums"} in eval mode without grads, flip-averaged as the train
    step."""

    @torch.no_grad()
    def step(state: LoopState, frames: torch.Tensor, y1: torch.Tensor, y2: torch.Tensor) -> dict:
        state.net2d.model.eval()
        state.net3d.model.eval()
        y1_hat, y2_hat = _predict(state, frames, flip)
        return {"loss": losses.mse(y2_hat, y2), "loss_2d": losses.mse(y1_hat, y1),
                "mpjpe_sums": losses.loss_mpjpe(y2_hat, y2)}

    return step


def loop_plateau_step(state: LoopState, metric) -> None:
    """Each image model's plateau schedule, stepped once on ``metric``
    (the reference steps both on the epoch's last batch loss)."""
    metric = float(metric)
    state.net2d.plateau.step(metric)
    state.net3d.plateau.step(metric)
