"""Train and eval steps of the image models: the port of ``_normalize``,
``make_direct_train_step``, ``make_direct_chunk_step``,
``make_direct_eval_step``, ``make_direct_eval_chunk_step``,
``make_detector_chunk_step`` and ``make_detector_eval_step`` of
``pose3d_tpu/train/image_steps.py`` (the direct steps are the reference
``train_3.py`` loop body: MSE on the soft-argmax coordinates, Adam with
weight decay 1e-8, the plateau schedule; with the optional heatmap MSE
supervision of ``heatmap_loss_weight``).

The detector steps train and evaluate ``PoseNet2D`` on frames that
``data/synthetic.render_pose_frames`` renders on the keypoints' device
inside the step, so only the (K, B, 17, 2) keypoints come from the host.
Their noise comes from a ``torch.Generator`` on that device where the JAX
steps draw it from their key, so the two packages' frames differ by their
noise (the tests render with ``noise=0`` on both sides).

A step runs ``state.apply(state.model, frames)``, which returns
(coordinates, heatmap or None) as ``PoseNet3D`` does; ``bf16_apply`` runs
an f32 model in bf16 under ``torch.autocast``, the flax model's f32
parameters with a bf16 ``dtype``. The train steps put the model in train
mode (BatchNorm on batch statistics, running statistics updated), the
eval steps in eval mode, without grads. Steps return the loss and the
per-joint MPJPE sums (``losses.loss_mpjpe``); the caller sums those over
an epoch and finishes with ``losses.mpjpe_mm``. The chunk step is a
Python loop of K optimizer steps where the JAX step scans; the deconv
head has no dropout, so there is no rng to carry.

Data parallelism over a mesh's data axis (``parallel/mesh.py``), each
rank stepping on its shard of the global batch; the loss returned is the
global batch's and the MPJPE sums are summed over the ranks:

- ``make_direct_train_step(mesh=)`` / ``make_direct_chunk_step(mesh=)``:
  global BatchNorm (the JAX package's GSPMD contract): the model bound
  to the mesh with ``models/norm.sync_batch_norm`` by the caller, so the
  statistics are the global batch's; the gradients averaged (``pmean_``)
  before the optimizer step;
- ``make_dp_direct_train_step``: local BatchNorm (the JAX package's
  ``shard_map`` step, torch DDP without SyncBatchNorm): each shard
  normalised with its own statistics, the gradients and the updated
  running statistics averaged over the ranks. The fused route's decode
  kernels run on each shard.

The steps check the model's binding (``models/norm.require_batch_norm``)
and never change it.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.models.norm import require_batch_norm
from pose3d_tpu_torch.ops.heatmap import heatmap_targets
from pose3d_tpu_torch.parallel.mesh import pmean_, psum_
from pose3d_tpu_torch.train.steps import apply_gradients


def _normalize(frames: torch.Tensor) -> torch.Tensor:
    """Integer (uint8) frames -> f32 / 256, the reference's convention
    (``H36_dataset.py``); float frames pass through, already normalised."""
    if not frames.is_floating_point():
        return frames.float() / 256.0
    return frames


def bf16_apply(model, x):
    """``TrainState.apply`` for bf16 compute over f32 parameters: the
    module under ``torch.autocast`` to bf16 on x's device."""
    with torch.autocast(x.device.type, dtype=torch.bfloat16):
        return model(x)


def _global_metrics(total: torch.Tensor, pred: torch.Tensor, kp3d: torch.Tensor, mesh) -> dict:
    """{"loss", "mpjpe_sums"} of a step, over the mesh's global batch
    where there is one."""
    with torch.no_grad():
        out, sums = total.detach().clone(), losses.loss_mpjpe(pred, kp3d)
    if mesh is not None:
        pmean_([out], mesh)
        psum_([sums], mesh)
    return {"loss": out, "mpjpe_sums": sums}


def _direct_loss(state, frames, kp3d, loss_fn, heatmap_loss_weight):
    """(total loss, prediction) of the train-mode forward on ``frames``."""
    state.model.train()
    coords, hm = state.apply(state.model, _normalize(frames))
    pred = coords.reshape(kp3d.shape)
    total = loss_fn(pred, kp3d)
    if heatmap_loss_weight:
        hm_gt = heatmap_targets(kp3d.clamp(-1.0, 1.0), grid=hm.shape[-3:])
        total = total + heatmap_loss_weight * losses.mse(hm, hm_gt)
    return total, pred


def make_direct_train_step(loss: str = "mse", heatmap_loss_weight: float = 0.0, mesh=None):
    """(state, frames (B, H, W, 3) float or uint8, kp3d (B, 17, 3)) ->
    {"loss", "mpjpe_sums"} after one optimizer step. With
    ``heatmap_loss_weight`` the model must return its heatmap, and the loss
    adds that weight times the MSE between it and ``heatmap_targets`` of
    the keypoints clipped to [-1, 1], on the heatmap's (D, H, W) grid and
    in the targets' (u, v, w) order, as the JAX step compares them.

    ``mesh``: frames and kp3d are this rank's shard; the model's
    BatchNorms bound global over the data axis (``sync_batch_norm(model,
    mesh)``, else it raises), the gradients averaged before the step, and
    the metrics are the global batch's: one step of the global batch on
    every rank."""
    loss_fn = losses.LOSS_FNS[loss]

    def step(state, frames: torch.Tensor, kp3d: torch.Tensor) -> dict:
        if mesh is not None:
            require_batch_norm(state.model, mesh)
        total, pred = _direct_loss(state, frames, kp3d, loss_fn, heatmap_loss_weight)
        apply_gradients(total, state, mesh=mesh)
        return _global_metrics(total, pred, kp3d, mesh)

    return step


def make_direct_chunk_step(loss: str = "mse", heatmap_loss_weight: float = 0.0, mesh=None):
    """Multi-batch step: (state, frames (K, B, H, W, 3), kp3d (K, B, 17,
    3)) -> {"loss": the mean of the K batch losses, "last_batch_loss",
    "mpjpe_sums": their sum}, after K optimizer steps, batch after
    batch; with ``mesh`` each of them ``make_direct_train_step``'s global
    BatchNorm step on this rank's shards."""
    train_step = make_direct_train_step(loss, heatmap_loss_weight, mesh)

    def step(state, frames: torch.Tensor, kp3d: torch.Tensor) -> dict:
        out = [train_step(state, f, y) for f, y in zip(frames, kp3d)]
        loss_k = torch.stack([o["loss"] for o in out])
        return {"loss": loss_k.mean(), "last_batch_loss": loss_k[-1],
                "mpjpe_sums": torch.stack([o["mpjpe_sums"] for o in out]).sum(0)}

    return step


def make_dp_direct_train_step(mesh, loss: str = "mse", heatmap_loss_weight: float = 0.0):
    """Local-BN data-parallel step: (state, frames, kp3d: this rank's shard)
    -> {"loss", "mpjpe_sums"} of the global batch, after one optimizer
    step. Each rank normalises its shard with its own batch statistics
    (the model's BatchNorms local, else it raises), one backward, the
    gradients averaged over the data axis, the optimizer step, and the
    running statistics averaged over the ranks (for equal shards the mean
    of the shard means is the global mean; the averaged variance leaves
    out the spread between shard means, as torch DDP without
    SyncBatchNorm)."""
    loss_fn = losses.LOSS_FNS[loss]

    def step(state, frames: torch.Tensor, kp3d: torch.Tensor) -> dict:
        require_batch_norm(state.model, None)
        total, pred = _direct_loss(state, frames, kp3d, loss_fn, heatmap_loss_weight)
        apply_gradients(total, state, mesh=mesh)
        pmean_([b for m in state.model.modules()
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                for b in (m.running_mean, m.running_var)], mesh)
        return _global_metrics(total, pred, kp3d, mesh)

    return step


def make_direct_eval_step(loss: str = "mse"):
    """(state, frames (B, H, W, 3) float or uint8, kp3d (B, 17, 3)) ->
    {"loss", "mpjpe_sums", "pred"}."""
    loss_fn = losses.LOSS_FNS[loss]

    @torch.no_grad()
    def step(state, frames: torch.Tensor, kp3d: torch.Tensor) -> dict:
        state.model.eval()
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


def make_detector_chunk_step(image_size: int = 256):
    """2D-detector step over K batches: (state, kp2d (K, B, 17, 2) on the
    model's device, generator on that device) -> {"loss": the mean of the K
    batch losses, "last_batch_loss", "px_err": the last batch's mean L2
    error in pixels of the rendered image}, after K optimizer steps. Each
    batch's frames are rendered with ``generator``'s noise, then MSE on the
    coordinates (the phase-5 ``Model_2D`` pathway); ``state.apply`` returns
    the (B, 34) coordinates."""
    from pose3d_tpu_torch.data.synthetic import render_pose_frames

    def step(state, kp2d: torch.Tensor, generator: torch.Generator) -> dict:
        state.model.train()
        loss_k = []
        for y in kp2d:
            frames = render_pose_frames(y, generator, size=image_size)
            pred = state.apply(state.model, frames).reshape(y.shape)
            loss_val = losses.mse(pred, y)
            apply_gradients(loss_val, state)
            loss_k.append(loss_val.detach())
        loss_k = torch.stack(loss_k)
        with torch.no_grad():
            px = torch.linalg.vector_norm(pred - y, dim=-1).mean() * image_size
        return {"loss": loss_k.mean(), "last_batch_loss": loss_k[-1], "px_err": px}

    return step


def make_detector_eval_step(image_size: int = 256):
    """(state, kp2d (K, B, 17, 2), seed) -> the mean pixel error over the K
    batches, in eval mode without grads; the frames are rendered from a
    generator on kp2d's device seeded with ``seed``, so two calls with one
    seed see the same frames (the JAX trainer's fixed key 99)."""
    from pose3d_tpu_torch.data.synthetic import render_pose_frames

    @torch.no_grad()
    def step(state, kp2d: torch.Tensor, seed: int) -> torch.Tensor:
        state.model.eval()
        generator = torch.Generator(kp2d.device).manual_seed(seed)
        px = []
        for y in kp2d:
            frames = render_pose_frames(y, generator, size=image_size)
            pred = state.apply(state.model, frames).reshape(y.shape)
            px.append(torch.linalg.vector_norm(pred - y, dim=-1).mean())
        return torch.stack(px).mean() * image_size

    return step
