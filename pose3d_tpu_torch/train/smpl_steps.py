"""The train step of the SMPL-IK pose model (``HybrIKPose``): the port of
``pose3d_tpu/train/smpl_steps.py``.

The reference ships ``Simple3DPoseBaseSMPL`` without a trainer; the JAX
package's step makes it trainable: L1 on the 29-joint uvd, plus L1 on the
17 Human3.6M joints that HybrIK reconstructs (differentiated through the
naive IK path, the reference's train-time dispatch, lbs.py:356-365),
plus ``beta_weight`` times the mean square of the predicted betas' offset
from ``init_shape``. The plateau schedule sets the lr in the optimizer
(Adam in the JAX test), then one optimizer step.

With a mesh the step is JAX's on its data axis (``__graft_entry__``'s
stage 4, GSPMD over the batch): frames, cameras and targets are this
rank's shard, the model's BatchNorms bound global over the data axis
(``models/norm.sync_batch_norm``, else it raises), the dropout masks from
``shard_seed(seed, data_rank)``, the gradients and the loss averaged and
the MPJPE sums summed over the data axis, as
``image_steps.make_direct_train_step(mesh=)`` does.
"""

from __future__ import annotations

import torch

from pose3d_tpu_torch import losses
from pose3d_tpu_torch.models.norm import require_batch_norm
from pose3d_tpu_torch.parallel.mesh import data_rank, pmean_, psum_, shard_seed
from pose3d_tpu_torch.train.steps import apply_gradients


def make_hybrik_train_step(uvd_weight: float = 1.0, xyz17_weight: float = 1.0,
                           beta_weight: float = 1e-2, mesh=None):
    """(state, frames (B, H, W, 3), cam (trans_inv, k_inv, root, depth),
    uvd29_gt (B, 29, 3), xyz17_gt (B, 17, 3), seed) -> {"loss",
    "mpjpe_sums"}, after one optimizer step. ``state.model`` is a
    ``HybrIKPose`` (its parameters are the net's); ``state.apply`` runs it
    on the frames (``image_steps.bf16_apply`` for bf16 compute). The
    dropout masks come from the frames' device's generator seeded with
    ``seed`` (the callers' generator state is restored), as the lifter
    epochs take theirs, where the JAX step takes a key.

    ``mesh``: the arrays are this rank's shard of the global batch; the
    step is the global batch's (module docstring)."""

    def step(state, frames: torch.Tensor, cam, uvd29_gt: torch.Tensor,
             xyz17_gt: torch.Tensor, seed: int) -> dict:
        if mesh is not None:
            require_batch_norm(state.model, mesh)
        model = state.model.train()
        device = frames.device
        with torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                   device_type="cuda"):
            torch.manual_seed(seed if mesh is None else shard_seed(seed, data_rank(mesh)))
            out = state.apply(lambda x: model(x, *cam), frames)
        uvd = out["pred_uvd_jts"].reshape(uvd29_gt.shape)
        xyz17 = out["pred_xyz_jts_17"].reshape(xyz17_gt.shape)
        total = (uvd_weight * losses.l1(uvd, uvd29_gt)
                 + xyz17_weight * losses.l1(xyz17, xyz17_gt)
                 + beta_weight * out["pred_delta_shape"].square().mean())
        apply_gradients(total, state, mesh=mesh)
        with torch.no_grad():
            out, sums = total.detach().clone(), losses.loss_mpjpe(xyz17, xyz17_gt)
        if mesh is not None:
            pmean_([out], mesh)
            psum_([sums], mesh)
        return {"loss": out, "mpjpe_sums": sums}

    return step
