"""Losses and the MPJPE metric: the port of ``pose3d_tpu/losses.py``.

``loss_mpjpe`` is the reference's ``loss_MPJPE``: per-joint L2 errors
summed over every leading axis -> (J,). Trainers sum it over an epoch and
``mpjpe_mm`` turns the sums into millimetres: the mean over joints 1:,
times (17/16)·1000 when the root is zero-centred.

``triangle_loss`` (the reference ``TriangleLoss``) and
``triangle_loss_sep`` (``TriangleLoss_sep``) are the consistency loop's
losses. Their projection terms centre each pose on its root joint, as the
JAX package does: the reference's ``proj[1:] -= proj[0]`` indexes the
batch axis, subtracting sample 0 from the others, a bug neither package
reproduces.
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


def _root_centre(x: torch.Tensor) -> torch.Tensor:
    """(..., J, D) poses, each minus its root joint (joint 0)."""
    return x - x[..., :1, :]


def triangle_loss(pred_2d, pred_3d, lift_of_pred2d, gt_2d, gt_3d, proj_of_pred3d=None):
    """The cycle-consistency loss (reference ``TriangleLoss``): (total, the
    per-term dict). L1(pred2d, gt2d) + L1(pred3d, gt3d) + L1(lift(pred2d),
    pred3d), plus L1 of the root-centred proj(pred3d) and pred2d where
    ``proj_of_pred3d`` is given."""
    terms = {"loss_2d": l1(pred_2d, gt_2d), "loss_3d": l1(pred_3d, gt_3d),
             "loss_lift": l1(lift_of_pred2d, pred_3d)}
    total = terms["loss_2d"] + terms["loss_3d"] + terms["loss_lift"]
    if proj_of_pred3d is not None:
        terms["loss_proj"] = l1(_root_centre(proj_of_pred3d), _root_centre(pred_2d))
        total = total + terms["loss_proj"]
    return total, terms


def triangle_loss_sep(pred_2d, pred_3d, lift_of_gt2d, lift_of_pred2d, gt_2d, gt_3d,
                      proj_of_pred3d=None, proj_of_gt3d=None):
    """The supervised loss (reference ``TriangleLoss_sep``): (total, the
    per-term dict). 2d + 3d + domain gap L1(lift(pred2d), lift(gt2d)) +
    lift L1(lift(gt2d), gt3d), plus, where the projections are given, the
    gap between the root-centred proj(pred3d) and proj(gt3d) and L1 of the
    root-centred proj(gt3d) and gt2d."""
    terms = {"loss_2d": l1(pred_2d, gt_2d), "loss_3d": l1(pred_3d, gt_3d),
             "loss_domain_gap": l1(lift_of_pred2d, lift_of_gt2d),
             "loss_lift": l1(lift_of_gt2d, gt_3d)}
    total = sum(terms.values())
    if proj_of_pred3d is not None:
        if proj_of_gt3d is None:
            raise ValueError("proj_of_pred3d needs proj_of_gt3d")
        pp, pg = _root_centre(proj_of_pred3d), _root_centre(proj_of_gt3d)
        terms["loss_gap_proj"] = l1(pp, pg)
        terms["loss_proj"] = l1(pg, _root_centre(gt_2d))
        total = total + terms["loss_gap_proj"] + terms["loss_proj"]
    return total, terms
