"""HybrIK inverse kinematics, joint positions and twists -> rotations: the
port of ``pose3d_tpu/models/hybrik.py`` (the reference ``lbs.py:291-399``
``hybrik``, the eval path :551-756 with its 15 mm outlier clamp, the
naive train path :759-934, the pelvis orientations :937-1049 and the
three-children SVD :1052-1088).

The IK loops over the extended tree's 10 static depth levels; every joint
of a level is one batched (B, K, ...) computation, on both paths, as in
the JAX module. The eval path's clamp is a ``torch.where``; the SVD
orientations use ``torch.linalg.svd`` with the determinant fix (the
rotation, not U or V, is what compares across libraries: singular
vectors may come back with other signs). ``.detach()`` stands where the
JAX module has ``stop_gradient`` (the reference's ``.detach()``).

Swing-twist per joint (lbs.py:705-751): the swing is the Rodrigues
rotation taking the rest bone onto the observed one, the twist a rotation
by phi about the rest bone; local = swing @ twist.
"""

from __future__ import annotations

import numpy as np
import torch

from pose3d_tpu_torch.models.smpl import (CHILDREN, IK_LEVELS, PARENTS, _eye, _set, _skew,
                                          _take, _where_parent, batch_rigid_transform,
                                          blend_shapes, body_arrays, kinematic_tree,
                                          pose_offsets, skin, vertices2joints)


# the eval path's outlier threshold (lbs.py:689-698): 15 mm, in metres
CLAMP_M = 15.0 / 1000.0


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _rodrigues_from_axis(axis_unit, cos, sin):
    """R = I + sin K + (1 - cos) K^2 with K = skew(axis). axis (..., 3);
    cos and sin (..., 1)."""
    k = _skew(axis_unit)
    return _eye(axis_unit) + sin[..., None] * k + (1.0 - cos[..., None]) * (k @ k)


def rotmat_between(vec_rest, vec_final):
    """The rotation taking vec_rest onto vec_final, the reference's
    formulation with its epsilons (``vectors2rotmat``,
    lbs.py:1090-1119). Inputs (..., 3)."""
    rest_norm = _norm(vec_rest)
    final_norm = _norm(vec_final)
    axis = torch.linalg.cross(vec_rest, vec_final, dim=-1)
    axis_norm = _norm(axis)
    cos = (vec_rest * vec_final).sum(-1, keepdim=True) / (rest_norm * final_norm + 1e-8)
    sin = axis_norm / (rest_norm * final_norm + 1e-8)
    axis = axis / (axis_norm + 1e-8)
    return _rodrigues_from_axis(axis, cos, sin)


def _kabsch(rest_mat, target_mat):
    """Orthogonal Procrustes with the determinant fix (lbs.py:958-971): S
    = rest @ target^T; R = V diag(1, 1, det(V U^T)) U^T; an all-zero S
    gives the identity (lbs.py:954-956). Inputs (..., 3, K)."""
    s = rest_mat @ target_mat.transpose(-1, -2)
    u, _, vt = torch.linalg.svd(s)
    v = vt.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    fix = torch.diag_embed(torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1))
    rot = v @ fix @ u.transpose(-1, -2)
    zero = s.abs().sum(dim=(-1, -2), keepdim=True) == 0
    return torch.where(zero, _eye(s), rot)


def _pelvis_children(parents=PARENTS, children=CHILDREN) -> list[int]:
    out = [int(children[0])]
    for i in range(1, len(parents)):
        if parents[i] == 0 and i not in out:
            out.append(i)
    return out  # [3, 1, 2]


def pelvis_orient_svd(rel_pose, rel_rest):
    """The eval path's pelvis orientation: Kabsch over the pelvis' three
    child bones (lbs.py:937-976). rel_*: (B, 29, 3)."""
    idx = _pelvis_children()
    rest_mat = torch.stack([rel_rest[:, c] for c in idx], dim=-1)  # (B, 3, K)
    target_mat = torch.stack([rel_pose[:, c] for c in idx], dim=-1)
    return _kabsch(rest_mat, target_mat)


def pelvis_orient_naive(rel_pose, rel_rest):
    """The train path's pelvis orientation (lbs.py:979-1049): align the
    spine bone, then turn about the spine axis to align the hips' midpoint
    direction (projected perpendicular to the spine)."""
    spine = int(CHILDREN[0])
    others = [c for c in _pelvis_children() if c != spine]
    spine_final = rel_pose[:, spine]
    spine_rest = rel_rest[:, spine]
    spine_axis = spine_final / (_norm(spine_final) + 1e-8)
    rot_spine = rotmat_between(spine_rest, spine_final)

    center_final = sum(rel_pose[:, c] for c in others) / len(others)
    center_rest = sum(rel_rest[:, c] for c in others) / len(others)
    center_rest = (rot_spine @ center_rest[..., None])[..., 0]

    def project_out(v):
        return v - (v * spine_axis).sum(-1, keepdim=True) * spine_axis

    center_final, center_rest = project_out(center_final), project_out(center_rest)
    rot_center = rotmat_between(center_rest, center_final)
    return rot_center @ rot_spine


def three_children_orient_svd(children_final, children_rest, chain_parent):
    """SVD orientation over several child bones (lbs.py:1052-1088). Kept for
    completeness: the reference's children-map override disables the
    branch that calls it."""
    target = torch.stack([(chain_parent.transpose(-1, -2) @ c[..., None])[..., 0]
                          for c in children_final], dim=-1)
    rest = torch.stack(children_rest, dim=-1)
    return _kabsch(rest, target)


def inverse_kinematics(pose_skeleton, phis, rest_pose, *, train: bool = False,
                       global_orient=None, leaf_thetas=None, parents=PARENTS,
                       children=CHILDREN, levels=IK_LEVELS):
    """Joint positions -> local rotations.

    pose_skeleton: (B, 29, 3) predicted joints (camera frame; root-relative
    or not); phis: (B, 23, 2) twist (cos, sin) of each non-root body
    joint; rest_pose: (B, 29, 3) rest joints (24 regressed + 5 leaf
    vertices); leaf_thetas: optional (B, 5, 3, 3) leaf rotations. Returns
    (rot_mats (B, 24, 3, 3), rotate_rest_pose (B, 29, 3)).
    """
    b = pose_skeleton.shape[0]
    parents = np.asarray(parents)
    children = np.asarray(children)

    rel_rest = rest_pose - _where_parent(parents, rest_pose)
    rel_pose = pose_skeleton - _where_parent(parents, pose_skeleton)
    rel_pose = _set(rel_pose, [0], rel_rest[:, :1]).detach()  # lbs.py:597
    final_pose = pose_skeleton - pose_skeleton[:, :1] + rel_rest[:, :1]

    phis = phis / (_norm(phis) + 1e-8)

    if global_orient is not None:
        root_rot = global_orient
    elif train:
        root_rot = pelvis_orient_naive(rel_pose, rel_rest)
    else:
        root_rot = pelvis_orient_svd(rel_pose, rel_rest)

    n = len(parents)
    chain = _set(pose_skeleton.new_zeros((b, n, 3, 3)), [0], root_rot[:, None])
    local = _set(pose_skeleton.new_zeros((b, 24, 3, 3)), [0], root_rot[:, None])
    rot_rest = _set(pose_skeleton.new_zeros((b, n, 3)), [0], rel_rest[:, :1])

    for level in levels[1:]:
        leaves = [i for i in level if children[i] == -1]
        body = [i for i in level if children[i] != -1]
        if body:
            idx = np.asarray(body)
            p = parents[idx]
            c = children[idx]
            chain_p = _take(chain, p)
            # the joint's global position after the chain so far
            new_pos = _take(rot_rest, p) + (chain_p @ _take(rel_rest, idx)[..., None])[..., 0]
            rot_rest = _set(rot_rest, idx, new_pos)

            if train:
                # naive: the observed local bone (lbs.py:917-920)
                child_final = _take(rel_pose, c)
            else:
                # accurate: aim at the child's final global position
                child_final = _take(final_pose, c) - new_pos
                # the outlier clamp (lbs.py:689-698): where the corrected
                # target lies more than 15 mm from the observed bone,
                # rescaled to the rest length, take the observed bone
                orig = _take(rel_pose, c)
                t_norm = _norm(_take(rel_rest, c))
                orig = orig * t_norm / _norm(orig)
                diff = _norm(child_final - orig)
                child_final = torch.where(diff > CLAMP_M, orig, child_final)
            # into the parent's frame
            child_final = (chain_p.transpose(-1, -2) @ child_final[..., None])[..., 0]
            child_rest = _take(rel_rest, c)

            swing = rotmat_between(child_rest, child_final)
            twist_axis = child_rest / (_norm(child_rest) + 1e-8)
            phi = _take(phis, idx - 1)
            twist = _rodrigues_from_axis(twist_axis, phi[..., 0:1], phi[..., 1:2])
            rot = swing @ twist
            chain = _set(chain, idx, chain_p @ rot)
            local = _set(local, idx, rot)
        if leaves:
            idx = np.asarray(leaves)
            p = parents[idx]
            chain_p = _take(chain, p)
            new_pos = _take(rot_rest, p) + (chain_p @ _take(rel_rest, idx)[..., None])[..., 0]
            rot_rest = _set(rot_rest, idx, new_pos)
            if leaf_thetas is not None:
                # the JAX module's order: leaf_thetas[k] is the k-th of the
                # level's leaves sorted, taken in the level's order
                order = {j: k for k, j in enumerate(sorted(leaves))}
                rot = torch.stack([leaf_thetas[:, order[j]] for j in idx], 1)
                chain = _set(chain, idx, chain_p @ rot)
    return local, rot_rest


def hybrik(model, betas, pose_skeleton, phis, *, global_orient=None, leaf_thetas=None,
           train: bool = False, naive: bool | None = None):
    """The whole HybrIK pass (lbs.py:291-399): betas, the predicted skeleton
    and the twists -> (vertices, joints_24, rot_mats, joints_h36m), not
    root-centred. ``model``: an ``SMPLModel`` or ``SMPLTensors``.
    ``naive`` overrides the choice of IK path (the reference's dispatch,
    lbs.py:356-365: train -> naive, eval -> accurate with the SVD
    pelvis)."""
    arr = body_arrays(model, betas)
    parents, children = kinematic_tree(model)
    naive = train if naive is None else naive

    v_shaped = arr["v_template"] + blend_shapes(betas, arr["shapedirs"])
    rest_24 = vertices2joints(arr["j_regressor"], v_shaped)
    leaf = _take(v_shaped, list(model.leaf_vertex_ids))
    rest_j = torch.cat([rest_24, leaf], dim=1)  # (B, 29, 3)

    rot_mats, _ = inverse_kinematics(pose_skeleton, phis, rest_j, train=naive,
                                     global_orient=global_orient, leaf_thetas=leaf_thetas,
                                     parents=parents, children=children)
    joints, rel_tf = batch_rigid_transform(rot_mats, rest_24)
    v_posed = v_shaped + pose_offsets(rot_mats, arr["posedirs"])
    verts = skin(v_posed, rel_tf, arr["lbs_weights"])
    joints_h36m = vertices2joints(arr["j_regressor_h36m"], verts)
    return verts, joints, rot_mats, joints_h36m


def root_centre_outputs(verts, joints, joints_h36m, root_idx_17: int = 0):
    """The SMPL_layer wrapper's root-centring (SMPL.py:211-215, :266-273),
    the subtracted roots detached."""
    root = joints_h36m[:, root_idx_17:root_idx_17 + 1].detach()
    return verts - root, joints - joints[:, :1].detach(), joints_h36m - root
