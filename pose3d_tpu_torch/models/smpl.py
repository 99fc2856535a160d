"""SMPL body model on torch tensors: the port of
``pose3d_tpu/models/smpl.py`` (the reference ``SMPL.py:38-219`` and
``lbs.py:195-288``).

The tables (``PARENTS``, ``LEAF_VERTEX_IDS``, ``IK_LEVELS``,
``FK_LEVELS``, ``children_map`` with the reference's overrides
``children[0] = 3`` and ``children[9] = 12``), ``SMPLModel`` (a frozen
dataclass of numpy arrays), ``load_smpl`` and ``synthetic_model`` are
copies of the JAX module's: the same arrays from the same seed.

The math takes torch tensors and computes in their dtype:
``joints2bones`` / ``bones2joints``, ``batch_rodrigues``,
``quat_to_rotmat`` / ``rotmat_to_quat`` (the branch-free four-case pick,
the first maximum on ties), ``blend_shapes``, ``vertices2joints``,
``batch_rigid_transform`` (forward kinematics batched by tree level: one
(B, K, 3, 3) product a depth) and ``skin``, and ``lbs``, the whole
forward. Each keeps the JAX function's epsilons and expression order.

``lbs`` and ``models.hybrik.hybrik`` read the body's arrays from
``model``: an ``SMPLModel`` (numpy, copied to the inputs' device and dtype
on every call) or an ``SMPLTensors`` module, which holds them once as
buffers on a device (``HybrIKPose`` keeps one).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from pose3d_tpu_torch.core import quaternion
from pose3d_tpu_torch.models.norm import keep_f32

NUM_JOINTS = 24
NUM_EXT_JOINTS = 29  # + 5 leaf vertices (SMPL.py:127-137)
NUM_BETAS = 10

# The standard SMPL kinematic tree, extended with the HybrIK leaf joints
# (SMPL.py:127-137): parents[24] = 15, [25] = 22, [26] = 23, [27] = 10,
# [28] = 11.
PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21, 15, 22, 23, 10, 11],
    dtype=np.int32,
)

# Leaf vertex ids on the 6890-vertex SMPL mesh (lbs.py:352)
LEAF_VERTEX_IDS = (411, 2445, 5905, 3216, 6617)

# Depth levels of the extended tree (the parents of a level's joints all
# sit in earlier levels), the reference's train-path schedule
# (lbs.py:884-895).
IK_LEVELS = (
    (0,), (1, 2, 3), (4, 5, 6), (7, 8, 9), (12, 13, 14), (15, 16, 17),
    (18, 19, 10), (20, 21, 11), (22, 23), (24, 25, 26, 27, 28),
)
# FK levels over the 24 real joints, grouped by tree depth.
FK_LEVELS = (
    (1, 2, 3), (4, 5, 6), (7, 8, 9), (10, 11, 12, 13, 14), (15, 16, 17),
    (18, 19), (20, 21), (22, 23),
)

# the body's arrays, in the order SMPLModel and SMPLTensors list them
ARRAYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "j_regressor_h36m",
          "lbs_weights")


def children_map(parents: np.ndarray = PARENTS) -> np.ndarray:
    """First-child table with the reference's overrides (SMPL.py:149-162):
    leaves -1; children[0] = 3 (spine1 drives the pelvis orientation);
    children[9] = 12 (the neck; the reference's -3 three-children marker
    is overwritten at once, which disables that branch)."""
    children = -np.ones_like(parents)
    for i in range(len(parents)):
        p = parents[i]
        if p >= 0 and children[p] < 0:
            children[p] = i
    for leaf in range(24, len(parents)):
        children[leaf] = -1
    children[0] = 3
    children[9] = 12
    return children


CHILDREN = children_map()


@dataclasses.dataclass(frozen=True)
class SMPLModel:
    """The body's arrays (numpy), immutable."""

    v_template: np.ndarray        # (V, 3)
    shapedirs: np.ndarray         # (V, 3, 10)
    posedirs: np.ndarray          # (23*9, V*3)
    j_regressor: np.ndarray       # (24, V)
    j_regressor_h36m: np.ndarray  # (17, V)
    lbs_weights: np.ndarray       # (V, 24)
    parents: np.ndarray = dataclasses.field(default_factory=lambda: PARENTS)
    children: np.ndarray = dataclasses.field(default_factory=lambda: CHILDREN)
    leaf_vertex_ids: tuple = LEAF_VERTEX_IDS

    @property
    def num_vertices(self):
        return self.v_template.shape[0]


def load_smpl(pkl_path, h36m_regressor_path) -> SMPLModel:
    """The SMPL pickle and the Human3.6M regressor npy
    (simple3dposeBaseSMPL.py:79-97): a scipy-sparse ``J_regressor`` is
    densified, posedirs (V, 3, 207) become (207, V*3), every array f32."""
    import pickle

    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def to_np(x):
        if "scipy.sparse" in str(type(x)):
            x = x.todense()
        return np.asarray(x, dtype=np.float32)

    posedirs = to_np(data["posedirs"])  # (V, 3, 207)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # (207, V*3)
    return SMPLModel(
        v_template=to_np(data["v_template"]),
        shapedirs=to_np(data["shapedirs"])[..., :NUM_BETAS],
        posedirs=posedirs,
        j_regressor=to_np(data["J_regressor"]),
        j_regressor_h36m=np.load(h36m_regressor_path).astype(np.float32),
        lbs_weights=to_np(data["weights"]),
    )


def synthetic_model(n_vertices: int = 800, seed: int = 0) -> SMPLModel:
    """A small self-consistent body for tests: joints regress from
    clusters of vertices, and the skinning weights follow the clusters.
    The JAX package's draws, in its order, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    # 24 joint centres of rough human proportions, in metres
    joints = np.zeros((NUM_JOINTS, 3), np.float32)
    for i in range(1, NUM_JOINTS):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        joints[i] = joints[PARENTS[i]] + direction * rng.uniform(0.08, 0.3)
    # vertices scattered around the joints
    owner = rng.integers(0, NUM_JOINTS, n_vertices)
    v_template = joints[owner] + rng.normal(scale=0.04, size=(n_vertices, 3))
    v_template = v_template.astype(np.float32)
    # the regressor: the mean of each joint's own cluster
    j_reg = np.zeros((NUM_JOINTS, n_vertices), np.float32)
    for j in range(NUM_JOINTS):
        mask = owner == j
        if not mask.any():  # at least one vertex a joint
            k = rng.integers(0, n_vertices)
            owner[k] = j
            v_template[k] = joints[j]
            mask = owner == j
        j_reg[j, mask] = 1.0 / mask.sum()
    # move the template so that the regressor gives the joints exactly
    v_template += (joints - j_reg @ v_template)[owner]
    # the Human3.6M regressor: 17 random convex combinations
    h36m = rng.random((17, n_vertices)).astype(np.float32)
    h36m /= h36m.sum(1, keepdims=True)
    w = np.zeros((n_vertices, NUM_JOINTS), np.float32)
    w[np.arange(n_vertices), owner] = 1.0
    leaf_ids = tuple(int(i) for i in rng.integers(0, n_vertices, 5))
    return SMPLModel(
        v_template=v_template,
        shapedirs=rng.normal(scale=0.01, size=(n_vertices, 3, NUM_BETAS)).astype(np.float32),
        posedirs=rng.normal(scale=0.001, size=(23 * 9, n_vertices * 3)).astype(np.float32),
        j_regressor=j_reg,
        j_regressor_h36m=h36m,
        lbs_weights=w,
        leaf_vertex_ids=leaf_ids,
    )


class SMPLTensors(nn.Module):
    """A body's arrays as non-persistent buffers on ``device`` (f32), with
    its tree (``parents``, ``child_ids``: ``SMPLModel.children``, a name
    ``nn.Module`` has taken; ``leaf_vertex_ids``) as attributes: what
    ``lbs`` and ``hybrik`` read. A cast of the module
    (``.to(torch.bfloat16)``, ``.half()``) leaves the buffers f32, as the
    body's math stays f32 in a bf16 model; ``.double()`` widens them."""

    def __init__(self, model: SMPLModel, *, device):
        super().__init__()
        for name in ARRAYS:
            self.register_buffer(name, torch.as_tensor(
                np.asarray(getattr(model, name)), dtype=torch.float32, device=device),
                persistent=False)
        self.parents = np.asarray(model.parents)
        self.child_ids = np.asarray(model.children)
        self.leaf_vertex_ids = tuple(model.leaf_vertex_ids)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def _apply(self, fn, recurse=True):
        return super()._apply(keep_f32(fn), recurse)


def kinematic_tree(model) -> tuple[np.ndarray, np.ndarray]:
    """(parents, children) of an ``SMPLModel`` or ``SMPLTensors``."""
    if isinstance(model, SMPLTensors):
        return model.parents, model.child_ids
    return np.asarray(model.parents), np.asarray(model.children)


def body_arrays(model, like: torch.Tensor) -> dict[str, torch.Tensor]:
    """The body's arrays on ``like``'s device in its dtype (no copy where
    they are there already)."""
    return {name: torch.as_tensor(getattr(model, name), dtype=like.dtype, device=like.device)
            for name in ARRAYS}


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


@functools.lru_cache(maxsize=None)
def _table(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _idx(values, device, dtype=torch.long) -> torch.Tensor:
    """A tree table (indices or a mask) as a tensor on ``device``, made
    once a device: indexing with a host array would copy it every call."""
    return _table(tuple(np.asarray(values).reshape(-1).tolist()), dtype, torch.device(device))


def _set(x: torch.Tensor, idx, value: torch.Tensor) -> torch.Tensor:
    """``x.at[:, idx].set(value)``: a copy of x with x[:, idx] = value."""
    return x.index_copy(1, _idx(idx, x.device), value)


def _take(x: torch.Tensor, idx) -> torch.Tensor:
    """x[:, idx]."""
    return x.index_select(1, _idx(idx, x.device))


def _where_parent(parents: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """x[:, parents] where a joint has a parent, 0 at the root."""
    has_parent = _idx(parents >= 0, x.device, torch.bool)[None, :, None]
    return torch.where(has_parent, _take(x, parents.clip(0)), x.new_zeros(()))


# --- the math ----------------------------------------------------------------

def joints2bones(joints: torch.Tensor, parents=PARENTS[:24]):
    """(B, J, 3) joints -> (unit bone directions, lengths) (lbs.py:143-170):
    the root entry carries its absolute position and length 0."""
    parents = np.asarray(parents)
    diff = joints - _take(joints, parents.clip(0))
    length = torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-8
    is_root = _idx(parents < 0, joints.device, torch.bool)[None, :, None]
    dirs = torch.where(is_root, joints, diff / length)
    lens = torch.where(is_root, torch.zeros_like(length), length)
    return dirs, lens


def bones2joints(bone_dirs: torch.Tensor, bone_lens: torch.Tensor, parents=PARENTS[:24],
                 levels=FK_LEVELS) -> torch.Tensor:
    """Joints from bone directions and lengths (lbs.py:173-192),
    accumulated level by level over the tree."""
    parents = np.asarray(parents)
    b = bone_lens.shape[0]
    joints = bone_dirs.new_zeros((b,) + bone_dirs.shape[-2:])
    joints = _set(joints, [0], bone_dirs[:, :1].expand(b, 1, 3))
    for idx in levels:
        idx = list(idx)
        joints = _set(joints, idx, _take(joints, parents[idx])
                      + _take(bone_dirs, idx) * _take(bone_lens, idx))
    return joints


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotations (lbs.py:446-477), the
    +1e-8 added to the vector before its norm."""
    angle = torch.linalg.vector_norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    k = _skew(axis)
    return _eye(rot_vecs) + sin * k + (1.0 - cos) * (k @ k)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        v.shape[:-1] + (3, 3))


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions -> (..., 3, 3), normalised first
    (lbs.py:1204-1236)."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True).clamp(min=1e-8)
    return quaternion.quat_to_rotmat(q)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) wxyz unit quaternions: the four cases of
    lbs.py:1122-1201 all computed, the one of the largest component kept
    (the first on ties), its sign made that of w + 1e-12."""
    m = rot
    t = m.diagonal(dim1=-2, dim2=-1).sum(-1)
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    qw = safe_sqrt(1 + t) / 2
    qx = safe_sqrt(1 + m00 - m11 - m22) / 2
    qy = safe_sqrt(1 - m00 + m11 - m22) / 2
    qz = safe_sqrt(1 - m00 - m11 + m22) / 2
    cands = torch.stack([
        torch.stack([qw,
                     (m[..., 2, 1] - m[..., 1, 2]) / (4 * qw),
                     (m[..., 0, 2] - m[..., 2, 0]) / (4 * qw),
                     (m[..., 1, 0] - m[..., 0, 1]) / (4 * qw)], -1),
        torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / (4 * qx), qx,
                     (m[..., 0, 1] + m[..., 1, 0]) / (4 * qx),
                     (m[..., 0, 2] + m[..., 2, 0]) / (4 * qx)], -1),
        torch.stack([(m[..., 0, 2] - m[..., 2, 0]) / (4 * qy),
                     (m[..., 0, 1] + m[..., 1, 0]) / (4 * qy), qy,
                     (m[..., 1, 2] + m[..., 2, 1]) / (4 * qy)], -1),
        torch.stack([(m[..., 1, 0] - m[..., 0, 1]) / (4 * qz),
                     (m[..., 0, 2] + m[..., 2, 0]) / (4 * qz),
                     (m[..., 1, 2] + m[..., 2, 1]) / (4 * qz), qz], -1),
    ], dim=-2)  # (..., 4 cases, 4)
    comp = torch.stack([qw, qx, qy, qz], -1)
    # argmax of the first maximum, as jnp.argmax (torch's may take another)
    best = (comp == comp.amax(-1, keepdim=True)).int().argmax(-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return q * torch.sign(q[..., :1] + 1e-12)


def blend_shapes(betas: torch.Tensor, shapedirs: torch.Tensor) -> torch.Tensor:
    """(B, 10) x (V, 3, 10) -> (B, V, 3) (lbs.py:422-443)."""
    return torch.einsum("bl,vkl->bvk", betas, shapedirs)


def vertices2joints(regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3) (lbs.py:402-419)."""
    return torch.einsum("jv,bvk->bjk", regressor, vertices)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents=PARENTS[:24],
                          levels=FK_LEVELS):
    """Forward kinematics, local rotations and rest joints -> (posed joints
    (B, J, 3), relative transforms (B, J, 4, 4) [R | t - R j_rest])
    (lbs.py:493-548), one (B, K, 3, 3) product a tree level."""
    b, j = joints.shape[:2]
    parents = np.asarray(parents)
    rel = joints - _where_parent(parents, joints)
    chain = _set(joints.new_zeros((b, j, 3, 3)), [0], rot_mats[:, :1])
    pos = _set(joints.new_zeros((b, j, 3)), [0], joints[:, :1])
    for idx in levels:
        idx = list(idx)
        p = parents[idx]
        chain_p = _take(chain, p)
        new_chain = chain_p @ _take(rot_mats, idx)
        new_pos = _take(pos, p) + (chain_p @ _take(rel, idx)[..., None])[..., 0]
        chain = _set(chain, idx, new_chain)
        pos = _set(pos, idx, new_pos)
    t = pos - (chain @ joints[..., None])[..., 0]
    top = torch.cat([chain, t[..., None]], dim=-1)                     # (B, J, 3, 4)
    bottom = joints.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(b, j, 1, 4)
    return pos, torch.cat([top, bottom], dim=-2)


def skin(v_posed: torch.Tensor, rel_transforms: torch.Tensor,
         lbs_weights: torch.Tensor) -> torch.Tensor:
    """Linear blend skinning: (B, V, 3), (B, J, 4, 4), (V, J) -> (B, V, 3)
    (lbs.py:272-285)."""
    t = torch.einsum("vj,bjrc->bvrc", lbs_weights, rel_transforms)
    v = t[..., :3, :3] @ v_posed[..., None] + t[..., :3, 3:]
    return v[..., 0]


def pose_offsets(rot_mats: torch.Tensor, posedirs: torch.Tensor) -> torch.Tensor:
    """The pose blend shapes: (B, 24, 3, 3) rotations -> (B, V, 3) offsets,
    (R[1:] - I) flattened times posedirs."""
    b = rot_mats.shape[0]
    pose_feature = (rot_mats[:, 1:] - _eye(rot_mats)).reshape(b, -1)
    return (pose_feature @ posedirs).reshape(b, -1, 3)


def lbs(model, betas: torch.Tensor, pose: torch.Tensor, pose2rot: bool = True):
    """The whole forward (lbs.py:195-288): (vertices, joints_24, rot_mats,
    joints_h36m), not root-centred (the SMPL_layer wrapper does that,
    SMPL.py:211-215). ``model``: an ``SMPLModel`` or ``SMPLTensors``;
    ``pose``: (B, 72) axis-angle or, without ``pose2rot``, (B, 24, 3, 3)."""
    arr = body_arrays(model, betas)
    b = betas.shape[0]
    v_shaped = arr["v_template"] + blend_shapes(betas, arr["shapedirs"])
    j_rest = vertices2joints(arr["j_regressor"], v_shaped)
    if pose2rot:
        rot_mats = batch_rodrigues(pose.reshape(b, NUM_JOINTS, 3))
    else:
        rot_mats = pose.reshape(b, NUM_JOINTS, 3, 3)
    v_posed = v_shaped + pose_offsets(rot_mats, arr["posedirs"])
    joints, rel_tf = batch_rigid_transform(rot_mats, j_rest)
    verts = skin(v_posed, rel_tf, arr["lbs_weights"])
    joints_h36m = vertices2joints(arr["j_regressor_h36m"], verts)
    return verts, joints, rot_mats, joints_h36m
