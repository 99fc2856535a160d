"""The SMPL-IK pose model, image -> volumetric 29-joint uvd, shape and
twists -> camera back-projection -> HybrIK -> mesh and joints: the port
of ``pose3d_tpu/models/smpl_pose.py`` (the reference
``Simple3DPoseBaseSMPL``, ``simple3dposeBaseSMPL.py:35-348``).

``PoseSMPLNet`` is the network half, with the reference's keys: a ResNet
(``preact``), the deconv head (``deconv_layers``), a 1x1 conv to 29 x 64
channels (``final_layer``), decoded by the plain ``soft_argmax_3d`` with
coordinates in [-0.5, 0.5] (``z_scale = xy_scale = 1``, :226-262; no
kernel serves it, as none serves it in the JAX package); and on the
backbone's pooled features fc1 (1024) -> dropout -> fc2 (1024) ->
dropout with no activation between the two layers (a reference quirk,
:272-275) -> ``decshape`` (10 betas, added to ``init_shape``) and
``decphi`` (23 x [cos, sin]). ``interop.weights.pose_smpl_net_from_flax``
writes its state dict. Its four outputs are f32 (float64 in a float64
net, where the JAX module casts them to f32: so a float64 run computes
the SMPL half in float64 too).

``uvd_to_cam`` (:146-184), ``flip_uvd_coord`` and ``flip_phi``
(:186-221) are the back-projection and the flip ensemble's pieces.
``HybrIKPose`` holds the net and the body (``models.smpl.SMPLTensors``,
non-persistent f32 buffers on the net's device) and runs the whole
forward; its SMPL half (back-projection, HybrIK, root-centring, the
quaternions) computes with autocast off, in f32 (or wider), under a bf16
net too, as the JAX module runs it in f32 on the net's f32 outputs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pose3d_tpu_torch.models import hybrik as ik
from pose3d_tpu_torch.models.heads import DeconvHead, init_image_model
from pose3d_tpu_torch.models.resnet import ResNet
from pose3d_tpu_torch.models.smpl import SMPLModel, SMPLTensors, _idx, rotmat_to_quat
from pose3d_tpu_torch.ops.heatmap import soft_argmax_3d

# left/right SMPL joint pairs (simple3dposeBaseSMPL.py:86-91)
JOINT_PAIRS_24 = ((1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17),
                  (18, 19), (20, 21), (22, 23))
JOINT_PAIRS_29 = JOINT_PAIRS_24 + ((25, 26), (27, 28))


def _pair_permutation(pairs, n):
    perm = list(range(n))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return np.asarray(perm)


_PERM_29 = _pair_permutation(JOINT_PAIRS_29, 29)
_PERM_23 = _pair_permutation(tuple((a - 1, b - 1) for a, b in JOINT_PAIRS_24), 23)


class PoseSMPLNet(nn.Module):
    """(B, H, W, 3) NHWC frames in [0, 1] -> {"uvd29" (B, 29, 3), "phis" (B,
    23, 2), "delta_shape" (B, 10), "pred_shape" (B, 10)}, all f32. The
    modules run ``channels_last``; BatchNorm stays f32
    (``models/norm.py``)."""

    def __init__(self, architecture: str = "resnet50", num_joints: int = 29, depth: int = 64,
                 init_shape=(0.0,) * 10, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.architecture = architecture
        self.num_joints = num_joints
        self.depth = depth
        self.preact = ResNet(architecture, **kw)
        self.deconv_layers = DeconvHead(self.preact.feature_channels, **kw)
        self.final_layer = nn.Conv2d(self.deconv_layers.out_channels, num_joints * depth, 1,
                                     **kw)
        self.fc1 = nn.Linear(self.preact.feature_channels, 1024, **kw)
        self.drop1 = nn.Dropout(0.5)
        self.fc2 = nn.Linear(1024, 1024, **kw)
        self.drop2 = nn.Dropout(0.5)
        self.decshape = nn.Linear(1024, 10, **kw)
        self.decphi = nn.Linear(1024, 23 * 2, **kw)
        # the h36m mean betas where known; f32 whatever the model's dtype
        self.register_buffer("init_shape", torch.tensor(init_shape, dtype=torch.float32,
                                                        device=device), persistent=False)
        self.to(memory_format=torch.channels_last)

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype: the compute dtype outside torch.autocast."""
        return self.final_layer.weight.dtype

    def _apply(self, fn, recurse=True):
        init_shape = self.init_shape
        super()._apply(fn, recurse)
        if torch.finfo(self.init_shape.dtype).bits < 32:  # never rounded
            self.init_shape = init_shape.to(self.init_shape.device, torch.float32)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw every parameter and BatchNorm statistic from ``generator`` (a
        CPU generator): the image model as ``heads.init_image_model``, the
        Linear weights N(0, 1 / fan_in) and biases N(0, 0.1); returns the
        module."""
        init_image_model(self, generator)
        for m in (self.fc1, self.fc2, self.decshape, self.decphi):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.in_features ** -0.5)
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
        return self

    def forward(self, x: torch.Tensor) -> dict:
        feats = self.preact(x.permute(0, 3, 1, 2))
        logits = self.final_layer(self.deconv_layers(feats))
        b, _, h, w = logits.shape
        # soft-argmax in [-0.5, 0.5] (simple3dposeBaseSMPL.py:257-259), in f32
        coords, _ = soft_argmax_3d(logits.reshape(b, self.num_joints, self.depth, h, w),
                                   self.num_joints, self.depth, h, w, z_scale=1.0,
                                   xy_scale=1.0, return_heatmap=False)
        # the shape and twist heads on the pooled backbone features (:266-279)
        xc = self.drop1(self.fc1(feats.mean(dim=(2, 3))))
        xc = self.drop2(self.fc2(xc))
        delta_shape = self.decshape(xc)
        acc = torch.promote_types(delta_shape.dtype, torch.float32)
        return {
            "uvd29": coords.reshape(b, self.num_joints, 3).to(acc),
            "phis": self.decphi(xc).reshape(b, 23, 2).to(acc),
            "delta_shape": delta_shape.to(acc),
            "pred_shape": delta_shape.to(acc) + self.init_shape.to(acc),
        }


def uvd_to_cam(uvd_jts, trans_inv, intrinsic_param, joint_root, depth_factor,
               heatmap_size: int = 64, return_relative: bool = True):
    """Back-project heatmap uvd to camera xyz (simple3dposeBaseSMPL.py:146-184).

    uvd_jts: (B, K, 3) in [-0.5, 0.5]; trans_inv: (B, 2, 3) the inverse bbox
    affine; intrinsic_param: (B, 3, 3) the inverse camera matrix;
    joint_root: (B, 3) the root in camera mm; depth_factor: (B, 1) (the bbox
    depth, typically 2.2 m in mm).
    """
    u = (uvd_jts[..., 0] + 0.5) * heatmap_size * 4  # input-pixel space
    v = (uvd_jts[..., 1] + 0.5) * heatmap_size * 4
    dz = uvd_jts[..., 2] * depth_factor  # (B, K)
    ones = torch.ones_like(u)
    uv_homo = torch.stack([u, v, ones], dim=-1)  # (B, K, 3)
    uv = torch.einsum("brc,bkc->bkr", trans_inv, uv_homo)  # (B, K, 2)
    cam_homo = torch.cat([uv, ones[..., None]], dim=-1)
    xyz = torch.einsum("brc,bkc->bkr", intrinsic_param, cam_homo)
    abs_z = dz + joint_root[:, 2:3]
    xyz = xyz * abs_z[..., None]
    if return_relative:
        xyz = xyz - joint_root[:, None, :]
    return xyz / depth_factor[..., None]


def _permute(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    """x[..., perm, :]."""
    return x.index_select(-2, _idx(perm, x.device))


def flip_uvd_coord(uvd, shift: bool = True, heatmap_size: int = 64):
    """Horizontal flip in heatmap-uvd space (simple3dposeBaseSMPL.py:186-210)."""
    x = -uvd[..., :1] if shift else (-1.0 / heatmap_size) - uvd[..., :1]
    return _permute(torch.cat([x, uvd[..., 1:]], dim=-1), _PERM_29)


def flip_phi(phis):
    """Flip twists: negate sin, swap left/right pairs (:212-221)."""
    return _permute(phis * phis.new_tensor([1.0, -1.0]), _PERM_23)


class HybrIKPose(nn.Module):
    """The net and the body: the whole ``Simple3DPoseBaseSMPL``. Train mode
    (``.train()``) runs the net in train mode and the naive IK path (the
    reference's dispatch); eval mode the accurate path with the SVD
    pelvis."""

    def __init__(self, net: PoseSMPLNet, smpl: SMPLModel):
        super().__init__()
        self.net = net
        self.smpl = SMPLTensors(smpl, device=net.final_layer.weight.device)

    def forward(self, x, trans_inv, intrinsic_param, joint_root, depth_factor, *,
                flip_test: bool = False) -> dict:
        """(B, H, W, 3) NHWC frames and the cameras -> the reference's
        ModelOutput fields as a dict. With ``flip_test`` the net also runs
        on the frames flipped along W, and the uvd, twists and shape are
        averaged with the flipped-back results (:281-306); the delta shape
        stays the unflipped pass's."""
        out = self.net(x)
        if flip_test:
            out_f = self.net(x.flip(2))
            out = {
                "uvd29": (out["uvd29"] + flip_uvd_coord(out_f["uvd29"], shift=True)) / 2,
                "phis": (out["phis"] + flip_phi(out_f["phis"])) / 2,
                "pred_shape": (out["pred_shape"] + out_f["pred_shape"]) / 2,
                "delta_shape": out["delta_shape"],
            }
        with torch.autocast(x.device.type, enabled=False):
            return self._smpl_half(out, trans_inv, intrinsic_param, joint_root, depth_factor)

    def _smpl_half(self, out, trans_inv, intrinsic_param, joint_root, depth_factor) -> dict:
        acc = out["uvd29"].dtype  # f32 or wider
        cam = [t.to(acc) for t in (trans_inv, intrinsic_param, joint_root, depth_factor)]
        xyz29 = uvd_to_cam(out["uvd29"], *cam, heatmap_size=self.net.depth)
        xyz29 = xyz29 - xyz29[:, :1]

        verts, joints24, rot_mats, j17 = ik.hybrik(self.smpl, out["pred_shape"], xyz29 * 2.0,
                                                   out["phis"], train=self.training)
        verts, joints24, j17 = ik.root_centre_outputs(verts, joints24, j17)
        b = xyz29.shape[0]
        return {
            "pred_uvd_jts": out["uvd29"].reshape(b, -1),
            "pred_phi": out["phis"],
            "pred_shape": out["pred_shape"],
            "pred_delta_shape": out["delta_shape"],
            "pred_xyz_jts_24": xyz29[:, :24].reshape(b, 72),
            "pred_xyz_jts_24_struct": (joints24 / 2).reshape(b, 72),
            "pred_xyz_jts_17": (j17 / 2).reshape(b, 51),
            "pred_vertices": verts,
            "pred_theta_quats": rotmat_to_quat(rot_mats).reshape(b, 24 * 4),
        }
