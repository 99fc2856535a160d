"""Direct image -> 3D regression: the port of ``DeconvHead`` and
``PoseNet3D`` of ``pose3d_tpu/models/heads.py`` (the reference
``Model_3D``).

(B, H, W, 3) NHWC frames in [0, 1] -> a ResNet (``preact``) -> three
(ConvTranspose2d(4, 2, 1, no bias) -> BatchNorm -> ReLU) that upsample the
stride-32 map 8x (``deconv_layers``, slots 0/3/6 and 1/4/7) -> a 1x1
conv to J*D channels (``final_layer``) -> a softmax over each joint's D x
H x W volume -> its expected x, y, z: (B, J*3) coordinates, x and y in
[-1, 1], z in [-z_scale/2, z_scale/2]. The module names are those of the
reference ``Model_3D`` state dict (``interop.weights.posenet3d_from_flax``
writes one). The modules run ``channels_last``, the layout of the JAX
package's NHWC convolutions, so the (B, J*D, H, W) logits are (B, H, W,
J*D) in memory, the layout the decode kernels read, without a transpose.

Three decodes, as in the JAX module:

- ``return_heatmap=True`` (the default): the plain ``soft_argmax_3d`` on
  the (B, J, D, H, W) volume; returns the coordinates and the normalised
  heatmap.
- ``return_heatmap=False``: straight off the NHWC logits, through the
  kernel wrapper ``ops.softargmax.soft_argmax_3d_nhwc_kernel`` when
  ``use_kernels`` (JAX's ``use_pallas``) and, in training, only under
  ``use_kernels_train`` (JAX's ``use_pallas_train``, default off); else
  through the plain ``heatmap.soft_argmax_3d_nhwc``.
- ``fuse_final_conv=True`` with ``return_heatmap=False``: the 1x1 conv
  fused into the decode, ``ops.conv_decode.conv_soft_argmax_3d_fused``,
  in training and in eval; the logits never exist. The kernel takes bf16:
  where the compute dtype (the features' dtype: the model's, or bf16
  under ``torch.autocast``) is another, the route takes the plain
  ``conv_soft_argmax_3d_reference`` (the one plain route on a card, as
  ``LifterService`` gates its kernels on bf16).

Every route is differentiable; the kernel routes through the decode
kernels' backwards. An f32 model under ``torch.autocast(device,
torch.bfloat16)`` computes as the flax model with f32 parameters and a
bf16 ``dtype`` does: each convolution casts its weight to bf16, the
BatchNorms stay f32 (``models/norm.py``), and the fused route casts the
final conv's weight and bias to bf16 for the decode, so that their
gradients pass through one bf16 rounding.

``PoseNet2D`` (the reference ``Model_2D``, ``phase5_loop/Model_2d.py:
13-138``) is the same network with J output channels, one heatmap a
joint, decoded by the plain ``soft_argmax_2d`` as in the JAX package: (B,
J*2) coordinates in [0, 1).

``ProjectionMLP`` (the reference ``Projection``, ``Model_2d.py:140-170``)
is the learned 3D -> 2D projection: Flatten, three (Linear, BatchNorm,
Tanh, Dropout(0.3)) at widths 512, 256 and 128, a Linear to ``out_dim``;
the reference's ``mlp.{1,2,5,6,9,10,13}`` keys
(``interop.weights.projection_mlp_from_flax`` writes them). The
consistency loop's projector is a ViT (``JointTransformerLifter(in_dim=3,
out_dim=2)``); this MLP is kept for the API, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch.models.norm import F32BatchNorm1d, F32BatchNorm2d, seed_batch_norm
from pose3d_tpu_torch.models.resnet import ResNet
from pose3d_tpu_torch.ops import conv_decode, softargmax
from pose3d_tpu_torch.ops.heatmap import soft_argmax_2d, soft_argmax_3d, soft_argmax_3d_nhwc


class DeconvHead(nn.Sequential):
    """The deconv stack (the reference's ``deconv_layers``): per width in
    ``filters``, ConvTranspose2d(4, 2, 1, no bias) -> BatchNorm -> ReLU,
    each doubling H and W. The JAX ``DeconvHead`` also holds the 1x1
    projection; here it is ``PoseNet3D.final_layer``, where ``Model_3D``
    keeps it."""

    def __init__(self, in_channels: int, filters=(256, 256, 256), *, device,
                 dtype=torch.float32):
        layers = []
        for f in filters:
            layers += [nn.ConvTranspose2d(in_channels, f, 4, 2, padding=1, bias=False,
                                          device=device, dtype=dtype),
                       F32BatchNorm2d(f, device=device), nn.ReLU()]
            in_channels = f
        super().__init__(*layers)
        self.out_channels = in_channels


@torch.no_grad()
def init_image_model(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter and BatchNorm statistic of ``model`` from
    ``generator`` (a CPU generator): convolution weights N(0, 1 / fan_in) (a
    transposed conv's fan-in: in x kH x kW / stride^2), conv biases N(0,
    0.1), BatchNorms as ``norm.seed_batch_norm``; returns ``model``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.randn(m.weight.shape, generator=generator)
            kh, kw = m.kernel_size
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.in_channels * kh * kw / (m.stride[0] * m.stride[1])
            else:
                fan_in = m.in_channels * kh * kw
            m.weight.copy_(w * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
        elif isinstance(m, nn.BatchNorm2d):
            seed_batch_norm(m, generator)
    return model


class PoseNet3D(nn.Module):
    """(B, H, W, 3) NHWC frames -> ((B, J*3) f32 coordinates, the (B, J, D,
    H/4, W/4) f32 heatmap or None). The defaults are the served
    configuration: ResNet-50, 17 joints, a 64-deep volume, z_scale 2.5
    (the phase-4 variant uses 2.0)."""

    def __init__(self, architecture: str = "resnet50", num_joints: int = 17,
                 depth: int = 64, z_scale: float = 2.5, return_heatmap: bool = True,
                 use_kernels: bool = True, fuse_final_conv: bool = False,
                 use_kernels_train: bool = False, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.architecture = architecture
        self.num_joints = num_joints
        self.depth = depth
        self.z_scale = z_scale
        self.return_heatmap = return_heatmap
        self.use_kernels = use_kernels
        self.use_kernels_train = use_kernels_train
        self.fuse_final_conv = fuse_final_conv
        self.preact = ResNet(architecture, **kw)
        self.deconv_layers = DeconvHead(self.preact.feature_channels, **kw)
        self.final_layer = nn.Conv2d(self.deconv_layers.out_channels, num_joints * depth, 1,
                                     **kw)
        self.to(memory_format=torch.channels_last)

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype: the compute dtype outside torch.autocast."""
        return self.final_layer.weight.dtype

    def init_weights(self, generator: torch.Generator):
        """Draw every parameter and BatchNorm statistic from ``generator``
        (``init_image_model``)."""
        return init_image_model(self, generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC frames -> the deconv head's (B, 256, H/4, W/4)
        output, channels_last: what the final conv (or the fused decode)
        reads."""
        return self.deconv_layers(self.preact(x.permute(0, 3, 1, 2)))

    def decode(self, feats: torch.Tensor):
        """The deconv head's output -> (coordinates, heatmap or None), by the
        route the module's flags choose (see the module docstring)."""
        j, d = self.num_joints, self.depth
        if self.fuse_final_conv and not self.return_heatmap:
            nhwc = feats.permute(0, 2, 3, 1)
            weight = self.final_layer.weight.view(j * d, -1)
            bias = self.final_layer.bias
            if feats.dtype == torch.bfloat16:  # the compute dtype
                return conv_decode.conv_soft_argmax_3d_fused(
                    nhwc, weight.to(torch.bfloat16), bias.to(torch.bfloat16).float(), j, d,
                    z_scale=self.z_scale), None
            return conv_decode.conv_soft_argmax_3d_reference(
                nhwc, weight, bias, j, d, z_scale=self.z_scale), None
        logits = self.final_layer(feats)
        b, _, h, w = logits.shape
        if not self.return_heatmap:
            nhwc = logits.permute(0, 2, 3, 1)
            if self.use_kernels and (not self.training or self.use_kernels_train):
                return softargmax.soft_argmax_3d_nhwc_kernel(nhwc, j, d,
                                                             z_scale=self.z_scale), None
            return soft_argmax_3d_nhwc(nhwc, j, d, z_scale=self.z_scale), None
        return soft_argmax_3d(logits.reshape(b, j, d, h, w), j, d, h, w, z_scale=self.z_scale,
                              return_heatmap=True)

    def forward(self, x: torch.Tensor):
        return self.decode(self.features(x))


class PoseNet2D(nn.Module):
    """(B, H, W, 3) NHWC frames in [0, 1] -> (B, J*2) f32 [x, y] per joint
    in [0, 1) (the reference ``Model_2D``): ResNet, the deconv head, a 1x1
    conv to J heatmaps at H/4 x W/4, the plain ``soft_argmax_2d`` (f32
    under autocast too). The keys are ``PoseNet3D``'s (``preact``,
    ``deconv_layers``, ``final_layer``); ``interop.weights.
    posenet2d_from_flax`` writes them. The modules run ``channels_last``."""

    def __init__(self, architecture: str = "resnet50", num_joints: int = 17, *, device,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.architecture = architecture
        self.num_joints = num_joints
        self.preact = ResNet(architecture, **kw)
        self.deconv_layers = DeconvHead(self.preact.feature_channels, **kw)
        self.final_layer = nn.Conv2d(self.deconv_layers.out_channels, num_joints, 1, **kw)
        self.to(memory_format=torch.channels_last)

    @property
    def dtype(self) -> torch.dtype:
        """The parameters' dtype: the compute dtype outside torch.autocast."""
        return self.final_layer.weight.dtype

    def init_weights(self, generator: torch.Generator):
        """Draw every parameter and BatchNorm statistic from ``generator``
        (``init_image_model``)."""
        return init_image_model(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.final_layer(self.deconv_layers(self.preact(x.permute(0, 3, 1, 2))))
        _, j, h, w = logits.shape
        return soft_argmax_2d(logits, j, h, w)


class ProjectionMLP(nn.Module):
    """(B, ...) poses, flattened to (B, in_dim) -> (B, out_dim) in f32 (or
    wider): the reference ``Projection``. Defaults: 17 x 3 in, 17 x 2
    out. BatchNorm stays f32 (``models/norm.py``; momentum 0.1, flax's
    0.9)."""

    WIDTHS = (512, 256, 128)

    def __init__(self, in_dim: int = 51, out_dim: int = 34, *, device,
                 dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        layers: list[nn.Module] = [nn.Flatten()]
        for width in self.WIDTHS:
            layers += [nn.Linear(in_dim, width, **kw), F32BatchNorm1d(width, device=device),
                       nn.Tanh(), nn.Dropout(0.3)]
            in_dim = width
        layers.append(nn.Linear(in_dim, out_dim, **kw))
        self.mlp = nn.Sequential(*layers)

    @property
    def dtype(self) -> torch.dtype:
        """Parameter and compute dtype."""
        return self.mlp[-1].weight.dtype

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw every parameter and BatchNorm statistic from ``generator`` (a
        CPU generator): weights N(0, 1 / fan_in), biases N(0, 0.1),
        BatchNorms as ``norm.seed_batch_norm``; returns the module."""
        for m in self.mlp:
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.in_features ** -0.5)
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=generator))
            elif isinstance(m, nn.BatchNorm1d):
                seed_batch_norm(m, generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(x.to(self.dtype))
        return y.to(torch.promote_types(self.dtype, torch.float32))
