"""ResNet backbones (18/34/50/101/152): the port of
``pose3d_tpu/models/resnet.py``.

The reference architecture (``Resnet.py`` of the reference repo, as the
JAX module has it): a 7x7 stride-2 stem conv, BatchNorm, ReLU and a 3x3
stride-2 max-pool, then four stages of ``BasicBlock`` (18/34) or
``Bottleneck`` (50/101/152), no classifier: (B, 3, H, W) -> the stride-32
(B, 512 | 2048, H/32, W/32) feature map. Parameter names are
torchvision's (``conv1``, ``bn1``, ``layer{1..4}.{i}.conv{k}`` /
``bn{k}`` / ``downsample.{0,1}``), so a torchvision or reference state
dict loads as it is (``interop.weights.resnet_from_flax`` writes one).

Kept for parity with the flax module:

- the stride of a Bottleneck sits on its 3x3 conv; every 3x3 conv pads
  1, the stem 3; the max-pool pads with -inf;
- block 0 of a stage has the 1x1 downsample wherever the stride or the
  width changes, which includes stage 1 of the Bottleneck nets (64 ->
  256 channels);
- the input is cast to the model dtype at entry; BatchNorm stays f32
  (``models/norm.py``).

The modules run in whatever memory format their input has; the direct
model (``models/heads.py``) keeps them ``channels_last``, the layout of
the JAX package's NHWC convolutions. The convolutions are cuDNN's, as the
JAX package leaves its convolutions to XLA. ``load_torch_resnet`` is the
warm start from a torchvision (ImageNet) state dict.
"""

from __future__ import annotations

import torch
from torch import nn

from pose3d_tpu_torch.models.norm import F32BatchNorm2d

STAGE_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
BOTTLENECK_ARCHS = ("resnet50", "resnet101", "resnet152")


def _conv(c_in, c_out, k, stride=1, *, device, dtype):
    return nn.Conv2d(c_in, c_out, k, stride, padding=k // 2, bias=False, device=device,
                     dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.conv1 = _conv(in_planes, planes, 3, stride, **kw)
        self.bn1 = F32BatchNorm2d(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, **kw)
        self.bn2 = F32BatchNorm2d(planes, device=device)
        self.downsample = nn.Sequential(
            _conv(in_planes, planes, 1, stride, **kw),
            F32BatchNorm2d(planes, device=device)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        out = planes * self.expansion
        self.conv1 = _conv(in_planes, planes, 1, **kw)
        self.bn1 = F32BatchNorm2d(planes, device=device)
        self.conv2 = _conv(planes, planes, 3, stride, **kw)
        self.bn2 = F32BatchNorm2d(planes, device=device)
        self.conv3 = _conv(planes, out, 1, **kw)
        self.bn3 = F32BatchNorm2d(out, device=device)
        self.downsample = nn.Sequential(
            _conv(in_planes, out, 1, stride, **kw),
            F32BatchNorm2d(out, device=device)) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """Backbone: (B, 3, H, W) -> (B, C_out, H/32, W/32), C_out 2048 for the
    Bottleneck nets, 512 otherwise."""

    def __init__(self, architecture: str = "resnet50", *, device, dtype=torch.float32):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.architecture = architecture
        bottleneck = architecture in BOTTLENECK_ARCHS
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False, **kw)
        self.bn1 = F32BatchNorm2d(64, device=device)
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        in_planes = 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[architecture]):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                down = b == 0 and (s != 1 or in_planes != planes * block.expansion)
                blocks.append(block(in_planes, planes, s, down, **kw))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.feature_channels = in_planes

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype (of the convolutions)."""
        return self.conv1.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x.to(self.dtype)))))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x


@torch.no_grad()
def load_torch_resnet(model: ResNet, state_dict) -> int:
    """Merge a torchvision-layout ResNet state dict (tensors or numpy
    arrays) into ``model`` in place, as the reference's warm start filters
    it (``Model.py:30-38``): an entry whose key the model has with the same
    shape is copied, in the model's dtype; anything else (the classifier
    ``fc``, another architecture's shapes) is skipped, and the model keeps
    its own value there. BatchNorm's ``num_batches_tracked`` counters are
    not loaded, as the JAX package's merge has no such leaf. Returns the
    number of entries loaded."""
    own = model.state_dict()
    n = 0
    for key, value in state_dict.items():
        target = own.get(key)
        if key.endswith("num_batches_tracked") or target is None:
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) == tuple(target.shape):
            target.copy_(value)
            n += 1
    return n
