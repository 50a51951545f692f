"""ResNet encoder producing the 5-scale feature pyramid (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/resnet.py``: a torchvision
ResNet-18/34/50/101 trunk tapped at conv1, layer1..layer4, channel schedule
[64, 64, 128, 256, 512] (×4 from layer1 up for Bottleneck nets). With
``groups`` > 1 the Bottleneck's 3×3 is grouped and ``width_per_group`` sets its
width, torchvision's ResNeXt (the BTS encoder zoo, ``models/encoders.py``). Parameter
names are torchvision's (``encoder.conv1``, ``encoder.layer1.0.bn1``,
``encoder.layer2.0.downsample.0``), so torchvision-style checkpoints and the
JAX package's converters line up with ``state_dict()`` key by key.

Convolutions run in the compute dtype; every BatchNorm computes in float32 and
returns float32, so all five feature maps are float32.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm_layers import BatchNorm2d, Conv2d

BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BOTTLENECK = {18: False, 34: False, 50: True, 101: True}


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class _Downsample(nn.ModuleList):
    """1×1 strided conv (index 0) + BatchNorm (index 1)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, dt: torch.dtype):
        super().__init__([
            Conv2d(in_ch, out_ch, 1, stride=stride, bias=False, compute_dtype=dt), _bn(out_ch)
        ])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return self[1](self[0](x), train)


class BasicBlock(nn.Module):
    expansion = 1
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.conv1 = Conv2d(in_ch, planes, 3, stride=stride, padding=1, bias=False, compute_dtype=dt)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, compute_dtype=dt)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = _Downsample(in_ch, planes, stride, dt)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32, groups: int = 1, width_per_group: int = 64):
        super().__init__()
        dt = compute_dtype
        out_ch = planes * self.expansion
        width = int(planes * width_per_group / 64) * groups
        self.conv1 = Conv2d(in_ch, width, 1, bias=False, compute_dtype=dt)
        self.bn1 = _bn(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, groups=groups, bias=False, compute_dtype=dt)
        self.bn2 = _bn(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False, compute_dtype=dt)
        self.bn3 = _bn(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = _Downsample(in_ch, out_ch, stride, dt)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x if self.downsample is None else self.downsample(x, train)
        return F.relu(out + identity)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1): -inf padding of 1, then VALID."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


class _Trunk(nn.Module):
    """The torchvision-named trunk: conv1, bn1, layer1..layer4."""

    def __init__(self, num_layers: int, num_input_images: int, dt: torch.dtype,
                 groups: int = 1, width_per_group: int = 64):
        super().__init__()
        bottleneck = BOTTLENECK[num_layers]
        block_cls = Bottleneck if bottleneck else BasicBlock
        grouping = {"groups": groups, "width_per_group": width_per_group} if bottleneck else {}
        self.conv1 = Conv2d(3 * num_input_images, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dt)
        self.bn1 = _bn(64)
        in_ch = 64
        for layer_idx, (planes, n_blocks) in enumerate(
            zip((64, 128, 256, 512), BLOCKS[num_layers]), start=1
        ):
            stride = 1 if layer_idx == 1 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(block_cls(in_ch, planes, stride if b == 0 else 1, compute_dtype=dt, **grouping))
                in_ch = planes * block_cls.expansion
            setattr(self, f"layer{layer_idx}", nn.ModuleList(blocks))


class ResNetEncoder(nn.Module):
    """5-feature-map ResNet trunk: [relu(conv1), layer1, layer2, layer3, layer4]
    at strides 2/4/8/16/32 with channels ``num_ch_enc``."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 1,
                 compute_dtype: torch.dtype = torch.float32, groups: int = 1, width_per_group: int = 64):
        super().__init__()
        self.num_layers = num_layers
        self.encoder = _Trunk(num_layers, num_input_images, compute_dtype, groups, width_per_group)

    @property
    def num_ch_enc(self) -> Tuple[int, ...]:
        if BOTTLENECK[self.num_layers]:
            return (64, 256, 512, 1024, 2048)
        return (64, 64, 128, 256, 512)

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        enc = self.encoder
        x = F.relu(enc.bn1(enc.conv1(x), train))
        features = [x]
        x = max_pool_3x3_s2(x)
        for layer_idx in range(1, 5):
            for block in getattr(enc, f"layer{layer_idx}"):
                x = block(x, train)
            features.append(x)
        return features
