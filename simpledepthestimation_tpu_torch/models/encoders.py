"""The BTS encoder zoo beyond ResNet: ResNeXt, DenseNet and MobileNetV2 (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/encoders.py``. Each encoder
returns the five feature maps that the BTS decoder taps, at strides
2/4/8/16/32, with the channels of ``BTS_ENCODERS``:

- ``ResNeXtEncoder``: the ResNet trunk of ``models/resnet.py`` with grouped
  3×3 convolutions (32 groups; width 4 a group for 50 layers, 8 for 101).
- ``DenseNetEncoder`` (121, 161): tapped at relu0 (H/2), pool0 (H/4), the
  outputs of transition1 and transition2 after their 2×2 average pool (H/8,
  H/16) and norm5 (H/32).
- ``MobileNetV2Encoder``: tapped after modules 1/3/6/10/18 of ``features``
  (16/24/32/64/1280 channels; the last is the 1×1 head).

Parameters carry torchvision's names under ``encoder.`` (``encoder.conv1``,
``encoder.layer1.0.conv2`` for ResNeXt; ``encoder.features.denseblock1.denselayer1.norm1``,
``encoder.features.transition1.conv``; ``encoder.features.3.conv.1.0``), so a
torchvision ``state_dict`` loads key by key (``models/pretrained.py``). Every
BatchNorm is torch momentum 0.1 (Flax 0.9), eps 1e-5, and computes in float32;
convolutions run in the compute dtype.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm_layers import BatchNorm2d, Conv2d
from .resnet import ResNetEncoder, max_pool_3x3_s2

ZOO_CHANNELS_RESNET = (64, 256, 512, 1024, 2048)


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=1e-5, momentum=0.1)


class ResNeXtEncoder(ResNetEncoder):
    """resnext50_32x4d (blocks 3/4/6/3, width 4 a group) or resnext101_32x8d
    (3/4/23/3, width 8): 32 groups in every Bottleneck's 3×3."""

    def __init__(self, num_layers: int = 50, width_per_group: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_layers, compute_dtype=compute_dtype, groups=32, width_per_group=width_per_group)


# ---------------------------------------------------------------------------
# DenseNet
# ---------------------------------------------------------------------------


class _DenseLayer(nn.Module):
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int, dt: torch.dtype):
        super().__init__()
        self.norm1 = _bn(in_ch)
        self.conv1 = Conv2d(in_ch, bn_size * growth_rate, 1, bias=False, compute_dtype=dt)
        self.norm2 = _bn(bn_size * growth_rate)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False, compute_dtype=dt)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = self.conv1(F.relu(self.norm1(x, train)))
        out = self.conv2(F.relu(self.norm2(out, train)))
        return torch.cat([x, out], 1)  # promotes a bfloat16 ``out`` to x's float32, as jnp does


class _Transition(nn.Module):
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, out_ch: int, dt: torch.dtype):
        super().__init__()
        self.norm = _bn(in_ch)
        self.conv = Conv2d(in_ch, out_ch, 1, bias=False, compute_dtype=dt)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.avg_pool2d(self.conv(F.relu(self.norm(x, train))), 2, stride=2)


class _DenseNetFeatures(nn.Module):
    """torchvision's ``densenet*.features``: conv0, norm0, denseblock{i}
    (denselayer{j}, 1-based), transition{i}, norm5."""

    def __init__(self, block_config, growth_rate: int, num_init_features: int, dt: torch.dtype,
                 bn_size: int = 4):
        super().__init__()
        self.conv0 = Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False, compute_dtype=dt)
        self.norm0 = _bn(num_init_features)
        ch = num_init_features
        for i, n_layers in enumerate(block_config, start=1):
            block = nn.ModuleDict()
            for j in range(1, n_layers + 1):
                block[f"denselayer{j}"] = _DenseLayer(ch, growth_rate, bn_size, dt)
                ch += growth_rate
            setattr(self, f"denseblock{i}", block)
            if i != len(block_config):
                setattr(self, f"transition{i}", _Transition(ch, ch // 2, dt))
                ch //= 2
        self.norm5 = _bn(ch)
        self.num_blocks = len(block_config)


class _Features(nn.Module):
    """Holds the torchvision ``features`` module, so that its keys start ``features.``."""

    def __init__(self, features: nn.Module):
        super().__init__()
        self.features = features


class DenseNetEncoder(nn.Module):
    """densenet121: blocks (6, 12, 24, 16), growth 32, 64 initial features;
    densenet161: (6, 12, 36, 24), growth 48, 96."""

    def __init__(self, block_config=(6, 12, 24, 16), growth_rate: int = 32, num_init_features: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = _Features(_DenseNetFeatures(block_config, growth_rate, num_init_features, compute_dtype))

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        f = self.encoder.features
        x = F.relu(f.norm0(f.conv0(x), train))
        features = [x]  # relu0
        x = max_pool_3x3_s2(x)
        features.append(x)  # pool0
        for i in range(1, f.num_blocks + 1):
            for layer in getattr(f, f"denseblock{i}").values():
                x = layer(x, train)
            if i != f.num_blocks:
                x = getattr(f, f"transition{i}")(x, train)
                if i <= 2:
                    features.append(x)  # transition1, transition2
        features.append(f.norm5(x, train))
        return features


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------


class _ConvBNReLU6(nn.ModuleList):
    """torchvision's Conv2dNormActivation: the conv (index 0), the BatchNorm (1), ReLU6."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, groups: int, dt: torch.dtype):
        super().__init__([
            Conv2d(in_ch, out_ch, kernel, stride=stride, padding=(kernel - 1) // 2, groups=groups, bias=False,
                   compute_dtype=dt),
            _bn(out_ch),
        ])

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return F.relu6(self[1](self[0](x), train))


class _InvertedResidual(nn.Module):
    """``conv``: [expand 1×1 (expansion above 1 only)], depthwise 3×3, project 1×1, BatchNorm."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand_ratio: int, dt: torch.dtype):
        super().__init__()
        hidden = in_ch * expand_ratio
        layers = [_ConvBNReLU6(in_ch, hidden, 1, 1, 1, dt)] if expand_ratio != 1 else []
        layers += [
            _ConvBNReLU6(hidden, hidden, 3, stride, hidden, dt),
            Conv2d(hidden, out_ch, 1, bias=False, compute_dtype=dt),
            _bn(out_ch),
        ]
        self.conv = nn.ModuleList(layers)
        self.use_res = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        out = x
        for block in self.conv[:-2]:
            out = block(out, train)
        out = self.conv[-1](self.conv[-2](out), train)
        return x + out if self.use_res else out


# (expansion t, channels c, repeats n, first stride s) of torchvision's mobilenet_v2
MOBILENET_V2_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                         (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class MobileNetV2Encoder(nn.Module):
    """torchvision's ``mobilenet_v2.features`` (index 0 the stem, 1–17 the
    inverted residuals, 18 the 1280-channel head), tapped after 1/3/6/10/18."""

    TAPS = (1, 3, 6, 10, 18)

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        modules = [_ConvBNReLU6(3, 32, 3, 2, 1, dt)]
        ch = 32
        for t, c, n, s in MOBILENET_V2_SETTINGS:
            for b in range(n):
                modules.append(_InvertedResidual(ch, c, s if b == 0 else 1, t, dt))
                ch = c
        modules.append(_ConvBNReLU6(ch, 1280, 1, 1, 1, dt))
        self.encoder = _Features(nn.ModuleList(modules))

    def forward(self, x: torch.Tensor, train: bool = False) -> List[torch.Tensor]:
        features = []
        for idx, module in enumerate(self.encoder.features):
            x = module(x, train)
            if idx in self.TAPS:
                features.append(x)
        return features


# name -> (constructor taking the compute dtype, channels of the five taps)
BTS_ENCODERS = {
    "resnext50_bts": (lambda dt: ResNeXtEncoder(50, 4, compute_dtype=dt), ZOO_CHANNELS_RESNET),
    "resnext101_bts": (lambda dt: ResNeXtEncoder(101, 8, compute_dtype=dt), ZOO_CHANNELS_RESNET),
    "densenet121_bts": (lambda dt: DenseNetEncoder((6, 12, 24, 16), 32, 64, compute_dtype=dt),
                        (64, 64, 128, 256, 1024)),
    "densenet161_bts": (lambda dt: DenseNetEncoder((6, 12, 36, 24), 48, 96, compute_dtype=dt),
                        (96, 96, 192, 384, 2208)),
    "mobilenetv2_bts": (lambda dt: MobileNetV2Encoder(compute_dtype=dt), (16, 24, 32, 64, 1280)),
}
