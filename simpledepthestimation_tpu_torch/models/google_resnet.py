"""GoogleResNet depth net of the depth + motion learning family (NCHW).

Counterpart of ``GoogleResNet`` and its parts in
``simpledepthestimation_tpu/models/google_resnet.py``: a ResNet-18/34/50
encoder whose norm is selectable (BatchNorm, RandLayerNorm with noised
statistics, or none) and whose downsample shortcut is a bare 1×1 conv (the
ResNetTF block: no norm after it), then a decoder of bilinear 2× upsamples and
3×3 convs ending in one single-scale softplus depth map.

Parameter names follow the checkpoints of this architecture, so that
``convert_google_resnet`` of the JAX package's ``models/torch_import.py`` reads
``state_dict()`` as it stands: ``encoder.encoder.conv1``, ``…bn1``,
``…layer{L}.{b}.conv{c}`` / ``.bn{c}`` / ``.downsample.0``;
``decoder.blocks.{k}.upconv`` / ``.iconv`` for k = 0..4 (upsample stages 4..0),
``decoder.out_conv`` and the optional ``decoder.scale``. Under ``randLN`` the
``bn*`` modules are RandLayerNorms with ``weight``/``bias`` only.

The RandLayerNorm noise stddev arrives with the call (the training ramp), and
the noise is drawn from the ``generator`` passed with it. Convolutions run in
the compute dtype; the norms return float32, so all encoder features are
float32; the decoder's upsample of a bfloat16 activation runs in bfloat16, as
in the JAX module.

``GoogleResNetv2`` and its ``MaxpoolShortcutBlock`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .build import DEPTH_NET_REGISTRY, compute_dtype
from .depth_nets import flip_images, parse_encoder_version
from .layers import RandLayerNorm
from .norm_layers import BatchNorm2d, Conv2d
from .resnet import BLOCKS, max_pool_3x3_s2
from ..geometry.camera import resize_img

Stddev = Union[float, torch.Tensor]


class _BatchNorm(BatchNorm2d):
    """The port's BatchNorm2d (Flax's running-variance rule) behind the call
    signature that every norm of this file shares."""

    def forward(self, x, train: bool = False, stddev: Stddev = 0.0, generator=None):
        return super().forward(x, train)


class _NoNorm(nn.Module):
    def forward(self, x, train: bool = False, stddev: Stddev = 0.0, generator=None):
        return x


def _Norm(kind: Optional[str], channels: int) -> nn.Module:
    """BatchNorm (``"BN"``: eps 1e-5, momentum 0.1 = Flax's 0.9),
    RandLayerNorm (``"randLN"``) or identity (anything else). Every one is
    called as ``norm(x, train, stddev, generator)``."""
    if kind == "BN":
        return _BatchNorm(channels, eps=1e-5, momentum=0.1)
    if kind == "randLN":
        return RandLayerNorm(channels)
    return _NoNorm()


def _shortcut(x: torch.Tensor, downsample: Optional[nn.Module], stride: int) -> torch.Tensor:
    """ResNetTF shortcut: a bare strided 1×1 conv on a channel change, a
    ``stride×stride`` max pool on a pure stride change, else the input."""
    if downsample is not None:
        return downsample(x)
    if stride != 1:
        return F.max_pool2d(x, stride, stride)
    return x


class NormBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1, norm: Optional[str] = "BN",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.stride = stride
        self.conv1 = Conv2d(in_ch, planes, 3, stride=stride, padding=1, bias=False, compute_dtype=dt)
        self.bn1 = _Norm(norm, planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, compute_dtype=dt)
        self.bn2 = _Norm(norm, planes)
        self.downsample = None
        if in_ch != planes:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, planes, 1, stride=stride, bias=False, compute_dtype=dt))

    def forward(self, x, train: bool = False, stddev: Stddev = 0.0, generator=None):
        out = F.relu(self.bn1(self.conv1(x), train, stddev, generator))
        out = self.bn2(self.conv2(out), train, stddev, generator)
        return F.relu(out + _shortcut(x, self.downsample, self.stride))


class NormBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1, norm: Optional[str] = "BN",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False, compute_dtype=dt)
        self.bn1 = _Norm(norm, planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False, compute_dtype=dt)
        self.bn2 = _Norm(norm, planes)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False, compute_dtype=dt)
        self.bn3 = _Norm(norm, out_ch)
        self.downsample = None
        if in_ch != out_ch:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, stride=stride, bias=False, compute_dtype=dt))

    def forward(self, x, train: bool = False, stddev: Stddev = 0.0, generator=None):
        out = F.relu(self.bn1(self.conv1(x), train, stddev, generator))
        out = F.relu(self.bn2(self.conv2(out), train, stddev, generator))
        out = self.bn3(self.conv3(out), train, stddev, generator)
        return F.relu(out + _shortcut(x, self.downsample, self.stride))


class _NormTrunk(nn.Module):
    """conv1, bn1, layer1..layer4, named as checkpoints name them."""

    def __init__(self, num_layers: int, norm: Optional[str], dt: torch.dtype):
        super().__init__()
        block_cls = NormBottleneck if num_layers > 34 else NormBasicBlock
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dt)
        self.bn1 = _Norm(norm, 64)
        in_ch = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512), BLOCKS[num_layers]), start=1):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (li > 1 and b == 0) else 1
                blocks.append(block_cls(in_ch, planes, stride, norm=norm, compute_dtype=dt))
                in_ch = planes * block_cls.expansion
            setattr(self, f"layer{li}", nn.ModuleList(blocks))


class NormResNetEncoder(nn.Module):
    """Five feature maps [relu(norm(conv1)), layer1..layer4] at strides
    2/4/8/16/32, channels ``num_ch_enc``."""

    def __init__(self, num_layers: int = 18, norm: Optional[str] = "BN",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.encoder = _NormTrunk(num_layers, norm, compute_dtype)

    @property
    def num_ch_enc(self):
        if self.num_layers > 34:
            return (64, 256, 512, 1024, 2048)
        return (64, 64, 128, 256, 512)

    def forward(self, x, train: bool = False, stddev: Stddev = 0.0, generator=None) -> List[torch.Tensor]:
        enc = self.encoder
        x = F.relu(enc.bn1(enc.conv1(x), train, stddev, generator))
        features = [x]
        x = max_pool_3x3_s2(x)
        for li in range(1, 5):
            for block in getattr(enc, f"layer{li}"):
                x = block(x, train, stddev, generator)
            features.append(x)
        return features


class UpsampleBlock(nn.Module):
    """bilinear 2× → 3×3 conv + ReLU → concat skip → 3×3 conv + ReLU (zero
    padding, Xavier-uniform kernels)."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upconv = Conv2d(in_ch, out_ch, 3, padding=1, compute_dtype=compute_dtype, xavier=True)
        self.iconv = Conv2d(out_ch + skip_ch, out_ch, 3, padding=1, compute_dtype=compute_dtype, xavier=True)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = resize_img(x, (x.shape[2] * 2, x.shape[3] * 2), mode="bilinear")
        out = F.relu(self.upconv(out))
        if skip is not None:
            out = torch.cat([out, skip], dim=1)  # promotes to the skip's float32
        return F.relu(self.iconv(out))


class GoogleDepthDecoder(nn.Module):
    """Five upsample stages (4..0, ``blocks[k]`` is stage 4−k) and a 3×3
    ``out_conv``; depth = softplus in float32, times a learned ``scale`` when
    ``learn_scale``."""

    def __init__(self, num_ch_enc: Sequence[int], learn_scale: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        num_ch_dec = (16, 32, 64, 128, 256)
        blocks = []
        for i in range(4, -1, -1):
            in_ch = num_ch_enc[-1] if i == 4 else num_ch_dec[i + 1]
            skip_ch = num_ch_enc[i - 1] if i > 0 else 0
            blocks.append(UpsampleBlock(in_ch, num_ch_dec[i], skip_ch, compute_dtype))
        self.blocks = nn.ModuleList(blocks)
        self.out_conv = Conv2d(num_ch_dec[0], 1, 3, padding=1, compute_dtype=compute_dtype, xavier=True)
        self.scale = None
        if learn_scale:
            self.scale = nn.Parameter(torch.ones(1))
            self.param_init = {"scale": 1.0}

    def forward(self, features: Sequence[torch.Tensor]) -> torch.Tensor:
        out = features[-1]
        for k, i in enumerate(range(4, -1, -1)):
            out = self.blocks[k](out, features[i - 1] if i > 0 else None)
        depth = F.softplus(self.out_conv(out).float())
        if self.scale is not None:
            depth = depth * self.scale
        return depth


@DEPTH_NET_REGISTRY.register()
class GoogleResNet(nn.Module):
    def __init__(self, num_layers: int = 18, pretrained: bool = False, norm: Optional[str] = "BN",
                 learn_scale: bool = False, upsample_depth: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        # an ImageNet warm start: models.pretrained loads it (parallel.create_train_state)
        self.pretrained = pretrained
        self.upsample_depth = upsample_depth
        self.encoder = NormResNetEncoder(num_layers, norm=norm, compute_dtype=compute_dtype)
        self.decoder = GoogleDepthDecoder(self.encoder.num_ch_enc, learn_scale=learn_scale,
                                          compute_dtype=compute_dtype)

    @classmethod
    def from_cfg(cls, cfg):
        num_layers, pretrained = parse_encoder_version(cfg.MODEL.DEPTH_NET.ENCODER_NAME)
        dn = cfg.MODEL.DEPTH_NET
        return cls(
            num_layers=num_layers,
            pretrained=pretrained,
            norm=dn.get("NORM", "BN"),
            learn_scale=bool(dn.get("LEARN_SCALE", False)),
            upsample_depth=bool(dn.get("UPSAMPLE_DEPTH", False)),
            compute_dtype=compute_dtype(cfg),
        )

    def forward(self, image: torch.Tensor, flip: Optional[torch.Tensor] = None, train: bool = False,
                intrinsics: Optional[torch.Tensor] = None, noise_stddev: Stddev = 0.0,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """image [B,3,H,W] normalized → ``[depth [B,1,H,W] float32]``.
        ``intrinsics`` is accepted for interface uniformity and ignored."""
        if flip is not None:
            image = flip_images(image, flip)
        features = self.encoder(image, train, noise_stddev, generator)
        depth = self.decoder(features)
        if flip is not None:
            depth = flip_images(depth, flip)
        if self.upsample_depth:
            depth = resize_img(depth, image.shape[2:], mode="nearest")
        return [depth]
