"""BTS: the supervised depth net with local planar guidance (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/bts.py``: an encoder of the
zoo (ResNet-50/101 from ``models/resnet.py``, ResNeXt, DenseNet, MobileNetV2
from ``models/encoders.py``) → upconv/skip decoder with a dense ASPP chain
(dilations 3/6/12/18/24) → ``Reduction1x1`` plane heads (θ, φ, dist) → local
planar guidance at 8×, 4× and 2× → sigmoid depth × ``MAX_DEPTH``, scaled by
``focal / 715.0873`` when ``MODEL.DATASET`` is ``kitti``.

The decoder's parameters carry the names of the original BTS PyTorch code
(``upconv5.conv``, ``conv5.0``, ``daspp_6.atrous_conv.first_bn``,
``daspp_6.atrous_conv.aconv_sequence.1``, ``reduc8x8.reduc.inter_128_64.0``,
``get_depth.0``), which the JAX package's ``convert_bts_decoder`` reads.
Its BatchNorms are torch momentum 0.01 (Flax 0.99) with eps 1.1e-5, but for
``aconv_sequence.2`` (eps 1e-5).

Dtypes as in the JAX package: convolutions in the compute dtype; BatchNorm
outputs float32, so a concatenation of one with a bfloat16 tensor is float32
and the next convolution rounds it; the LPG depths are rounded to the compute
dtype where they enter a concatenation; the plane heads and the final depth
go to float32 before their sigmoid.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .build import DEPTH_NET_REGISTRY, compute_dtype
from .depth_nets import flip_images
from .encoders import BTS_ENCODERS
from .layers import upsample_nearest_2x
from .norm_layers import BatchNorm2d, Conv2d
from .resnet import ResNetEncoder

KITTI_FOCAL = 715.0873

ENCODER_CHANNELS = {
    "resnet50_bts": (50, (64, 256, 512, 1024, 2048)),
    "resnet101_bts": (101, (64, 256, 512, 1024, 2048)),
}


def _bn(ch: int, eps: float = 1.1e-5) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=eps, momentum=0.01)


class ConvELU(nn.Sequential):
    """``{name}.0`` conv without bias, then ELU."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, out_ch: int, dt: torch.dtype, kernel: int = 3):
        super().__init__(Conv2d(in_ch, out_ch, kernel, padding=(kernel - 1) // 2, bias=False, compute_dtype=dt),
                         nn.ELU())


class AtrousConv(nn.Module):
    """[BN (eps 1.1e-5)] → ReLU → 1×1 conv (2× out) → BN (eps 1e-5) → ReLU →
    3×3 conv dilated by ``dilation`` at padding ``dilation``."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, out_ch: int, dilation: int, apply_bn_first: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        seq = nn.ModuleDict({
            "1": Conv2d(in_ch, out_ch * 2, 1, bias=False, compute_dtype=dt),
            "2": _bn(out_ch * 2, eps=1e-5),
            "4": Conv2d(out_ch * 2, out_ch, 3, padding=dilation, dilation=dilation, bias=False, compute_dtype=dt),
        })
        self.atrous_conv = nn.ModuleDict({"first_bn": _bn(in_ch)} if apply_bn_first else {})
        self.atrous_conv["aconv_sequence"] = seq

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if "first_bn" in self.atrous_conv:
            x = self.atrous_conv["first_bn"](x, train)
        seq = self.atrous_conv["aconv_sequence"]
        x = F.relu(seq["2"](seq["1"](F.relu(x)), train))
        return seq["4"](F.relu(x))


class UpConv(nn.Module):
    """Nearest 2× → 3×3 conv → ELU."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, padding=1, bias=False, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # cast before the upsample: the values the conv would see, half the bytes under bfloat16
        return F.elu(self.conv(upsample_nearest_2x(x.to(self.conv.compute_dtype))))


class Reduction1x1(nn.Module):
    """Halving 1×1 conv + ELU chain ``reduc.inter_{in}_{out}``, then either
    ``reduc.plane_params`` (3 channels → unit normal from θ, φ and a distance,
    [B,4,h,w] float32) or, ``is_final``, ``reduc.final`` (1 channel, sigmoid)."""

    def __init__(self, in_ch: int, num_out: int, max_depth: float, is_final: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.max_depth = max_depth
        self.reduc = nn.ModuleDict()
        while num_out >= 4:
            if num_out < 8:
                if is_final:
                    self.reduc["final"] = nn.Sequential(Conv2d(in_ch, 1, 1, bias=False, compute_dtype=dt))
                else:
                    self.reduc["plane_params"] = Conv2d(in_ch, 3, 1, bias=False, compute_dtype=dt)
                break
            self.reduc[f"inter_{in_ch}_{num_out}"] = ConvELU(in_ch, num_out, dt, kernel=1)
            in_ch, num_out = num_out, num_out // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, module in self.reduc.items():
            if name == "final":
                return torch.sigmoid(module(x).float())
            x = module(x)
        x = x.float()
        theta = torch.sigmoid(x[:, 0]) * math.pi / 3
        phi = torch.sigmoid(x[:, 1]) * math.pi * 2
        dist = torch.sigmoid(x[:, 2]) * self.max_depth
        n1 = torch.sin(theta) * torch.cos(phi)
        n2 = torch.sin(theta) * torch.sin(phi)
        n3 = torch.cos(theta)
        return torch.stack([n1, n2, n3, dist], dim=1)


def local_planar_guidance(plane_eq: torch.Tensor, upratio: int) -> torch.Tensor:
    """Plane equations [B,4,h,w] (unit normal n1..n3, distance n4) evaluated at
    the subpixel offsets of an ``upratio`` upsampling: depth [B, h·r, w·r].
    Each plane is broadcast over its r×r cell (no repeated copy of the planes)."""
    B, _, h, w = plane_eq.shape
    r = upratio
    n1, n2, n3, n4 = (p[:, :, None, :, None] for p in plane_eq.unbind(1))  # [B,h,1,w,1]
    offs = (torch.arange(r, dtype=torch.float32, device=plane_eq.device) - (r - 1) * 0.5) / r
    u = offs.reshape(1, 1, 1, 1, r)  # x-subpixel
    v = offs.reshape(1, 1, r, 1, 1)  # y-subpixel
    return (n4 / (n1 * u + n2 * v + n3)).reshape(B, h * r, w * r)


class BtsDecoder(nn.Module):
    def __init__(self, feat_channels: Sequence[int], max_depth: float, num_features: int = 512,
                 dataset: str = "kitti", compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        nf, dt, fc = num_features, compute_dtype, feat_channels
        self.max_depth = max_depth
        self.dataset = dataset
        self.compute_dtype = dt
        self.upconv5 = UpConv(fc[4], nf, dt)
        self.bn5 = _bn(nf)
        self.conv5 = ConvELU(nf + fc[3], nf, dt)
        self.upconv4 = UpConv(nf, nf // 2, dt)
        self.bn4 = _bn(nf // 2)
        self.conv4 = ConvELU(nf // 2 + fc[2], nf // 2, dt)
        self.bn4_2 = _bn(nf // 2)
        cat4 = nf // 2 + fc[2]
        self.daspp_3 = AtrousConv(nf // 2, nf // 4, 3, apply_bn_first=False, compute_dtype=dt)
        self.daspp_6 = AtrousConv(cat4 + nf // 4, nf // 4, 6, compute_dtype=dt)
        self.daspp_12 = AtrousConv(cat4 + nf // 2, nf // 4, 12, compute_dtype=dt)
        self.daspp_18 = AtrousConv(cat4 + 3 * nf // 4, nf // 4, 18, compute_dtype=dt)
        self.daspp_24 = AtrousConv(cat4 + nf, nf // 4, 24, compute_dtype=dt)
        self.daspp_conv = ConvELU(nf // 2 + 5 * (nf // 4), nf // 4, dt)
        self.reduc8x8 = Reduction1x1(nf // 4, nf // 4, max_depth, compute_dtype=dt)
        self.upconv3 = UpConv(nf // 4, nf // 4, dt)
        self.bn3 = _bn(nf // 4)
        self.conv3 = ConvELU(nf // 4 + fc[1] + 1, nf // 4, dt)
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, max_depth, compute_dtype=dt)
        self.upconv2 = UpConv(nf // 4, nf // 8, dt)
        self.bn2 = _bn(nf // 8)
        self.conv2 = ConvELU(nf // 8 + fc[0] + 1, nf // 8, dt)
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, max_depth, compute_dtype=dt)
        self.upconv1 = UpConv(nf // 8, nf // 16, dt)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, max_depth, is_final=True, compute_dtype=dt)
        self.conv1 = ConvELU(nf // 16 + 4, nf // 16, dt)
        self.get_depth = nn.Sequential(Conv2d(nf // 16, 1, 3, padding=1, bias=False, compute_dtype=dt))

    def _plane_depth(self, reduction: Reduction1x1, feat: torch.Tensor, upratio: int) -> torch.Tensor:
        """Plane heads → unit normals (norm floored at 1e-12) → LPG depth / max_depth, [B,1,H,W] float32."""
        reduc = reduction(feat)
        normal = reduc[:, :3]
        normal = normal / torch.clamp_min((normal * normal).sum(dim=1, keepdim=True).sqrt(), 1e-12)
        depth = local_planar_guidance(torch.cat([normal, reduc[:, 3:]], 1), upratio)
        return depth[:, None] / self.max_depth

    def forward(self, features: List[torch.Tensor], focal: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The final depth [B,1,H,W] float32 (the JAX module also returns the
        LPG depths and ``reduc1x1``, which nothing reads)."""
        dt = self.compute_dtype
        skip0, skip1, skip2, skip3 = features[:4]
        dense = F.relu(features[4])

        upconv5 = self.bn5(self.upconv5(dense), train)  # H/16
        iconv5 = self.conv5(torch.cat([upconv5, skip3], 1))

        upconv4 = self.bn4(self.upconv4(iconv5), train)  # H/8
        concat4 = torch.cat([upconv4, skip2], 1)
        iconv4 = self.bn4_2(self.conv4(concat4), train)

        daspp_3 = self.daspp_3(iconv4, train)
        concat4_2 = torch.cat([concat4, daspp_3], 1)
        daspp_6 = self.daspp_6(concat4_2, train)
        concat4_3 = torch.cat([concat4_2, daspp_6], 1)
        daspp_12 = self.daspp_12(concat4_3, train)
        concat4_4 = torch.cat([concat4_3, daspp_12], 1)
        daspp_18 = self.daspp_18(concat4_4, train)
        concat4_5 = torch.cat([concat4_4, daspp_18], 1)
        daspp_24 = self.daspp_24(concat4_5, train)
        daspp_feat = self.daspp_conv(torch.cat([iconv4, daspp_3, daspp_6, daspp_12, daspp_18, daspp_24], 1))

        depth_8x8_scaled = self._plane_depth(self.reduc8x8, daspp_feat, 8)
        depth_8x8_ds = depth_8x8_scaled[:, :, ::4, ::4]  # nearest 1/4

        upconv3 = self.bn3(self.upconv3(daspp_feat), train)  # H/4
        iconv3 = self.conv3(torch.cat([upconv3, skip1, depth_8x8_ds.to(dt)], 1))

        depth_4x4_scaled = self._plane_depth(self.reduc4x4, iconv3, 4)
        depth_4x4_ds = depth_4x4_scaled[:, :, ::2, ::2]

        upconv2 = self.bn2(self.upconv2(iconv3), train)  # H/2
        iconv2 = self.conv2(torch.cat([upconv2, skip0, depth_4x4_ds.to(dt)], 1))

        depth_2x2_scaled = self._plane_depth(self.reduc2x2, iconv2, 2)

        upconv1 = self.upconv1(iconv2)
        reduc1x1 = self.reduc1x1(upconv1)
        concat1 = torch.cat([upconv1, reduc1x1.to(dt), depth_2x2_scaled.to(dt), depth_4x4_scaled.to(dt),
                             depth_8x8_scaled.to(dt)], 1)
        iconv1 = self.conv1(concat1)
        final_depth = self.max_depth * torch.sigmoid(self.get_depth(iconv1).float())
        if self.dataset == "kitti":
            final_depth = final_depth * focal.reshape(-1, 1, 1, 1) / KITTI_FOCAL
        return final_depth


def build_bts_encoder(name: str, dt: torch.dtype):
    """(encoder, channels of its five taps) for a BTS encoder name."""
    if name in ENCODER_CHANNELS:
        num_layers, channels = ENCODER_CHANNELS[name]
        return ResNetEncoder(num_layers, compute_dtype=dt), channels
    if name in BTS_ENCODERS:
        ctor, channels = BTS_ENCODERS[name]
        return ctor(dt), channels
    raise NotImplementedError(
        f"BTS encoder {name} not available (supported: {sorted(list(ENCODER_CHANNELS) + list(BTS_ENCODERS))})"
    )


@DEPTH_NET_REGISTRY.register()
class BtsModel(nn.Module):
    def __init__(self, encoder_name: str = "resnet50_bts", max_depth: float = 80.0, bts_size: int = 512,
                 dataset: str = "kitti", bn_no_track: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder_name = encoder_name
        self.bn_no_track = bn_no_track
        self.encoder, channels = build_bts_encoder(encoder_name, compute_dtype)
        self.decoder = BtsDecoder(channels, max_depth, bts_size, dataset, compute_dtype)

    @classmethod
    def from_cfg(cls, cfg):
        dn = cfg.MODEL.DEPTH_NET
        return cls(
            encoder_name=str(dn.ENCODER_NAME),
            max_depth=float(cfg.MODEL.MAX_DEPTH),
            bts_size=int(dn.get("BTS_SIZE", 512)),
            dataset=str(cfg.MODEL.get("DATASET", "kitti")),
            bn_no_track=bool(dn.get("BN_NO_TRACK", False)),
            compute_dtype=compute_dtype(cfg),
        )

    def forward(self, image: torch.Tensor, flip: Optional[torch.Tensor] = None, train: bool = False,
                intrinsics: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """image [B,3,H,W] normalised → [depth [B,1,H,W] float32]. The focal
        length is ``intrinsics[:, 0, 0]``, else 715.0873. With ``BN_NO_TRACK``
        the BatchNorms use their running statistics in training too."""
        if flip is not None:
            image = flip_images(image, flip)
        if intrinsics is not None:
            focal = intrinsics[:, 0, 0]
        else:
            focal = torch.full((image.shape[0],), KITTI_FOCAL, dtype=torch.float32, device=image.device)
        bn_train = train and not self.bn_no_track
        depth = self.decoder(self.encoder(image, train=bn_train), focal, train=bn_train)
        if flip is not None:
            depth = flip_images(depth, flip)
        return [depth]
