"""Plain float32 networks of the benchmark's configurations, in PyTorch.

The depth nets (DepthResNet-18 with its U-Net decoder, PackNet01 1A) and
PoseNet as published (MonoDepth2, Godard et al. 2019, arXiv:1806.01260;
PackNet-SfM, Guizilini et al. 2020, arXiv:1905.02693), written from their
equations with ``torch.nn`` layers only: no kernel, cache or precision policy of
the program. Parameter names follow the published checkpoints' (torchvision's
ResNet trunk, MonoDepth2's ``decoder`` list, PackNet's ``pack1.conv3d``), so
that one set of seeded weights can be loaded by name into this reference and
into the system under test.

Every convolution is :class:`Conv2d` or :class:`Conv3d`: float32 unless
:func:`use_float8` computes it in float8, the lower precision that the
benchmark's control uses: input and weight rounded to e4m3, and the gradients
of its output, input and weight rounded to e5m2 (one scale per tensor).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with one scale for the tensor (its
    largest magnitude maps to the largest finite value), back in float32."""
    scale = x.abs().amax().float().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x.float() / scale).to(dtype).to(torch.float32) * scale


class _Float8(torch.autograd.Function):
    """Forward: the value rounded to e4m3 (activations, weights). Backward: the
    incoming gradient rounded to e5m2, the split that float8 training uses."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    return _Float8.apply(x)


class _Conv:
    fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.fp8:
            return fake_fp8(self._conv_forward(fake_fp8(x), fake_fp8(self.weight), self.bias))
        return self._conv_forward(x, self.weight, self.bias)


class Conv2d(_Conv, nn.Conv2d):
    pass


class Conv3d(_Conv, nn.Conv3d):
    pass


def use_float8(model: nn.Module) -> None:
    """Compute every convolution of ``model`` in float8."""
    for m in model.modules():
        if isinstance(m, _Conv):
            m.fp8 = True


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Training-mode batch norm: the batch's mean and biased variance."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=True, momentum=bn.momentum, eps=bn.eps)


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
    min_disp, max_disp = 1.0 / max_depth, 1.0 / min_depth
    return 1.0 / (min_disp + (max_disp - min_disp) * disp)


def flip(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mirror the samples of ``x`` [B,C,H,W] where ``mask`` [B] is true."""
    return torch.where(mask[:, None, None, None], x.flip(3), x)


def up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# --------------------------------------------------------------------------- ResNet-18 + decoder


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.ModuleList([Conv2d(cin, planes, 1, stride=stride, bias=False),
                                             nn.BatchNorm2d(planes)])

    def forward(self, x):
        out = F.relu(batch_norm(self.bn1, self.conv1(x)))
        out = batch_norm(self.bn2, self.conv2(out))
        skip = x if self.downsample is None else batch_norm(self.downsample[1], self.downsample[0](x))
        return F.relu(out + skip)


class _Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, planes in enumerate((64, 128, 256, 512), start=1):
            stride = 1 if i == 1 else 2
            setattr(self, f"layer{i}", nn.ModuleList([BasicBlock(cin, planes, stride), BasicBlock(planes, planes, 1)]))
            cin = planes


class ResNet18Encoder(nn.Module):
    num_ch_enc = (64, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        self.encoder = _Trunk()

    def forward(self, x) -> List[torch.Tensor]:
        e = self.encoder
        x = F.relu(batch_norm(e.bn1, e.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(1, 5):
            for block in getattr(e, f"layer{i}"):
                x = block(x)
            feats.append(x)
        return feats


class Conv3x3(nn.Module):
    """Reflection pad 1, then a 3×3 convolution with bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


class DepthDecoder(nn.Module):
    num_ch_dec = (16, 32, 64, 128, 256)

    def __init__(self, enc):
        super().__init__()
        dec = self.num_ch_dec
        convs = []
        for i in range(4, -1, -1):
            convs.append(ConvBlock(enc[-1] if i == 4 else dec[i + 1], dec[i]))
            convs.append(ConvBlock(dec[i] + (enc[i - 1] if i > 0 else 0), dec[i]))
        convs += [Conv3x3(dec[s], 1) for s in range(4)]
        self.decoder = nn.ModuleList(convs)

    def forward(self, feats):
        disps = {}
        x = feats[-1]
        for i in range(4, -1, -1):
            k = 2 * (4 - i)
            x = up2(self.decoder[k](x))
            if i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = self.decoder[k + 1](x)
            if i < 4:
                disps[i] = F.softplus(self.decoder[10 + i](x))
        return [disps[i] for i in range(4)]


class DepthResNet(nn.Module):
    def __init__(self, max_depth: float):
        super().__init__()
        self.max_depth = max_depth
        self.encoder = ResNet18Encoder()
        self.decoder = DepthDecoder(ResNet18Encoder.num_ch_enc)

    def forward(self, image, mirror: Optional[torch.Tensor]):
        if mirror is not None:
            image = flip(image, mirror)
        depths = [disp_to_depth(d, 0.1, self.max_depth) for d in self.decoder(self.encoder(image))]
        return [flip(d, mirror) for d in depths] if mirror is not None else depths


# --------------------------------------------------------------------------- PoseNet


class ConvGNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(Conv2d(cin, cout, k, stride=2, padding=(k - 1) // 2), nn.GroupNorm(16, cout, eps=1e-5),
                         nn.ReLU())


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles [B,3] (x, y, z) → R = Rx·Ry·Rz [B,3,3]."""
    x, y, z = angle.unbind(1)
    o, l = torch.zeros_like(x), torch.ones_like(x)
    rz = torch.stack([z.cos(), -z.sin(), o, z.sin(), z.cos(), o, o, o, l], 1).reshape(-1, 3, 3)
    ry = torch.stack([y.cos(), o, y.sin(), o, l, o, -y.sin(), o, y.cos()], 1).reshape(-1, 3, 3)
    rx = torch.stack([l, o, o, o, x.cos(), -x.sin(), o, x.sin(), x.cos()], 1).reshape(-1, 3, 3)
    return rx @ ry @ rz


class PoseNet(nn.Module):
    """Seven stride-2 convolutions with GroupNorm on the target and its
    contexts, a 1×1 head, the spatial mean × 0.01: per context (t, r)."""

    def __init__(self, num_contexts: int):
        super().__init__()
        self.n = num_contexts
        cin = 3 * (1 + num_contexts)
        for i, (ch, k) in enumerate(zip((16, 32, 64, 128, 256, 256, 256), (7, 5, 3, 3, 3, 3, 3)), start=1):
            setattr(self, f"conv{i}", ConvGNReLU(cin, ch, k))
            cin = ch
        self.pose_pred = Conv2d(cin, 6 * num_contexts, 1)

    def forward(self, x):
        for i in range(1, 8):
            x = getattr(self, f"conv{i}")(x)
        vec = 0.01 * self.pose_pred(x).mean(dim=(2, 3)).reshape(x.shape[0], self.n, 6)
        return [(euler2mat(vec[:, j, 3:]), vec[:, j, :3, None]) for j in range(self.n)]  # (R [B,3,3], t [B,3,1])


# --------------------------------------------------------------------------- PackNet01


class PConv2D(nn.Module):
    """Convolution (zero pad k//2, bias) → GroupNorm(16) → ELU."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv_base = Conv2d(cin, cout, k, stride=stride, padding=k // 2)
        self.normalize = nn.GroupNorm(16, cout, eps=1e-5)

    def forward(self, x):
        return F.elu(self.normalize(self.conv_base(x)))


class ResidualConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = PConv2D(cin, cout, 3, stride)
        self.conv2 = PConv2D(cout, cout, 3)
        self.conv3 = Conv2d(cin, cout, 1, stride=stride)
        self.normalize = nn.GroupNorm(16, cout, eps=1e-5)

    def forward(self, x):
        return F.elu(self.normalize(self.conv2(self.conv1(x)) + self.conv3(x)))


def residual_block(cin: int, cout: int, n: int) -> nn.Sequential:
    return nn.Sequential(*[ResidualConv(cin if b == 0 else cout, cout, 1) for b in range(n)])


def conv3d_packed(conv3d: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The 3D convolution over the channel axis: [B,C,H,W] → [B,d·C,H,W], d-major."""
    B, C, H, W = x.shape
    return conv3d(x.unsqueeze(1)).reshape(B, conv3d.out_channels * C, H, W)


class PackLayerConv3d(nn.Module):
    def __init__(self, cin: int, k: int, r: int = 2, d: int = 8):
        super().__init__()
        self.r = r
        self.conv3d = Conv3d(1, d, 3, padding=1)
        self.conv = PConv2D(cin * r * r * d, cin, k)

    def forward(self, x):
        return self.conv(conv3d_packed(self.conv3d, F.pixel_unshuffle(x, self.r)))


class UnpackLayerConv3d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, r: int = 2, d: int = 8):
        super().__init__()
        self.r = r
        self.conv = PConv2D(cin, cout * r * r // d, k)
        self.conv3d = Conv3d(1, d, 3, padding=1)

    def forward(self, x):
        return F.pixel_shuffle(conv3d_packed(self.conv3d, self.conv(x)), self.r)


class InvDepth(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = Conv2d(cin, 1, 3, padding=1)

    def forward(self, x):
        return torch.sigmoid(self.conv1(x)) / 0.5


class PackNet01A(nn.Module):
    """PackNet01, version 1A (skips concatenated)."""

    def __init__(self, max_depth: float):
        super().__init__()
        self.max_depth = max_depth
        ni, n1, n2, n3, n4, n5 = 64, 64, 64, 128, 256, 512
        self.pre_calc = PConv2D(3, ni, 5)
        self.conv1 = PConv2D(ni, n1, 7)
        self.pack1 = PackLayerConv3d(n1, 5)
        self.conv2 = residual_block(n1, n2, 2)
        self.pack2 = PackLayerConv3d(n2, 3)
        self.conv3 = residual_block(n2, n3, 2)
        self.pack3 = PackLayerConv3d(n3, 3)
        self.conv4 = residual_block(n3, n4, 3)
        self.pack4 = PackLayerConv3d(n4, 3)
        self.conv5 = residual_block(n4, n5, 3)
        self.pack5 = PackLayerConv3d(n5, 3)
        self.unpack5 = UnpackLayerConv3d(n5, n5, 3)
        self.iconv5 = PConv2D(n5 + n4, n5, 3)
        self.unpack4 = UnpackLayerConv3d(n5, n4, 3)
        self.iconv4 = PConv2D(n4 + n3, n4, 3)
        self.unpack3 = UnpackLayerConv3d(n4, n3, 3)
        self.iconv3 = PConv2D(n3 + n2 + 1, n3, 3)
        self.unpack2 = UnpackLayerConv3d(n3, n2, 3)
        self.iconv2 = PConv2D(n2 + n1 + 1, n2, 3)
        self.unpack1 = UnpackLayerConv3d(n2, n1, 3)
        self.iconv1 = PConv2D(n1 + ni + 1, n1, 3)
        self.disp4_layer = InvDepth(n4)
        self.disp3_layer = InvDepth(n3)
        self.disp2_layer = InvDepth(n2)
        self.disp1_layer = InvDepth(n1)

    def forward(self, image, mirror: Optional[torch.Tensor]):
        if mirror is not None:
            image = flip(image, mirror)
        x = self.pre_calc(image)
        x1 = self.conv1(x)
        x1p = self.pack1(x1)
        x2p = self.pack2(self.conv2(x1p))
        x3p = self.pack3(self.conv3(x2p))
        x4p = self.pack4(self.conv4(x3p))
        x5p = self.pack5(self.conv5(x4p))
        i5 = self.iconv5(torch.cat([self.unpack5(x5p), x4p], 1))
        i4 = self.iconv4(torch.cat([self.unpack4(i5), x3p], 1))
        d4 = self.disp4_layer(i4)
        i3 = self.iconv3(torch.cat([self.unpack3(i4), x2p, up2(d4)], 1))
        d3 = self.disp3_layer(i3)
        i2 = self.iconv2(torch.cat([self.unpack2(i3), x1p, up2(d3)], 1))
        d2 = self.disp2_layer(i2)
        i1 = self.iconv1(torch.cat([self.unpack1(i2), x, up2(d2)], 1))
        d1 = self.disp1_layer(i1)
        depths = [disp_to_depth(d, 0.1, self.max_depth) for d in (d1, d2, d3, d4)]
        return [flip(d, mirror) for d in depths] if mirror is not None else depths
