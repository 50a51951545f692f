"""PackNet-01: self-supervised depth net with 3D packing and unpacking blocks (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/packnet.py``:

- packing is a space-to-depth ×r (``F.pixel_unshuffle``) and unpacking a
  depth-to-space ×r (``F.pixel_shuffle``); in NCHW their channel index
  ``c·r² + i·r + j`` is the JAX functions' own;
- the 3D convolution over the packed channels is ``Conv3d(1, 8, 3)`` on
  ``[B,1,C,H,W]`` (cuDNN): the packed channels are its depth axis, and its
  8 outputs fold back into channels d-major (channel ``d·C + c``), the fold
  the original code's ``view(b, c·d, h, w)`` makes and that both the unpack
  layer's ``pixel_shuffle`` and the checkpoints' weights rely on;
- every 2D convolution is followed by GroupNorm(16, eps 1e-5) in float32 and
  ELU, so the blocks hand float32 to the next convolution, which rounds it to
  the compute dtype.

Versions ``1A`` (skips concatenated) and ``1B`` (skips added). Four depth maps
from ``disp_to_depth(sigmoid/0.5, 0.1, MAX_DEPTH)``, index 0 at full
resolution. H and W must be multiples of 32 (five packs).

Parameter names are the original code's (``pre_calc``, ``conv{i}``,
``pack{i}.conv3d``, ``pack{i}.conv.conv_base`` / ``.normalize``,
``conv{i}.{b}.conv1..3`` / ``.normalize``, ``unpack{i}``, ``iconv{i}``,
``disp{i}_layer.conv1``), so the JAX package's ``convert_packnet`` reads
``state_dict()`` as it stands. The TPU-only blocked formulation of the 3D
convolution (``TPU.CONV3D_IMPL``, ``TPU.CONV3D_BLOCK``) has no counterpart.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .build import DEPTH_NET_REGISTRY, compute_dtype
from .depth_nets import flip_images
from .layers import disp_to_depth, upsample_nearest_2x
from .norm_layers import Conv2d, Conv3d, GroupNorm
from ..geometry.camera import resize_img


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B,C,H,W] → [B,C·r²,H/r,W/r]."""
    return F.pixel_unshuffle(x, r)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[B,C·r²,H,W] → [B,C,rH,rW]."""
    return F.pixel_shuffle(x, r)


def conv3d_over_packed(conv3d: Conv3d, x: torch.Tensor) -> torch.Tensor:
    """The 3D convolution with the channel axis as depth: [B,C,H,W] → [B,d·C,H,W],
    d-major."""
    B, C, H, W = x.shape
    return conv3d(x.unsqueeze(1)).reshape(B, conv3d.out_channels * C, H, W)


class Conv2D(nn.Module):
    """Conv (zero pad k//2, bias, Xavier) → GroupNorm(16) in float32 → ELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_base = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                                padding=kernel_size // 2, compute_dtype=compute_dtype, xavier=True)
        self.normalize = GroupNorm(16, out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.normalize(self.conv_base(x)))


class DecoderConv2D(Conv2D):
    """The decoder's ``iconv`` stages: a :class:`Conv2D` that ``TPU.REMAT`` recomputes."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)


class ResidualConv(nn.Module):
    """Two Conv2D and a strided 1×1 shortcut; GroupNorm + ELU on their sum
    (float32: the sum of the float32 branch and the compute-dtype shortcut)."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.conv1 = Conv2D(in_channels, out_channels, 3, stride, dt)
        self.conv2 = Conv2D(out_channels, out_channels, 3, 1, dt)
        self.conv3 = Conv2d(in_channels, out_channels, 1, stride=stride, compute_dtype=dt, xavier=True)
        self.normalize = GroupNorm(16, out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.normalize(self.conv2(self.conv1(x)) + self.conv3(x)))


class ResidualBlock(nn.Sequential):
    """``num_blocks`` ResidualConvs, the first with ``stride``; indexed ``.{b}``."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(*[
            ResidualConv(in_channels if b == 0 else out_channels, out_channels, stride if b == 0 else 1,
                         compute_dtype)
            for b in range(num_blocks)])


class InvDepth(nn.Module):
    """3×3 conv (zero pad, compute dtype) → sigmoid in float32 / ``min_depth``."""

    def __init__(self, in_channels: int, min_depth: float = 0.5, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.min_depth = min_depth
        self.conv1 = Conv2d(in_channels, 1, 3, padding=1, compute_dtype=compute_dtype, xavier=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.conv1(x).float()) / self.min_depth


class PackLayerConv3d(nn.Module):
    """space-to-depth ×r → 3D conv over the packed channels (×d) → Conv2D back
    to ``in_channels``."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_channels: int, kernel_size: int, r: int = 2, d: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.r = r
        self.conv3d = Conv3d(1, d, 3, padding=1, compute_dtype=compute_dtype, xavier=True)
        self.conv = Conv2D(in_channels * r * r * d, in_channels, kernel_size, 1, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(conv3d_over_packed(self.conv3d, space_to_depth(x, self.r)))


class UnpackLayerConv3d(nn.Module):
    """Conv2D to ``out_channels·r²/d`` → 3D conv (×d) → depth-to-space ×r. The
    output stays in the compute dtype."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, r: int = 2, d: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.r = r
        self.conv = Conv2D(in_channels, out_channels * r * r // d, kernel_size, 1, compute_dtype)
        self.conv3d = Conv3d(1, d, 3, padding=1, compute_dtype=compute_dtype, xavier=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return depth_to_space(conv3d_over_packed(self.conv3d, self.conv(x)), self.r)


@DEPTH_NET_REGISTRY.register()
class PackNet01(nn.Module):
    def __init__(self, version: str = "A", max_depth: float = 80.0, upsample_depth: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if version not in ("A", "B"):
            raise ValueError(f"Unknown PackNet version {version}")
        self.version = version
        self.max_depth = max_depth
        self.upsample_depth = upsample_depth
        self.compute_dtype = dt = compute_dtype

        ni, no = 64, 1
        n1, n2, n3, n4, n5 = 64, 64, 128, 256, 512
        num_blocks = (2, 2, 3, 3)
        pack_kernel = (5, 3, 3, 3, 3)
        unpack_kernel = (3, 3, 3, 3, 3)
        if version == "A":  # skips concatenated
            n1o, n1i = n1, n1 + ni + no
            n2o, n2i = n2, n2 + n1 + no
            n3o, n3i = n3, n3 + n2 + no
            n4o, n4i = n4, n4 + n3
            n5o, n5i = n5, n5 + n4
        else:  # skips added
            n1o, n1i = n1, n1 + no
            n2o, n2i = n2, n2 + no
            n3o, n3i = n3 // 2, n3 // 2 + no
            n4o, n4i = n4 // 2, n4 // 2
            n5o, n5i = n5 // 2, n5 // 2

        self.pre_calc = Conv2D(3, ni, 5, 1, dt)
        self.conv1 = Conv2D(ni, n1, 7, 1, dt)
        self.pack1 = PackLayerConv3d(n1, pack_kernel[0], compute_dtype=dt)
        self.conv2 = ResidualBlock(n1, n2, num_blocks[0], 1, dt)
        self.pack2 = PackLayerConv3d(n2, pack_kernel[1], compute_dtype=dt)
        self.conv3 = ResidualBlock(n2, n3, num_blocks[1], 1, dt)
        self.pack3 = PackLayerConv3d(n3, pack_kernel[2], compute_dtype=dt)
        self.conv4 = ResidualBlock(n3, n4, num_blocks[2], 1, dt)
        self.pack4 = PackLayerConv3d(n4, pack_kernel[3], compute_dtype=dt)
        self.conv5 = ResidualBlock(n4, n5, num_blocks[3], 1, dt)
        self.pack5 = PackLayerConv3d(n5, pack_kernel[4], compute_dtype=dt)

        self.unpack5 = UnpackLayerConv3d(n5, n5o, unpack_kernel[0], compute_dtype=dt)
        self.iconv5 = DecoderConv2D(n5i, n5, 3, 1, dt)
        self.unpack4 = UnpackLayerConv3d(n5, n4o, unpack_kernel[1], compute_dtype=dt)
        self.iconv4 = DecoderConv2D(n4i, n4, 3, 1, dt)
        self.unpack3 = UnpackLayerConv3d(n4, n3o, unpack_kernel[2], compute_dtype=dt)
        self.iconv3 = DecoderConv2D(n3i, n3, 3, 1, dt)
        self.unpack2 = UnpackLayerConv3d(n3, n2o, unpack_kernel[3], compute_dtype=dt)
        self.iconv2 = DecoderConv2D(n2i, n2, 3, 1, dt)
        self.unpack1 = UnpackLayerConv3d(n2, n1o, unpack_kernel[4], compute_dtype=dt)
        self.iconv1 = DecoderConv2D(n1i, n1, 3, 1, dt)

        self.disp4_layer = InvDepth(n4, compute_dtype=dt)
        self.disp3_layer = InvDepth(n3, compute_dtype=dt)
        self.disp2_layer = InvDepth(n2, compute_dtype=dt)
        self.disp1_layer = InvDepth(n1, compute_dtype=dt)

    @classmethod
    def from_cfg(cls, cfg):
        return cls(
            version=str(cfg.MODEL.DEPTH_NET.get("VERSION", "1A"))[1:],
            max_depth=float(cfg.MODEL.MAX_DEPTH),
            upsample_depth=bool(cfg.MODEL.DEPTH_NET.get("UPSAMPLE_DEPTH", False)),
            compute_dtype=compute_dtype(cfg),
        )

    def _merge(self, unpacked: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        # unpacked is in the compute dtype, skip is a float32 GroupNorm output: both the
        # concatenation and the sum promote to float32, as jnp's do
        return torch.cat([unpacked, skip], dim=1) if self.version == "A" else unpacked + skip

    def _with_disp(self, merged: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        # the upsampled disparity is rounded to the compute dtype, then promoted with the
        # float32 merge, as the JAX module's ``udisp.astype(dtype)`` in ``jnp.concatenate``
        return torch.cat([merged, upsample_nearest_2x(disp).to(self.compute_dtype)], dim=1)

    def forward(self, image: torch.Tensor, flip: Optional[torch.Tensor] = None, train: bool = False,
                intrinsics: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """image [B,3,H,W] normalized, H and W multiples of 32 → four float32 depth
        maps [B,1,H/2^s,W/2^s], s = 0..3. ``train`` and ``intrinsics`` are accepted
        for interface uniformity and ignored (GroupNorm has no running statistics)."""
        H, W = image.shape[2:]
        if H % 32 or W % 32:
            raise ValueError(f"PackNet01 needs H and W that are multiples of 32 (five packs); got {H}x{W}")
        if flip is not None:
            image = flip_images(image, flip)

        x = self.pre_calc(image)
        x1 = self.conv1(x)
        x1p = self.pack1(x1)
        x2p = self.pack2(self.conv2(x1p))
        x3p = self.pack3(self.conv3(x2p))
        x4p = self.pack4(self.conv4(x3p))
        x5p = self.pack5(self.conv5(x4p))

        iconv5 = self.iconv5(self._merge(self.unpack5(x5p), x4p))
        iconv4 = self.iconv4(self._merge(self.unpack4(iconv5), x3p))
        disp4 = self.disp4_layer(iconv4)
        iconv3 = self.iconv3(self._with_disp(self._merge(self.unpack3(iconv4), x2p), disp4))
        disp3 = self.disp3_layer(iconv3)
        iconv2 = self.iconv2(self._with_disp(self._merge(self.unpack2(iconv3), x1p), disp3))
        disp2 = self.disp2_layer(iconv2)
        iconv1 = self.iconv1(self._with_disp(self._merge(self.unpack1(iconv2), x), disp2))
        disp1 = self.disp1_layer(iconv1)

        depths = [disp_to_depth(d, min_depth=0.1, max_depth=self.max_depth)[1] for d in (disp1, disp2, disp3, disp4)]
        if flip is not None:
            depths = [flip_images(d, flip) for d in depths]
        if self.upsample_depth:
            depths = [resize_img(d, image.shape[2:], mode="nearest") for d in depths]
        return depths
