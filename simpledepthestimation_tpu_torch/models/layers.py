"""Shared building blocks (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/layers.py``: disp_to_depth,
Conv3x3 with reflection padding, ELU ConvBlock, nearest upsample, and the
conv + GroupNorm + ReLU stack of the pose nets.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .norm_layers import Conv2d, GroupNorm


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid-style disparity → depth in [min_depth, max_depth]."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsample of NCHW."""
    B, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(B, C, H, 2, W, 2).reshape(B, C, H * 2, W * 2)


class Conv3x3(nn.Module):
    """3×3 conv with reflection padding. The input is cast to the compute dtype
    **before** the pad, so the pad moves half the bytes under bfloat16 and the
    values are those the convolution would see anyway."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv.compute_dtype)
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class ConvGNReLU(nn.Sequential):
    """Conv + GroupNorm(16, eps 1e-5, float32) + ReLU stack of the pose nets;
    index 0 is the conv and index 1 the norm, as checkpoints name them."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, compute_dtype: torch.dtype = torch.float32):
        super().__init__(
            Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                   padding=(kernel_size - 1) // 2, compute_dtype=compute_dtype),
            GroupNorm(16, out_channels, eps=1e-5),
            nn.ReLU(),
        )
