"""Shared building blocks (NCHW).

Counterpart of ``simpledepthestimation_tpu/models/layers.py``: disp_to_depth,
Conv3x3 with reflection padding, ELU ConvBlock, nearest upsample, the
conv + GroupNorm + ReLU stack of the pose nets, and RandLayerNorm.
"""

from __future__ import annotations

from typing import Optional, Union

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
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class ConvGNReLU(nn.Sequential):
    """Conv + GroupNorm(16, eps 1e-5, float32) + ReLU stack of the pose nets;
    index 0 is the conv and index 1 the norm, as checkpoints name them.
    ``group_norm=False`` leaves the norm out (conv, ReLU): the output then stays
    in the compute dtype."""
    remat_unit = True  # TPU.REMAT recomputes it in the backward (parallel/train_step.py)

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, compute_dtype: torch.dtype = torch.float32,
                 group_norm: bool = True):
        conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                      padding=(kernel_size - 1) // 2, compute_dtype=compute_dtype)
        if group_norm:
            super().__init__(conv, GroupNorm(16, out_channels, eps=1e-5), nn.ReLU())
        else:
            super().__init__(conv, nn.ReLU())


def rand_layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    stddev: Union[float, torch.Tensor] = 0.0,
    noise_m: Optional[torch.Tensor] = None,
    noise_v: Optional[torch.Tensor] = None,
    eps: float = 1e-3,
) -> torch.Tensor:
    """Per-channel layer norm over H, W with multiplicatively noised statistics.

    x [B,C,H,W]; weight, bias [C]; noise_m, noise_v [B,C,1,1] standard
    normals, or None for no noise. The mean and the unbiased variance are
    computed in ``x``'s dtype and detached; with noise each is scaled by
    ``1 + fmod(noise·stddev, max(2·stddev, tiny))`` in float32 (``tiny`` of
    ``x``'s dtype, so that stddev 0 gives exactly 1, not ``fmod(0, 0)``).
    As in the JAX module the result is float32 (the float32 ``weight``
    promotes it), and under bfloat16 input without noise the normalisation
    itself runs in bfloat16."""
    mean = x.mean(dim=(2, 3), keepdim=True).detach()
    var = x.var(dim=(2, 3), keepdim=True, correction=1).detach()
    if noise_m is not None:
        stddev = torch.as_tensor(stddev, dtype=torch.float32, device=x.device)
        two_sig = torch.clamp_min(stddev * 2.0, torch.finfo(x.dtype).tiny)
        mean = mean.float() * (1.0 + torch.fmod(noise_m.float() * stddev, two_sig))
        var = var.float() * (1.0 + torch.fmod(noise_v.float() * stddev, two_sig))
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * weight[:, None, None] + bias[:, None, None]


class RandLayerNorm(nn.Module):
    """:func:`rand_layer_norm` with parameters ``weight`` (ones) and ``bias``
    (zeros) of ``channels``. The noise is drawn only when ``train`` is true and
    a ``generator`` is given (on ``x``'s device): normals of ``x``'s dtype,
    first for the mean, then for the variance. Nothing is drawn from the
    global random state."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.param_init = {"weight": 1.0, "bias": 0.0}

    def forward(self, x: torch.Tensor, train: bool = False, stddev: Union[float, torch.Tensor] = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise_m = noise_v = None
        if train and generator is not None:
            shape = (x.shape[0], x.shape[1], 1, 1)
            noise_m = torch.randn(shape, generator=generator, device=x.device).to(x.dtype)
            noise_v = torch.randn(shape, generator=generator, device=x.device).to(x.dtype)
        return rand_layer_norm(x, self.weight, self.bias, stddev, noise_m, noise_v, self.eps)
