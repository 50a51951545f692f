"""Bilinear image resampling entry points (NCHW).

Counterpart of ``simpledepthestimation_tpu/ops/resample.py``: the same three
public functions with the same semantics (``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=True)``, every corner masked on its own).
All of them go through :func:`..ops.warp.warp_bilinear`, which launches the
CUDA kernel for CUDA tensors and takes the plain 4-gather version for CPU
tensors. There is no implementation switch: the JAX package's warp-backend
selector schedules its TPU kernels and has no counterpart here.
"""

from __future__ import annotations

import torch

from .warp import warp_bilinear


def resample_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``image [B,C,H,W]`` at pixel coords ``x, y [B,h,w]``."""
    return warp_bilinear(image, x, y)


def grid_sample_bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``F.grid_sample`` parity: normalized [-1,1] grid, align_corners=True,
    bilinear, zeros padding. image: [B,C,H,W]; grid: [B,h,w,2] of (x, y)."""
    H, W = image.shape[2:]
    x = (grid[..., 0] + 1.0) * (W - 1) / 2.0
    y = (grid[..., 1] + 1.0) * (H - 1) / 2.0
    return resample_bilinear(image, x.contiguous(), y.contiguous())


def resampler_with_unstacked_warp(
    image: torch.Tensor, warp_x: torch.Tensor, warp_y: torch.Tensor, safe: bool = True
) -> torch.Tensor:
    """TF-style resampler on unnormalized coords; identical math to
    :func:`resample_bilinear` (out-of-bounds corners are always zero-filled)."""
    del safe
    return resample_bilinear(image, warp_x, warp_y)
