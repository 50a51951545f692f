"""Bilinear image resampling entry points (NCHW).

Counterpart of ``simpledepthestimation_tpu/ops/resample.py``: the same four
public functions with the same semantics (``F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=True)``, every corner masked on its own).
All of them go through :func:`..ops.warp.warp_bilinear`, which launches the
CUDA kernel for CUDA tensors and takes the plain 4-gather version for CPU
tensors. There is no implementation switch: the JAX package's warp-backend
selector schedules its TPU kernels and has no counterpart here, nor has its
``const_image_warps`` scope: the warp's ``torch.autograd.Function`` computes
the image gradient only where the image requires one, so a detached operand
already costs no scatter.
"""

from __future__ import annotations

import torch

from .warp import warp_bilinear


def resample_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``image [B,C,H,W]`` at pixel coords ``x, y [B,h,w]``."""
    return warp_bilinear(image, x, y)


def resample_bilinear_image_grad(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample whose gradient flows into ``image`` only: the
    coordinates are detached (MotionLearning's cycle loss warps the reverse
    translation field at the forward warp's coordinates). The image gradient
    is the scatter-add kernel on CUDA, its plain version on the CPU."""
    return warp_bilinear(image, x.detach(), y.detach())


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
