"""Depth-estimation losses as plain functions on NCHW tensors.

Counterpart of ``simpledepthestimation_tpu/models/losses.py`` (supervised,
SSIM, photometric and smoothness terms; the motion losses are not ported yet).
Boolean-mask indexing is a fixed-shape masked mean (an empty mask gives 0, not
NaN). Everything runs in float32.
"""

from __future__ import annotations

import torch

from ..ops.photometric import ssim_distance


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of x over positions where mask is True; 0 if mask is empty."""
    mask = mask.to(x.dtype)
    if dim is None:
        total, count = (x * mask).sum(), mask.sum()
    else:
        total, count = (x * mask).sum(dim=dim), mask.sum(dim=dim)
    return total / count.clamp_min(1.0)


def silog_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor, variance_focus: float = 0.85) -> torch.Tensor:
    """Scale-invariant log loss: mask = gt > 1; sqrt(E[d²] − vf·E[d]²) × 10
    with d = log(est) − log(gt)."""
    mask = depth_gt > 1.0
    safe_est = depth_est.clamp_min(1e-12)
    safe_gt = depth_gt.clamp_min(1e-12)
    d = torch.where(mask, torch.log(safe_est) - torch.log(safe_gt), torch.zeros_like(safe_est))
    mean_d2 = masked_mean(d * d, mask)
    mean_d = masked_mean(d, mask)
    return torch.sqrt((mean_d2 - variance_focus * mean_d**2).clamp_min(1e-12)) * 10.0


def variance_loss(depth: torch.Tensor) -> torch.Tensor:
    """Inverse relative-variance penalty (a plain mean of squares: no ddof)."""
    return 1.0 / ((depth / depth.mean() - 1.0) ** 2).mean()


def ssim(x: torch.Tensor, y: torch.Tensor, C1: float = 1e-4, C2: float = 9e-4) -> torch.Tensor:
    """SSIM *distance* in [0,1]: clamp((1 − ssim)/2, 0, 1), reflection pad 1 +
    3×3 average pool."""
    return ssim_distance(x, y, C1, C2)


def photometric_loss(
    real: torch.Tensor,
    synthesized: torch.Tensor,
    ssim_weight: float = 0.85,
    C1: float = 1e-4,
    C2: float = 9e-4,
    clip: float = 0.0,
) -> torch.Tensor:
    """α·SSIM + (1−α)·L1 per-pixel photometric error [B,1,H,W], composed from
    plain differentiable ops (the meta-architecture calls the fused
    ``ops.photometric.photometric_map`` instead)."""
    l1 = (synthesized - real).abs().mean(dim=1, keepdim=True)
    if ssim_weight > 0.0:
        s = ssim(synthesized, real, C1, C2).mean(dim=1, keepdim=True)
        loss = ssim_weight * s + (1.0 - ssim_weight) * l1
    else:
        loss = l1
    if clip > 0.0:
        # torch.std is unbiased by default: the ddof=1 of the JAX package
        loss = torch.minimum(loss, loss.mean() + clip * loss.std())
    return loss


def gradient_x(image: torch.Tensor, reversed: bool = False) -> torch.Tensor:
    """x-gradient of an NCHW image → [B,C,H,W-1]."""
    if reversed:
        return image[:, :, :, 1:] - image[:, :, :, :-1]
    return image[:, :, :, :-1] - image[:, :, :, 1:]


def gradient_y(image: torch.Tensor, reversed: bool = False) -> torch.Tensor:
    if reversed:
        return image[:, :, 1:, :] - image[:, :, :-1, :]
    return image[:, :, :-1, :] - image[:, :, 1:, :]


def smoothness_loss(depth: torch.Tensor, image: torch.Tensor, reversed: bool = False) -> torch.Tensor:
    """Edge-aware smoothness on mean-normalized inverse depth."""
    inv_depth = 1.0 / depth.clamp_min(1e-6)
    mean_inv = inv_depth.mean(dim=(2, 3), keepdim=True)
    inv_norm = inv_depth / mean_inv.clamp_min(1e-6)

    d_gx = gradient_x(inv_norm, reversed)
    d_gy = gradient_y(inv_norm, reversed)
    i_gx = gradient_x(image, reversed)
    i_gy = gradient_y(image, reversed)

    wx = torch.exp(-i_gx.abs().mean(dim=1, keepdim=True))
    wy = torch.exp(-i_gy.abs().mean(dim=1, keepdim=True))

    return (d_gx * wx).abs().mean() + (d_gy * wy).abs().mean()
