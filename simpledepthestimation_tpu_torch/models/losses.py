"""Depth-estimation losses as plain functions on NCHW tensors.

Counterpart of ``simpledepthestimation_tpu/models/losses.py``: supervised,
SSIM (plain and proximity-weighted), photometric, smoothness and the motion
terms (cycle consistency, motion smoothness, L0.5 sparsity). Boolean-mask
indexing is a fixed-shape masked mean (an empty mask gives 0, not NaN).
Everything runs in float32.

Every reduction over the batch is global in a run of several processes: the
mean over the global batch, through ``parallel.mesh`` (its module docstring
states the rule). Per-sample reductions (over H, W or channels) stay on the
rank. Without a process group each is the plain expression it was.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.pose import matmul3
from ..ops.photometric import ssim_distance
from ..ops.pool import avg_pool_3x3_reflect, avg_pool_3x3_same
from ..ops.resample import resample_bilinear_image_grad
from ..parallel import mesh


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of x over positions where mask is True; 0 if mask is empty. Over
    the global batch where ``dim`` is None."""
    if dim is None:
        return mesh.global_masked_means([x], mask)[0]
    mask = mask.to(x.dtype)
    total, count = (x * mask).sum(dim=dim), mask.sum(dim=dim)
    return total / count.clamp_min(1.0)


def silog_loss(depth_est: torch.Tensor, depth_gt: torch.Tensor, variance_focus: float = 0.85) -> torch.Tensor:
    """Scale-invariant log loss: mask = gt > 1; sqrt(E[d²] − vf·E[d]²) × 10
    with d = log(est) − log(gt)."""
    mask = depth_gt > 1.0
    safe_est = depth_est.clamp_min(1e-12)
    safe_gt = depth_gt.clamp_min(1e-12)
    d = torch.where(mask, torch.log(safe_est) - torch.log(safe_gt), torch.zeros_like(safe_est))
    mean_d2, mean_d = mesh.global_masked_means([d * d, d], mask)
    return torch.sqrt((mean_d2 - variance_focus * mean_d**2).clamp_min(1e-12)) * 10.0


def variance_loss(depth: torch.Tensor) -> torch.Tensor:
    """Inverse relative-variance penalty (a plain mean of squares: no ddof)."""
    return 1.0 / mesh.global_mean((depth / mesh.global_mean(depth) - 1.0) ** 2)


def ssim(x: torch.Tensor, y: torch.Tensor, C1: float = 1e-4, C2: float = 9e-4) -> torch.Tensor:
    """SSIM *distance* in [0,1]: clamp((1 − ssim)/2, 0, 1), reflection pad 1 +
    3×3 average pool."""
    return ssim_distance(x, y, C1, C2)


def weighted_ssim(
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, C1: float = 1e-4, C2: float = 9e-4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proximity-weighted SSIM distance of ``x, y`` [B,C,H,W] under weights
    ``w`` [B,1,H,W]: weighted 3×3 reflect-padded means, ``C1 = inf`` keeps the
    structure term only, ``C2 = inf`` the mean term only. Returns
    (distance [B,C,H,W] in [0,1], average weight [B,1,H,W])."""
    avg_w = avg_pool_3x3_same(w)
    w_eps = w + 1e-2
    inv_avg_w = 1.0 / (avg_w + 1e-2)

    def wpool(v):
        return avg_pool_3x3_reflect(v * w_eps) * inv_avg_w

    mu_x = wpool(x)
    mu_y = wpool(y)
    sigma_x = wpool(x * x) - mu_x**2
    sigma_y = wpool(y * y) - mu_y**2
    sigma_xy = wpool(x * y) - mu_x * mu_y

    if C1 == float("inf"):
        ssim_n = 2 * sigma_xy + C2
        ssim_d = sigma_x + sigma_y + C2
    elif C2 == float("inf"):
        ssim_n = 2 * mu_x * mu_y + C1
        ssim_d = mu_x**2 + mu_y**2 + C1
    else:
        ssim_n = (2 * sigma_xy + C2) * (2 * mu_x * mu_y + C1)
        ssim_d = (sigma_x + sigma_y + C2) * (mu_x**2 + mu_y**2 + C1)
    return torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0), avg_w


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
        mean, std = mesh.global_mean_std(loss)
        loss = torch.minimum(loss, mean + clip * std)
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

    mean_x, mean_y = mesh.global_means([(d_gx * wx).abs(), (d_gy * wy).abs()])
    return mean_x + mean_y


def motion_consistency_loss(
    coords_A_in_B: torch.Tensor,
    mask: torch.Tensor,
    R_A2B: torch.Tensor,
    R_B2A: torch.Tensor,
    t_A2B: torch.Tensor,
    t_B2A: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic rotation and translation consistency.

    coords_A_in_B [B,H,W,2] normalized warp coordinates (detached here);
    mask [B,1,H,W]; R_* [B,3,3]; t_* [B,3,H,W] dense translation fields. The
    reverse field is sampled at the forward warp's coordinates with its
    gradient flowing into ``t_B2A`` only (the warp's image-gradient kernel on
    CUDA). Returns (rotation error, translation error)."""
    B, _, H, W = t_A2B.shape
    coords = coords_A_in_B.detach()
    xs = ((coords[..., 0] + 1.0) * (W - 1.0) / 2.0).contiguous()
    ys = ((coords[..., 1] + 1.0) * (H - 1.0) / 2.0).contiguous()
    sampled_t_B2A = resample_bilinear_image_grad(t_B2A.contiguous(), xs, ys)

    R2R1 = matmul3(R_A2B, R_B2A)
    # rotate the sampled reverse translation into frame B: R_A2B @ t per pixel
    rot_t = matmul3(R_A2B, sampled_t_B2A.reshape(B, 3, H * W)).reshape(B, 3, H, W)
    trans_zero = rot_t + t_A2B  # ~0 under cycle consistency

    eye = torch.eye(3, dtype=R_A2B.dtype, device=R_A2B.device)[None]
    rot_error = ((R2R1 - eye) ** 2).mean(dim=(1, 2))
    rot1_scale = ((R_A2B - eye) ** 2).mean(dim=(1, 2))
    rot2_scale = ((R_B2A - eye) ** 2).mean(dim=(1, 2))
    rot_error = rot_error / (rot1_scale + rot2_scale + 1e-24)

    trans_error = (trans_zero**2).sum(dim=1)  # [B,H,W]
    trans1_scale = (t_A2B**2).sum(dim=1)
    trans2_scale = (sampled_t_B2A**2).sum(dim=1)
    trans_error = trans_error / (trans1_scale + trans2_scale + 1e-24)
    rot_mean, trans_mean = mesh.global_means([rot_error, mask[:, 0] * trans_error])
    return rot_mean, trans_mean


def motion_smoothness_loss(motion_field: torch.Tensor) -> torch.Tensor:
    """Mean of sqrt(1e-24 + gx² + gy²) over the forward differences of a
    [B,3,H,W] field (both cut to [B,3,H-1,W-1]); finite gradients at zero
    motion."""
    gx = gradient_x(motion_field, reversed=True)[:, :, 1:, :]
    gy = gradient_y(motion_field, reversed=True)[:, :, :, 1:]
    return mesh.global_mean(torch.sqrt(1e-24 + gx**2 + gy**2))


def motion_sparsity_loss(motion_map: torch.Tensor) -> torch.Tensor:
    """L0.5 sparsity of a [B,3,H,W] field normalized by its detached
    per-sample, per-channel mean magnitude."""
    abs_motion = motion_map.abs()
    mean_abs = abs_motion.mean(dim=(2, 3), keepdim=True).detach()
    return mesh.global_mean(2.0 * mean_abs * torch.sqrt(abs_motion / (mean_abs + 1e-24) + 1.0))
