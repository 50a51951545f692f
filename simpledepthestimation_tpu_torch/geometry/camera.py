"""Differentiable pinhole-camera geometry in NCHW torch.

Counterpart of ``simpledepthestimation_tpu/geometry/camera.py``. Functional,
float32, NCHW: images ``[B,C,H,W]``, depth ``[B,1,H,W]``, pixel coordinates
``[B,H,W,2]`` (x, y) as the JAX package returns them.

The [3,3]×[3,HW] projection products are written as broadcast multiply-adds
(:func:`..geometry.pose.matmul3`), not as matmuls: the K·K⁻¹ round trip
cancels catastrophically (fx·px + cx·z with fx·px ≈ −cx·z), so anything less
than full float32 costs a visible fraction of a pixel. Written this way no
TF32 flag, matmul-precision setting or autocast scope can reach them; inputs
are cast to float32 on entry.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.resample import grid_sample_bilinear, resampler_with_unstacked_warp
from .pose import matmul3


def scale_intrinsics(K: torch.Tensor, x_scale: float, y_scale: float) -> torch.Tensor:
    """Scale fx/cx by x_scale and fy/cy by y_scale. Returns a new K."""
    scale = torch.tensor(
        [[x_scale, 1.0, x_scale], [1.0, y_scale, y_scale], [1.0, 1.0, 1.0]],
        dtype=K.dtype, device=K.device,
    )
    return K * scale


def inv_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a pinhole K [B,3,3]."""
    fx, fy = K[:, 0, 0], K[:, 1, 1]
    cx, cy = K[:, 0, 2], K[:, 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, zeros, -cx / fx], dim=-1)
    row1 = torch.stack([zeros, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=1)


def resize_img(image: torch.Tensor, dst_hw: Tuple[int, int], mode: str = "bilinear") -> torch.Tensor:
    """Resize an NCHW image with ``F.interpolate`` semantics: align_corners=True
    for bilinear, plain nearest (floor of the scaled index) otherwise. Written
    as explicit index-and-lerp so that it equals the JAX package's version
    term by term."""
    H, W = image.shape[2], image.shape[3]
    dh, dw = dst_hw
    if H == dh and W == dw:
        return image
    dev = image.device
    if mode == "nearest":
        ys = torch.floor(torch.arange(dh, device=dev) * (H / dh)).long()
        xs = torch.floor(torch.arange(dw, device=dev) * (W / dw)).long()
        return image.index_select(2, ys).index_select(3, xs)
    if mode == "bilinear":
        ys = torch.linspace(0.0, H - 1.0, dh, device=dev)
        xs = torch.linspace(0.0, W - 1.0, dw, device=dev)
        y0 = torch.floor(ys).long().clamp(0, H - 1)
        y1 = (y0 + 1).clamp(0, H - 1)
        x0 = torch.floor(xs).long().clamp(0, W - 1)
        x1 = (x0 + 1).clamp(0, W - 1)
        wy = (ys - y0).to(image.dtype)[None, None, :, None]
        wx = (xs - x0).to(image.dtype)[None, None, None, :]
        rows0 = image.index_select(2, y0)
        rows1 = image.index_select(2, y1)
        top = rows0.index_select(3, x0) * (1 - wx) + rows0.index_select(3, x1) * wx
        bot = rows1.index_select(3, x0) * (1 - wx) + rows1.index_select(3, x1) * wx
        return top * (1 - wy) + bot * wy
    raise ValueError(f"Unknown resize mode {mode}")


def resize_img_avgpool(image: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """Adaptive average-pool resize; integer factors only."""
    B, C, H, W = image.shape
    dh, dw = dst_hw
    if H == dh and W == dw:
        return image
    if H % dh or W % dw:
        raise ValueError("avgpool resize needs integer factors")
    return image.reshape(B, C, dh, H // dh, dw, W // dw).mean(dim=(3, 5))


def image_grid(H: int, W: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid [3, H, W] of (x, y, 1)."""
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=dtype, device=device),
        torch.arange(W, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=0)


def img_to_points(depth: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Backproject depth [B,1,H,W] through R [B,3,3], t [B,3,1] → points [B,3,H*W]."""
    B, _, H, W = depth.shape
    depth = depth.float()
    grid = image_grid(H, W, depth.dtype, depth.device).reshape(3, H * W)
    pts = grid[None] * depth.reshape(B, 1, H * W)
    return matmul3(R.float(), pts) + t.float()


def points_to_img(
    points: torch.Tensor, R: torch.Tensor, t: torch.Tensor, H: int, W: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project points [B,3,HW] with R [B,3,3], t [B,3,HW or 1] to pixel coords.

    Returns (coords [B,H,W,2] xy, depth [B,1,H,W], valid mask [B,1,H,W]):
    z-divide with +1e-6, validity = finite & 0<=X<W-1 & 0<=Y<H-1 & Z>0,
    Z clamped at 1e-5.
    """
    B = points.shape[0]
    proj = matmul3(R.float(), points.float()) + t.float()
    X = proj[:, 0] / (proj[:, 2] + 1e-6)
    Y = proj[:, 1] / (proj[:, 2] + 1e-6)
    Z = proj[:, 2]

    valid = (
        torch.isfinite(X) & (X >= 0) & (X < W - 1)
        & torch.isfinite(Y) & (Y >= 0) & (Y < H - 1)
        & (Z > 0)
    )
    Z = Z.clamp_min(1e-5)

    coords = torch.stack([X, Y], dim=-1).reshape(B, H, W, 2)
    return coords, Z.reshape(B, 1, H, W), valid.reshape(B, 1, H, W)


def _project(depth_A, intrinsics, R_A_to_B, t_A_to_B):
    """Shared projection of both view-synthesis variants → clipped pixel coords."""
    B, _, H, W = depth_A.shape
    intrinsics = intrinsics.float()
    zero_t = torch.zeros((B, 3, 1), dtype=torch.float32, device=depth_A.device)
    points_A = img_to_points(depth_A, R=inv_intrinsics(intrinsics), t=zero_t)

    R = matmul3(intrinsics, R_A_to_B.float())
    if t_A_to_B.dim() == 4:  # dense motion field [B,3,H,W]
        t_flat = t_A_to_B.reshape(B, 3, H * W)
    else:  # rigid [B,3,1]
        t_flat = t_A_to_B.reshape(B, 3, 1)
    t = matmul3(intrinsics, t_flat.float())

    coords, depth_in_B, valid = points_to_img(points_A, R, t, H, W)
    Xs = torch.nan_to_num(coords[..., 0]).clamp(0.0, W - 1.0)
    Ys = torch.nan_to_num(coords[..., 1]).clamp(0.0, H - 1.0)
    return Xs, Ys, depth_in_B, valid


def view_synthesis(
    image_B: torch.Tensor,
    depth_A: torch.Tensor,
    intrinsics: torch.Tensor,
    R_A_to_B: torch.Tensor,
    t_A_to_B: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Warp image_B into frame A via depth_A and the relative pose.

    image_B: [B,C,H,W]; depth_A: [B,1,H,W]; intrinsics: [B,3,3];
    R_A_to_B: [B,3,3]; t_A_to_B: [B,3,1] rigid or [B,3,H,W] dense motion.

    Returns (sampled_B [B,C,H,W], depth_in_B [B,1,H,W],
    normalized coords [B,H,W,2], valid mask [B,1,H,W]).
    """
    H, W = image_B.shape[2:]
    Xs, Ys, depth_in_B, valid = _project(depth_A, intrinsics, R_A_to_B, t_A_to_B)
    # normalized [-1, 1] coords (align_corners=True convention)
    Xn = 2.0 * Xs / (W - 1.0) - 1.0
    Yn = 2.0 * Ys / (H - 1.0) - 1.0
    norm_coords = torch.stack([Xn, Yn], dim=-1)
    sampled_B = grid_sample_bilinear(image_B, norm_coords)
    return sampled_B, depth_in_B, norm_coords, valid


def view_synthesis_v2(
    image_B: torch.Tensor,
    depth_A: torch.Tensor,
    intrinsics: torch.Tensor,
    R_A_to_B: torch.Tensor,
    t_A_to_B: torch.Tensor,
):
    """Variant that samples on raw pixel coordinates; same projection as
    :func:`view_synthesis`. Returns pixel coords [B,H,W,2] in third place."""
    Xs, Ys, depth_in_B, valid = _project(depth_A, intrinsics, R_A_to_B, t_A_to_B)
    sampled_B = resampler_with_unstacked_warp(image_B, Xs.contiguous(), Ys.contiguous())
    return sampled_B, depth_in_B, torch.stack([Xs, Ys], -1), valid
