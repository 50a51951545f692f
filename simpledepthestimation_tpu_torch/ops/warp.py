"""Bilinear warp at per-pixel float coordinates: kernel wrappers + plain versions.

``warp_bilinear`` is a ``torch.autograd.Function`` around the hand-written CUDA
kernels of ``csrc/warp.cu``: the forward sample, the backward that yields the
coordinate cotangents ``dx, dy`` (the gradient that trains depth and pose), and
the backward that yields the image cotangent (a bilinear scatter-add: what the
MotionLearning cycle loss sends into the warped translation field). Beside each
kernel stands the same function in plain PyTorch: ``warp_bilinear_plain``
(four gathers, the counterpart of ``_resample_bilinear_4gather`` in
``simpledepthestimation_tpu/ops/resample.py``), ``warp_coord_grad_plain`` (the
explicit derivative of the bilinear weights) and ``warp_image_grad_plain`` (four
``scatter_add_``). The wrappers take the plain versions only for CPU tensors;
for CUDA tensors they launch the kernels or raise.

Semantics (all): ``out[b,c,i,j]`` is the bilinear sample of ``image[b,c]`` at
``(x[b,i,j], y[b,i,j])`` in pixel units; each of the four corners that lies
outside the image contributes zero (``F.grid_sample`` with
``padding_mode="zeros", align_corners=True``). ``x == W-1`` gives a right
corner at ``W`` that is masked and has weight 0. A huge finite coordinate is
fully outside (zero output); a non-finite one gives NaN. The coordinate
gradient is the almost-everywhere derivative (``floor`` has gradient zero):

    dx[b,i,j] = Σ_c ct[b,c,i,j] · [(v01 − v00)(1 − wy) + (v11 − v10)·wy]
    dy[b,i,j] = Σ_c ct[b,c,i,j] · [(v10 − v00)(1 − wx) + (v11 − v01)·wx]

with ``v..`` the four (masked) corner values and ``wx, wy`` the fractions. The
image gradient adds ``ct[b,c,i,j]`` times each corner's weight
(``(1−wx)(1−wy)``, ``wx(1−wy)``, ``(1−wx)wy``, ``wx·wy``) into that corner.
On CUDA it is summed with float32 atomics, so its last bits vary from run to
run (as ``F.grid_sample``'s input gradient does).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib


def _corner_index(ix: torch.Tensor, iy: torch.Tensor, H: int, W: int):
    """Flat index into a plane (clamped, so always valid) and in-image mask of
    the integer corner ``(ix, iy) [B,N]``."""
    inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
    return iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1), inb


def _floors_and_fractions(x: torch.Tensor, y: torch.Tensor, H: int, W: int):
    """Top-left corner ``x0i, y0i [B,N]`` (int64) and fractions ``wx, wy
    [B,1,N]`` of the coordinates ``x, y [B,...]`` into an ``H×W`` plane."""
    B = x.shape[0]
    x = x.reshape(B, -1).float()
    y = y.reshape(B, -1).float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None, :]
    wy = (y - y0)[:, None, :]
    # clamp while still float so that huge coordinates stay "outside"
    return x0.clamp(-2, W).long(), y0.clamp(-2, H).long(), wx, wy


def _corner(flat: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Gather ``flat [B,C,H*W]`` at integer ``(ix, iy) [B,N]``; zero outside."""
    idx, inb = _corner_index(ix, iy, H, W)
    vals = torch.gather(flat, 2, idx[:, None, :].expand(-1, flat.shape[1], -1))
    return vals * inb[:, None, :].to(flat.dtype)


def _corners_and_fractions(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The four masked corner values ``[B,C,N]`` (float32) and ``wx, wy [B,1,N]``."""
    B, C, H, W = image.shape
    x0i, y0i, wx, wy = _floors_and_fractions(x, y, H, W)
    flat = image.reshape(B, C, H * W).float()
    v00 = _corner(flat, x0i, y0i, H, W)
    v01 = _corner(flat, x0i + 1, y0i, H, W)
    v10 = _corner(flat, x0i, y0i + 1, H, W)
    v11 = _corner(flat, x0i + 1, y0i + 1, H, W)
    return v00, v01, v10, v11, wx, wy


def warp_bilinear_plain(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (4 gathers). image [B,C,H,W]; x, y [B,h,w] float.

    Computes in float32 and returns ``image.dtype``. Differentiable by autograd
    in the image (scatter-add) and in the coordinates (bilinear weights)."""
    v00, v01, v10, v11, wx, wy = _corners_and_fractions(image, x, y)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(image.shape[0], image.shape[1], *x.shape[1:]).to(image.dtype)


def warp_coord_grad_plain(
    image: torch.Tensor, x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the coordinate cotangents.

    image [B,C,H,W]; x, y [B,h,w]; ct [B,C,h,w] (cotangent of the warp's
    output). Returns ``(dx, dy)`` [B,h,w] float32, computed in float32."""
    v00, v01, v10, v11, wx, wy = _corners_and_fractions(image, x, y)
    ct = ct.reshape(ct.shape[0], ct.shape[1], -1).float()
    dx = (ct * ((v01 - v00) * (1 - wy) + (v11 - v10) * wy)).sum(dim=1)
    dy = (ct * ((v10 - v00) * (1 - wx) + (v11 - v01) * wx)).sum(dim=1)
    return dx.reshape(x.shape), dy.reshape(x.shape)


def warp_image_grad_plain(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch version of the image cotangent.

    x, y [B,h,w]; ct [B,C,h,w] (cotangent of the warp's output); ``H, W`` the
    image's plane. Returns ``d_image`` [B,C,H,W] float32: the four masked,
    weighted corners of every output pixel scattered with ``scatter_add_``."""
    B, C = ct.shape[:2]
    x0i, y0i, wx, wy = _floors_and_fractions(x, y, H, W)
    ct = ct.reshape(B, C, -1).float()
    d_image = torch.zeros((B, C, H * W), dtype=torch.float32, device=ct.device)
    for dx, dy, weight in ((0, 0, (1 - wx) * (1 - wy)), (1, 0, wx * (1 - wy)),
                           (0, 1, (1 - wx) * wy), (1, 1, wx * wy)):
        idx, inb = _corner_index(x0i + dx, y0i + dy, H, W)
        vals = ct * (weight * inb[:, None, :].float())
        d_image.scatter_add_(2, idx[:, None, :].expand(-1, C, -1), vals)
    return d_image.reshape(B, C, H, W)


def _check(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    if image.dim() != 4:
        raise ValueError(f"image must be [B,C,H,W], got {tuple(image.shape)}")
    if x.dim() != 3 or x.shape != y.shape or x.shape[0] != image.shape[0]:
        raise ValueError(
            f"x, y must be [B,h,w] with B={image.shape[0]}, got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.device != image.device or y.device != image.device:
        raise ValueError("image, x and y must lie on one device")


def _check_cuda(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> int:
    """What the kernels take, for a CUDA ``image``, in one pass over cheap
    attributes (no ``torch.device`` objects: this runs once per launch and is
    most of the host's cost of a small one); anything else raises. Returns the
    image's CUDA device index."""
    s, xs = image.shape, x.shape
    if len(s) != 4 or len(xs) != 3 or xs != y.shape or xs[0] != s[0]:
        _check(image, x, y)  # raises with the message that says which
    device = image.get_device()
    if x.get_device() != device or y.get_device() != device:
        raise ValueError("image, x and y must lie on one device")
    if image.dtype is not torch.float32 and image.dtype is not torch.bfloat16:
        raise TypeError(f"image must be float32 or bfloat16, got {image.dtype}")
    if x.dtype is not torch.float32 or y.dtype is not torch.float32:
        raise TypeError(f"x, y must be float32, got {x.dtype} and {y.dtype}")
    if not (image.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("image, x and y must be contiguous")
    if s[0] > 65535 or s[2] * s[3] >= 2**31:
        raise ValueError(f"image {tuple(s)} exceeds the kernels' grid limit (batch 65535) or plane size (2^31)")
    return device


def _launch_fwd(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor, device: int) -> torch.Tensor:
    B, C, H, W = image.shape
    _, h, w = x.shape
    out = image.new_empty((B, C, h, w))
    if B * C * h * w == 0:
        return out
    lib = cuda_lib.load()
    code = lib.sde_warp_bilinear_fwd(
        image.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
        B, C, H, W, h, w, image.dtype is torch.bfloat16, device, cuda_lib.stream_handle(device),
    )
    if code:
        cuda_lib.check(lib, code, "warp_bilinear_fwd launch")
    warp_bilinear.launches += 1
    return out


def warp_coord_grad(
    image: torch.Tensor, x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coordinate cotangents ``(dx, dy)`` [B,h,w] float32 of the warp for the
    output cotangent ``ct`` [B,C,h,w]; CUDA kernel for CUDA tensors, plain
    version for CPU tensors.

    ``ct`` is read in the forward output's dtype (= ``image.dtype``), as it
    arrives from autograd, and need not be contiguous; the kernel converts each
    value to float32. Every output is written by one thread: deterministic."""
    _check(image, x, y)
    B, C, H, W = image.shape
    h, w = x.shape[1:]
    if ct.shape != (B, C, h, w) or ct.device != image.device:
        raise ValueError(f"ct must be {(B, C, h, w)} on {image.device}, got {tuple(ct.shape)} on {ct.device}")
    if image.device.type == "cpu":
        return warp_coord_grad_plain(image, x, y, ct)
    if image.device.type != "cuda":
        raise ValueError(f"warp_coord_grad supports cpu and cuda tensors, got {image.device}")
    _check_cuda(image, x, y)
    if ct.dtype != image.dtype:
        raise TypeError(f"ct must have the image's dtype {image.dtype}, got {ct.dtype}")
    ct = ct.contiguous()  # autograd may hand over a strided or expanded (stride-0) view
    dx = torch.empty((B, h, w), dtype=torch.float32, device=image.device)
    dy = torch.empty_like(dx)
    if dx.numel() == 0:
        return dx, dy
    if C == 0:
        return dx.zero_(), dy.zero_()
    lib = cuda_lib.load()
    device = image.get_device()
    code = lib.sde_warp_bilinear_bwd_coords(
        image.data_ptr(), x.data_ptr(), y.data_ptr(), ct.data_ptr(), dx.data_ptr(), dy.data_ptr(),
        B, C, H, W, h, w, image.dtype is torch.bfloat16, device, cuda_lib.stream_handle(device),
    )
    if code:
        cuda_lib.check(lib, code, "warp_bilinear_bwd_coords launch")
    warp_bilinear.bwd_launches += 1
    return dx, dy


def warp_image_grad(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Image cotangent ``d_image`` [B,C,H,W] float32 of the warp of an ``H×W``
    image at ``x, y`` [B,h,w] for the output cotangent ``ct`` [B,C,h,w]; CUDA
    kernel for CUDA tensors, plain version for CPU tensors.

    ``ct`` is read in its own dtype (float32 or bfloat16: the image's, as it
    arrives from autograd) and need not be contiguous. The kernel adds with
    float32 atomics: the result's last bits vary from run to run."""
    B, C, h, w = ct.shape
    if x.shape != (B, h, w) or y.shape != x.shape or x.device != ct.device or y.device != ct.device:
        raise ValueError(f"x, y must be {(B, h, w)} on {ct.device}, got {tuple(x.shape)}, {tuple(y.shape)}")
    if ct.device.type == "cpu":
        return warp_image_grad_plain(x, y, ct, H, W)
    if ct.device.type != "cuda":
        raise ValueError(f"warp_image_grad supports cpu and cuda tensors, got {ct.device}")
    if ct.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ct must be float32 or bfloat16, got {ct.dtype}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x, y must be float32, got {x.dtype} and {y.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("x and y must be contiguous")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit of 65535")
    ct = ct.contiguous()  # autograd may hand over a strided or expanded (stride-0) view
    d_image = torch.zeros((B, C, H, W), dtype=torch.float32, device=ct.device)
    if d_image.numel() == 0 or ct.numel() == 0:
        return d_image
    lib = cuda_lib.load()
    device = ct.get_device()
    code = lib.sde_warp_bilinear_bwd_image(
        ct.data_ptr(), x.data_ptr(), y.data_ptr(), d_image.data_ptr(),
        B, C, H, W, h, w, ct.dtype is torch.bfloat16, device, cuda_lib.stream_handle(device),
    )
    if code:
        cuda_lib.check(lib, code, "warp_bilinear_bwd_image launch")
    warp_bilinear.bwd_image_launches += 1
    return d_image


class _WarpBilinear(torch.autograd.Function):
    """Forward: the forward kernel on CUDA, the plain version on the CPU.
    Backward, each only where its input asks for a gradient: ``(dx, dy)`` from
    :func:`warp_coord_grad` and the image gradient from
    :func:`warp_image_grad` (the backward kernels on CUDA, the plain versions
    on the CPU)."""

    @staticmethod
    def forward(ctx, image, x, y):
        ctx.save_for_backward(image, x, y)
        if image.is_cuda:
            return _launch_fwd(image, x, y, image.get_device())
        return warp_bilinear_plain(image, x, y)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        image, x, y = ctx.saved_tensors
        need_image, need_x, need_y = ctx.needs_input_grad
        d_image = dx = dy = None
        if need_x or need_y:
            dx, dy = warp_coord_grad(image, x, y, ct)
            dx = dx.to(x.dtype) if need_x else None
            dy = dy.to(y.dtype) if need_y else None
        if need_image:
            d_image = warp_image_grad(x, y, ct, image.shape[2], image.shape[3]).to(image.dtype)
        return d_image, dx, dy


def warp_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear warp; CUDA kernels for CUDA tensors, plain versions for CPU tensors.

    image: [B,C,H,W] float32 or bfloat16, contiguous; x, y: [B,h,w] float32,
    contiguous. Returns [B,C,h,w] in ``image.dtype``.

    Differentiable in ``image``, ``x`` and ``y`` on both devices (hand-written
    backward kernels on CUDA); each gradient is computed only where its input
    requires one, so a detached image costs no scatter.
    """
    if image.is_cuda:
        device = _check_cuda(image, x, y)
        # no graph to record: launch the kernel without the autograd Function's cost
        if not (torch.is_grad_enabled() and (image.requires_grad or x.requires_grad or y.requires_grad)):
            return _launch_fwd(image, x, y, device)
        return _WarpBilinear.apply(image, x, y)
    _check(image, x, y)
    if image.device.type != "cpu":
        raise ValueError(f"warp_bilinear supports cpu and cuda tensors, got {image.device}")
    return _WarpBilinear.apply(image, x, y)


# counts of kernel launches (incremented where a kernel is launched, nowhere else)
warp_bilinear.launches = 0
warp_bilinear.bwd_launches = 0
warp_bilinear.bwd_image_launches = 0
