"""Bilinear warp at per-pixel float coordinates: kernel wrappers + plain versions.

``warp_bilinear`` is a ``torch.autograd.Function`` around the hand-written CUDA
kernels of ``csrc/warp.cu``: the forward sample and the backward that yields the
coordinate cotangents ``dx, dy`` (the gradient that trains depth and pose).
Beside each kernel stands the same function in plain PyTorch:
``warp_bilinear_plain`` (four gathers, the counterpart of
``_resample_bilinear_4gather`` in ``simpledepthestimation_tpu/ops/resample.py``)
and ``warp_coord_grad_plain`` (the explicit derivative of the bilinear
weights). The wrapper takes the plain versions only for CPU tensors; for CUDA
tensors it launches the kernels or raises.

Semantics (all): ``out[b,c,i,j]`` is the bilinear sample of ``image[b,c]`` at
``(x[b,i,j], y[b,i,j])`` in pixel units; each of the four corners that lies
outside the image contributes zero (``F.grid_sample`` with
``padding_mode="zeros", align_corners=True``). ``x == W-1`` gives a right
corner at ``W`` that is masked and has weight 0. A huge finite coordinate is
fully outside (zero output); a non-finite one gives NaN. The coordinate
gradient is the almost-everywhere derivative (``floor`` has gradient zero):

    dx[b,i,j] = Σ_c ct[b,c,i,j] · [(v01 − v00)(1 − wy) + (v11 − v10)·wy]
    dy[b,i,j] = Σ_c ct[b,c,i,j] · [(v10 − v00)(1 − wx) + (v11 − v01)·wx]

with ``v..`` the four (masked) corner values and ``wx, wy`` the fractions.

The image gradient (a bilinear scatter-add) has no CUDA kernel yet: on the CPU
it comes from autograd of the plain version; on CUDA an ``image`` that requires
grad raises ``NotImplementedError`` at the call. The MonoDepth2 step never asks
for it: the warped operand is a context frame, a constant.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib


def _corner(flat: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Gather ``flat [B,C,H*W]`` at integer ``(ix, iy) [B,N]``; zero outside."""
    inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    vals = torch.gather(flat, 2, idx[:, None, :].expand(-1, flat.shape[1], -1))
    return vals * inb[:, None, :].to(flat.dtype)


def _corners_and_fractions(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The four masked corner values ``[B,C,N]`` (float32) and ``wx, wy [B,1,N]``."""
    B, C, H, W = image.shape
    x = x.reshape(B, -1).float()
    y = y.reshape(B, -1).float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None, :]
    wy = (y - y0)[:, None, :]
    # clamp while still float so that huge coordinates stay "outside"
    x0i = x0.clamp(-2, W).long()
    y0i = y0.clamp(-2, H).long()

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


def _check(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    if image.dim() != 4:
        raise ValueError(f"image must be [B,C,H,W], got {tuple(image.shape)}")
    if x.dim() != 3 or x.shape != y.shape or x.shape[0] != image.shape[0]:
        raise ValueError(
            f"x, y must be [B,h,w] with B={image.shape[0]}, got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.device != image.device or y.device != image.device:
        raise ValueError("image, x and y must lie on one device")


def _check_cuda(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    """What the kernels take; anything else raises."""
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image must be float32 or bfloat16, got {image.dtype}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x, y must be float32, got {x.dtype} and {y.dtype}")
    if not (image.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("image, x and y must be contiguous")
    if image.shape[0] > 65535:
        raise ValueError(f"batch {image.shape[0]} exceeds the kernel's grid limit of 65535")


def _launch_fwd(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    B, C, H, W = image.shape
    h, w = x.shape[1:]
    out = torch.empty((B, C, h, w), dtype=image.dtype, device=image.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    with cuda_lib.on_device(image.device):
        code = lib.sde_warp_bilinear_fwd(
            image.data_ptr(), x.data_ptr(), y.data_ptr(), out.data_ptr(),
            B, C, H, W, h, w, int(image.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
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
    with cuda_lib.on_device(image.device):
        code = lib.sde_warp_bilinear_bwd_coords(
            image.data_ptr(), x.data_ptr(), y.data_ptr(), ct.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            B, C, H, W, h, w, int(image.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(lib, code, "warp_bilinear_bwd_coords launch")
    warp_bilinear.bwd_launches += 1
    return dx, dy


class _WarpBilinear(torch.autograd.Function):
    """Forward: the forward kernel on CUDA, the plain version on the CPU.
    Backward: ``(dx, dy)`` from :func:`warp_coord_grad` (the backward kernel
    on CUDA, the plain version on the CPU), only where a coordinate asks for a
    gradient; the image gradient from autograd of the plain version, CPU only."""

    @staticmethod
    def forward(ctx, image, x, y):
        ctx.save_for_backward(image, x, y)
        if image.device.type == "cpu":
            return warp_bilinear_plain(image, x, y)
        return _launch_fwd(image, x, y)

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
            # only reachable on the CPU: warp_bilinear refuses a CUDA image that requires grad
            with torch.enable_grad():
                leaf = image.detach().requires_grad_()
                out = warp_bilinear_plain(leaf, x, y)
            (d_image,) = torch.autograd.grad(out, leaf, ct)
        return d_image, dx, dy


def warp_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear warp; CUDA kernels for CUDA tensors, plain versions for CPU tensors.

    image: [B,C,H,W] float32 or bfloat16, contiguous; x, y: [B,h,w] float32,
    contiguous. Returns [B,C,h,w] in ``image.dtype``.

    Differentiable in ``x`` and ``y`` on both devices (a hand-written backward
    kernel on CUDA) and in ``image`` on the CPU. A CUDA ``image`` that requires
    grad while grad mode is on raises ``NotImplementedError``: the image
    cotangent kernel belongs to the MotionLearning slice of the port, and
    nothing here falls back to a scatter in plain PyTorch.
    """
    _check(image, x, y)
    if image.device.type == "cuda":
        if torch.is_grad_enabled() and image.requires_grad:
            raise NotImplementedError(
                "warp_bilinear has no image-gradient kernel on CUDA yet (MotionLearning slice of "
                "the port); detach the image, or call it under torch.no_grad()"
            )
        _check_cuda(image, x, y)
    elif image.device.type != "cpu":
        raise ValueError(f"warp_bilinear supports cpu and cuda tensors, got {image.device}")
    return _WarpBilinear.apply(image, x, y)


# counts of kernel launches (incremented where a kernel is launched, nowhere else)
warp_bilinear.launches = 0
warp_bilinear.bwd_launches = 0
