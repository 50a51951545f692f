"""Bilinear warp at per-pixel float coordinates: kernel wrapper + plain version.

``warp_bilinear`` is the wrapper of the hand-written CUDA kernel
``csrc/warp.cu`` (forward only in this package so far); ``warp_bilinear_plain``
is the same function as a composition of four gathers in plain PyTorch — the
counterpart of ``_resample_bilinear_4gather`` in
``simpledepthestimation_tpu/ops/resample.py``. The wrapper takes the plain
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises.

Semantics (both): ``out[b,c,i,j]`` is the bilinear sample of
``image[b,c]`` at ``(x[b,i,j], y[b,i,j])`` in pixel units; each of the four
corners that lies outside the image contributes zero (``F.grid_sample`` with
``padding_mode="zeros", align_corners=True``). ``x == W-1`` gives a right
corner at ``W`` that is masked and has weight 0. A huge finite coordinate is
fully outside (zero output); a non-finite one gives NaN.
"""

from __future__ import annotations

import torch

from . import cuda_lib


def _corner(flat: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Gather ``flat [B,C,H*W]`` at integer ``(ix, iy) [B,N]``; zero outside."""
    inb = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
    idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
    vals = torch.gather(flat, 2, idx[:, None, :].expand(-1, flat.shape[1], -1))
    return vals * inb[:, None, :].to(flat.dtype)


def warp_bilinear_plain(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (4 gathers). image [B,C,H,W]; x, y [B,h,w] float.

    Computes in float32 and returns ``image.dtype``. Differentiable by autograd
    in the image (scatter-add) and in the coordinates (bilinear weights)."""
    B, C, H, W = image.shape
    out_hw = x.shape[1:]
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
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(B, C, *out_hw).to(image.dtype)


def _check(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    if image.dim() != 4:
        raise ValueError(f"image must be [B,C,H,W], got {tuple(image.shape)}")
    if x.dim() != 3 or x.shape != y.shape or x.shape[0] != image.shape[0]:
        raise ValueError(
            f"x, y must be [B,h,w] with B={image.shape[0]}, got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    if x.device != image.device or y.device != image.device:
        raise ValueError("image, x and y must lie on one device")


def warp_bilinear(image: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear warp; CUDA kernel for CUDA tensors, plain version for CPU tensors.

    image: [B,C,H,W] float32 or bfloat16, contiguous; x, y: [B,h,w] float32,
    contiguous. Returns [B,C,h,w] in ``image.dtype``.

    The kernel is forward-only: a CUDA input that requires grad while grad mode
    is on raises ``NotImplementedError`` (the backward kernels belong to the
    training slice of the port). On the CPU autograd differentiates the plain
    version.
    """
    _check(image, x, y)
    if image.device.type == "cpu":
        return warp_bilinear_plain(image, x, y)
    if image.device.type != "cuda":
        raise ValueError(f"warp_bilinear supports cpu and cuda tensors, got {image.device}")
    if torch.is_grad_enabled() and (image.requires_grad or x.requires_grad or y.requires_grad):
        raise NotImplementedError(
            "warp_bilinear has no backward kernel on CUDA yet (training slice of the port); "
            "call it under torch.no_grad()"
        )
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"image must be float32 or bfloat16, got {image.dtype}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"x, y must be float32, got {x.dtype} and {y.dtype}")
    if not (image.is_contiguous() and x.is_contiguous() and y.is_contiguous()):
        raise ValueError("image, x and y must be contiguous")
    B, C, H, W = image.shape
    h, w = x.shape[1:]
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit of 65535")
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


# count of kernel launches (incremented where the kernel is launched, nowhere else)
warp_bilinear.launches = 0
