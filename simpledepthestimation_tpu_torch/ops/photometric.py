"""Per-pixel photometric map α·SSIM + (1−α)·L1: kernel wrappers + plain versions.

``photometric_map`` is a ``torch.autograd.Function`` around the hand-written
CUDA kernels of ``csrc/photometric.cu``: the fused forward map and its analytic
VJP as a second fused kernel. Beside each kernel stands the same function in
plain PyTorch: ``photometric_map_plain`` (composed from
``avg_pool_3x3_reflect``) and ``photometric_vjp_plain`` (composed from
``pool9_adjoint``) — the counterparts of ``photometric_map_reference`` and
``photometric_vjp_reference`` in
``simpledepthestimation_tpu/ops/pallas_photometric.py``. The wrapper takes the
plain versions only for CPU tensors; for CUDA tensors it launches the kernels
or raises.

    out = α · mean_c clip((1 − SSIM(a,b))/2, 0, 1) + (1−α) · mean_c |a − b|

with SSIM over a 3×3 window, reflect-padded by one pixel at the border.

The gradient is the analytic one, on both devices: the clip passes gradient
only strictly inside (0, 1) and ``sign(0) = 0`` for the L1 term, so ties do
not follow ``torch.clamp``'s autograd.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib
from .pool import avg_pool_3x3_reflect, pool9_adjoint


def ssim_distance(x: torch.Tensor, y: torch.Tensor, C1: float = 1e-4, C2: float = 9e-4) -> torch.Tensor:
    """SSIM *distance* in [0,1] per pixel and channel: clamp((1 − ssim)/2, 0, 1)."""
    mu_x = avg_pool_3x3_reflect(x)
    mu_y = avg_pool_3x3_reflect(y)
    mu_xy = mu_x * mu_y
    mu_x2 = mu_x * mu_x
    mu_y2 = mu_y * mu_y
    sigma_x = avg_pool_3x3_reflect(x * x) - mu_x2
    sigma_y = avg_pool_3x3_reflect(y * y) - mu_y2
    sigma_xy = avg_pool_3x3_reflect(x * y) - mu_xy
    ssim_n = (2 * mu_xy + C1) * (2 * sigma_xy + C2)
    ssim_d = (mu_x2 + mu_y2 + C1) * (sigma_x + sigma_y + C2)
    return torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0)


def photometric_map_plain(
    a: torch.Tensor, b: torch.Tensor, alpha: float = 0.85, C1: float = 1e-4, C2: float = 9e-4
) -> torch.Tensor:
    """Plain PyTorch version. a, b: [B,C,H,W] → [B,1,H,W] float32."""
    a = a.float()
    b = b.float()
    l1 = (a - b).abs().mean(dim=1, keepdim=True)
    s = ssim_distance(a, b, C1, C2).mean(dim=1, keepdim=True)
    return alpha * s + (1.0 - alpha) * l1


def photometric_vjp_plain(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
    alpha: float = 0.85, C1: float = 1e-4, C2: float = 9e-4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the analytic VJP of the photometric map.

    a, b: [B,C,H,W]; g: [B,1,H,W], the cotangent of the map. Returns
    ``(g_a, g_b)`` in the inputs' dtypes, computed in float32."""
    pool, poolT = avg_pool_3x3_reflect, pool9_adjoint
    a32, b32 = a.float(), b.float()
    gc = g.float() / a.shape[1]  # per-channel cotangent of the channel mean

    mu_a, mu_b = pool(a32), pool(b32)
    sig_a = pool(a32 * a32) - mu_a * mu_a
    sig_b = pool(b32 * b32) - mu_b * mu_b
    sig_ab = pool(a32 * b32) - mu_a * mu_b
    n1 = 2.0 * mu_a * mu_b + C1
    n2 = 2.0 * sig_ab + C2
    d1 = mu_a * mu_a + mu_b * mu_b + C1
    d2 = sig_a + sig_b + C2
    n = n1 * n2
    d = d1 * d2
    r = (1.0 - n / d) * 0.5
    in_range = ((r > 0.0) & (r < 1.0)).float()

    g_ratio = -0.5 * alpha * gc * in_range
    g_n = g_ratio / d
    g_d = -g_ratio * n / (d * d)
    g_n1, g_n2 = g_n * n2, g_n * n1
    g_d1, g_d2 = g_d * d2, g_d * d1

    g_sig_ab = 2.0 * g_n2
    g_mu_a = 2.0 * mu_b * g_n1 + 2.0 * mu_a * g_d1 - 2.0 * mu_a * g_d2 - mu_b * g_sig_ab
    g_mu_b = 2.0 * mu_a * g_n1 + 2.0 * mu_b * g_d1 - 2.0 * mu_b * g_d2 - mu_a * g_sig_ab

    l1_g = (1.0 - alpha) * gc * torch.sign(a32 - b32)
    t_d2, t_ab = poolT(g_d2), poolT(g_sig_ab)
    g_a = poolT(g_mu_a) + 2.0 * a32 * t_d2 + b32 * t_ab + l1_g
    g_b = poolT(g_mu_b) + 2.0 * b32 * t_d2 + a32 * t_ab - l1_g
    return g_a.to(a.dtype), g_b.to(b.dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """What both directions take; anything else raises. For CUDA tensors one
    pass over cheap attributes (no ``torch.device`` objects)."""
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"a, b must be [B,C,H,W] of one shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[2] < 2 or a.shape[3] < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {tuple(a.shape[2:])}")
    if a.is_cuda:
        if not b.is_cuda or a.get_device() != b.get_device():
            raise ValueError("a and b must lie on one device")
        if a.dtype is not b.dtype or (a.dtype is not torch.float32 and a.dtype is not torch.bfloat16):
            raise TypeError(f"a, b must both be float32 or bfloat16, got {a.dtype} and {b.dtype}")
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("a and b must be contiguous")
        if a.shape[0] * max(a.shape[1], 1) > 65535 or (a.shape[2] + 15) // 16 > 65535 or a.shape[2] * a.shape[3] >= 2**31:
            raise ValueError(f"shape {tuple(a.shape)} exceeds the kernels' grid or index limits")
    elif a.device != b.device:
        raise ValueError("a and b must lie on one device")
    elif a.device.type != "cpu":
        raise ValueError(f"the photometric map supports cpu and cuda tensors, got {a.device}")


def _launch_fwd(a: torch.Tensor, b: torch.Tensor, alpha: float, C1: float, C2: float) -> torch.Tensor:
    B, C, H, W = a.shape
    out = a.new_empty((B, 1, H, W), dtype=torch.float32)
    if B == 0 or C == 0:
        return out.zero_()
    lib = cuda_lib.load()
    device = a.get_device()
    code = lib.sde_photometric_map_fwd(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), B, C, H, W,
        float(alpha), float(C1), float(C2), a.dtype is torch.bfloat16, device, cuda_lib.stream_handle(device),
    )
    if code:
        cuda_lib.check(lib, code, "photometric_map_fwd launch")
    photometric_map.launches += 1
    return out


def photometric_vjp(
    a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
    alpha: float = 0.85, C1: float = 1e-4, C2: float = 9e-4,
    need_a: bool = True, need_b: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Analytic VJP ``(g_a, g_b)`` of the photometric map for the cotangent
    ``g`` [B,1,H,W]; CUDA kernel for CUDA tensors, plain version for CPU
    tensors. A gradient that is not needed comes back as ``None``; on CUDA one
    launch gives the wanted ones (a null pointer tells the kernel to skip the
    other). The kernel writes float32; the cast to the inputs' dtype happens
    here. ``g`` need not be contiguous."""
    _check(a, b)
    B, C, H, W = a.shape
    if g.shape != (B, 1, H, W) or g.device != a.device:
        raise ValueError(f"g must be {(B, 1, H, W)} on {a.device}, got {tuple(g.shape)} on {g.device}")
    if not (need_a or need_b):
        return None, None
    if a.device.type == "cpu":
        g_a, g_b = photometric_vjp_plain(a, b, g, alpha, C1, C2)
        return (g_a if need_a else None, g_b if need_b else None)
    g = g.float().contiguous()  # autograd may hand over a strided or expanded (stride-0) view
    g_a = a.new_empty(a.shape, dtype=torch.float32) if need_a else None
    g_b = a.new_empty(b.shape, dtype=torch.float32) if need_b else None
    if a.numel() > 0:
        lib = cuda_lib.load()
        device = a.get_device()
        code = lib.sde_photometric_map_bwd(
            a.data_ptr(), b.data_ptr(), g.data_ptr(),
            g_a.data_ptr() if need_a else None, g_b.data_ptr() if need_b else None,
            B, C, H, W, float(alpha), float(C1), float(C2), a.dtype is torch.bfloat16, device,
            cuda_lib.stream_handle(device),
        )
        if code:
            cuda_lib.check(lib, code, "photometric_map_bwd launch")
        photometric_map.bwd_launches += 1
    return (g_a.to(a.dtype) if need_a else None, g_b.to(b.dtype) if need_b else None)


class _PhotometricMap(torch.autograd.Function):
    """Forward: the forward kernel on CUDA, the plain version on the CPU.
    Backward: :func:`photometric_vjp` (the backward kernel on CUDA, the plain
    version on the CPU) for the inputs that ask for it."""

    @staticmethod
    def forward(ctx, a, b, alpha, C1, C2):
        ctx.save_for_backward(a, b)
        ctx.constants = (alpha, C1, C2)
        if a.is_cuda:
            return _launch_fwd(a, b, alpha, C1, C2)
        return photometric_map_plain(a, b, alpha, C1, C2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad[:2]
        g_a, g_b = photometric_vjp(a, b, g, *ctx.constants, need_a=need_a, need_b=need_b)
        return g_a, g_b, None, None, None


def photometric_map(
    a: torch.Tensor, b: torch.Tensor, alpha: float = 0.85, C1: float = 1e-4, C2: float = 9e-4
) -> torch.Tensor:
    """Photometric map; CUDA kernels for CUDA tensors, plain versions for CPU tensors.

    a, b: [B,C,H,W] of one dtype (float32 or bfloat16 on CUDA), contiguous,
    H, W ≥ 2. Returns [B,1,H,W] float32. Differentiable in ``a`` and ``b`` on
    both devices; gradients come in the inputs' dtype, and an input that needs
    none costs nothing.
    """
    _check(a, b)
    if a.is_cuda and not (torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)):
        return _launch_fwd(a, b, alpha, C1, C2)  # no graph to record: no autograd Function
    return _PhotometricMap.apply(a, b, alpha, C1, C2)


# counts of kernel launches (incremented where a kernel is launched, nowhere else)
photometric_map.launches = 0
photometric_map.bwd_launches = 0
