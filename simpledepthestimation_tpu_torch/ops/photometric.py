"""Per-pixel photometric map α·SSIM + (1−α)·L1: kernel wrapper + plain version.

``photometric_map`` is the wrapper of the hand-written CUDA kernel
``csrc/photometric.cu`` (forward only in this package so far);
``photometric_map_plain`` is the same function composed from
``avg_pool_3x3_reflect`` in plain PyTorch — the counterpart of
``photometric_map_reference`` in
``simpledepthestimation_tpu/ops/pallas_photometric.py``. The wrapper takes the
plain version only for a CPU tensor; for a CUDA tensor it launches the kernel
or raises.

    out = α · mean_c clip((1 − SSIM(a,b))/2, 0, 1) + (1−α) · mean_c |a − b|

with SSIM over a 3×3 window, reflect-padded by one pixel at the border.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .pool import avg_pool_3x3_reflect


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


def photometric_map(
    a: torch.Tensor, b: torch.Tensor, alpha: float = 0.85, C1: float = 1e-4, C2: float = 9e-4
) -> torch.Tensor:
    """Photometric map; CUDA kernel for CUDA tensors, plain version for CPU tensors.

    a, b: [B,C,H,W] of one dtype (float32 or bfloat16), contiguous, H, W ≥ 2.
    Returns [B,1,H,W] float32.

    The kernel is forward-only: a CUDA input that requires grad while grad mode
    is on raises ``NotImplementedError`` (the backward kernel belongs to the
    training slice of the port). On the CPU autograd differentiates the plain
    version.
    """
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"a, b must be [B,C,H,W] of one shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[2] < 2 or a.shape[3] < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {tuple(a.shape[2:])}")
    if a.device != b.device:
        raise ValueError("a and b must lie on one device")
    if a.device.type == "cpu":
        return photometric_map_plain(a, b, alpha, C1, C2)
    if a.device.type != "cuda":
        raise ValueError(f"photometric_map supports cpu and cuda tensors, got {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "photometric_map has no backward kernel on CUDA yet (training slice of the port); "
            "call it under torch.no_grad()"
        )
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a, b must both be float32 or bfloat16, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    B, C, H, W = a.shape
    if B > 65535 or (H + 15) // 16 > 65535:
        raise ValueError(f"shape {tuple(a.shape)} exceeds the kernel's grid limits")
    out = torch.empty((B, 1, H, W), dtype=torch.float32, device=a.device)
    if B == 0 or C == 0:
        return out.zero_()
    lib = cuda_lib.load()
    with cuda_lib.on_device(a.device):
        code = lib.sde_photometric_map_fwd(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), B, C, H, W,
            float(alpha), float(C1), float(C2), int(a.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(lib, code, "photometric_map_fwd launch")
    photometric_map.launches += 1
    return out


# count of kernel launches (incremented where the kernel is launched, nowhere else)
photometric_map.launches = 0
