"""Windowed pooling helpers (NCHW), the building blocks of SSIM.

Counterpart of ``simpledepthestimation_tpu/ops/pool.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad_hw(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """ReflectionPad2d on NCHW."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def avg_pool_3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """ReflectionPad(1) + AvgPool(3, stride 1): the SSIM window."""
    return F.avg_pool2d(reflect_pad_hw(x, 1), 3, stride=1)


def avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """AvgPool(3, stride 1, zero pad 1); the divisor counts the zero padding."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _same_pads(size: int, window: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def avg_pool(x: torch.Tensor, window: int, stride: int = 1, padding: str = "VALID") -> torch.Tensor:
    """General average pool over H, W of an NCHW tensor. ``"SAME"`` pads like
    XLA (more on the bottom/right) and divides by the count of real pixels."""
    if padding == "VALID":
        return F.avg_pool2d(x, window, stride=stride)
    if padding != "SAME":
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    pt, pb = _same_pads(x.shape[2], window, stride)
    pl, pr = _same_pads(x.shape[3], window, stride)
    summed = F.avg_pool2d(F.pad(x, (pl, pr, pt, pb)), window, stride=stride) * (window * window)
    counts = F.avg_pool2d(
        F.pad(torch.ones_like(x[:1, :1]), (pl, pr, pt, pb)), window, stride=stride
    ) * (window * window)
    return summed / counts


def max_pool(x: torch.Tensor, window: int, stride: int = 1, padding: str = "SAME") -> torch.Tensor:
    """Max pool over H, W of an NCHW tensor; ``"SAME"`` pads with -inf like XLA."""
    if padding == "VALID":
        return F.max_pool2d(x, window, stride=stride)
    if padding != "SAME":
        raise ValueError(f"padding must be 'VALID' or 'SAME', got {padding!r}")
    pt, pb = _same_pads(x.shape[2], window, stride)
    pl, pr = _same_pads(x.shape[3], window, stride)
    fill = float("-inf") if x.is_floating_point() else torch.iinfo(x.dtype).min
    return F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=fill), window, stride=stride)
