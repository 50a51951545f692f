"""Least time of the hand-written loss kernels (K1–K4) at a cell's shapes.

The byte and operation counts are those the kernels' own checks use: each
input byte read once, each output byte written once, at the dtypes the step
passes (float32 planes and coordinates), and the float32 operations outside
the tensor cores. The least time of a launch is the larger of bytes / 3.35 TB/s
and operations / 67 TFLOP/s, the published peaks of one H100 SXM at its full
power limit.

Per MonoDepth2 training step and scale i (planes h = H/2^i, w = W/2^i) the step
launches, on the N·B warped contexts (C = 3): K1 ``warp_bilinear_fwd`` once,
K2 ``photometric_map_fwd`` twice (warped and, for the automask, unwarped
contexts), K3 ``warp_bilinear_bwd_coords`` once and K4 ``photometric_map_bwd``
once with one gradient out (the target needs none).
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

KERNELS = ("warp_bilinear_fwd", "photometric_map_fwd", "warp_bilinear_bwd_coords", "photometric_map_bwd")


def least_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def warp_fwd(B, C, h, w, elem):
    return least_s(B * h * w * (8 + 2 * elem * C), B * h * w * (10 + 11 * C))


def photometric_fwd(B, C, h, w, elem):
    return least_s(B * h * w * (2 * elem * C + 4), B * h * w * C * 100)


def warp_bwd_coords(B, C, h, w, elem):
    return least_s(B * h * w * (8 + 8 + 2 * elem * C), B * h * w * (10 + 17 * C))


def photometric_bwd(B, C, h, w, elem, n_out):
    return least_s(B * h * w * (2 * elem * C + 4 + 4 * C * n_out), B * h * w * C * 200)


def monodepth2_step(B: int, N: int, H: int, W: int, scales: int = 4, C: int = 3, elem: int = 4) -> Dict[str, float]:
    """Least seconds per training step of each of K1–K4, by kernel name."""
    out = dict.fromkeys(KERNELS, 0.0)
    for i in range(scales):
        h, w, planes = H >> i, W >> i, N * B
        out["warp_bilinear_fwd"] += warp_fwd(planes, C, h, w, elem)
        out["photometric_map_fwd"] += 2 * photometric_fwd(planes, C, h, w, elem)
        out["warp_bilinear_bwd_coords"] += warp_bwd_coords(planes, C, h, w, elem)
        out["photometric_map_bwd"] += photometric_bwd(planes, C, h, w, elem, 1)
    return out
