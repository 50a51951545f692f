"""``nets.conv_ms.train``: device ms per step in cuDNN's convolution kernels
(forward, data and weight gradients; 2D and 3D), over the traced stretch."""

from core.trace import device_us

CONV = ("conv", "fprop", "dgrad", "wgrad", "xmma", "implicit_gemm", "winograd", "cutlass", "gemm")
NOT_CONV = ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc", "nhwc2nchw", "bn_", "batch_norm", "group_norm",
            "warp_bilinear", "photometric_map")


def is_conv(name):
    return any(p in name for p in CONV) and not any(p in name for p in NOT_CONV)


def read(run):
    us = device_us(run.trace, is_conv)
    return None if us is None else us / 1e3 / run.traced_steps
