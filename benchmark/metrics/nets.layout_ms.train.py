"""``nets.layout_ms.train``: device ms per step in the layout conversions
around cuDNN's convolutions (NCHW to NHWC and back), over the traced stretch."""

from core.trace import device_us

LAYOUT = ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc", "nhwc2nchw")


def read(run):
    us = device_us(run.trace, lambda name: any(p in name for p in LAYOUT))
    return None if us is None else us / 1e3 / run.traced_steps
