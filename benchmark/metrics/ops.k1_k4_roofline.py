"""``ops.k1_k4_roofline``: the hand-written loss kernels' share of their
roofline, in %: the least time of every launch of K1–K4 in the traced
stretch (``arith.kernels``: the larger of bytes / 3.35 TB/s and float32
operations / 67 TFLOP/s, worked out from the cell's shapes) over those
kernels' device time."""

from arith.kernels import KERNELS, monodepth2_step
from core.trace import device_us


def read(run):
    us = device_us(run.trace, lambda name: any(k in name for k in KERNELS))
    if not us:
        return None
    m = run.mix
    least_s = sum(monodepth2_step(m["batch"], m["contexts"], m["height"], m["width"]).values())
    return 100.0 * least_s * run.traced_steps / (us / 1e6)
