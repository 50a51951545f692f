"""``step_mfu.train``: the whole training step's share of the card's bfloat16
dense peak, in %: model FLOPs per step (``arith.flops``: the plain reference's
forward and backward at the cell's shapes, counted once) × the window's steps
per second / 989 TFLOP/s. The window is the untraced one of the same run."""

from arith.flops import BF16_DENSE_FLOPS_PER_S, train_step_flops


def read(run):
    if not run.trace.device_ops:
        return None
    m = run.mix
    flops = train_step_flops(run.config["cfg"], m["batch"], m["contexts"], m["height"], m["width"])
    return 100.0 * flops * (run.images_per_s / m["batch"]) / BF16_DENSE_FLOPS_PER_S
