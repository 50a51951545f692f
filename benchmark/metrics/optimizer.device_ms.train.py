"""``optimizer.device_ms.train``: device ms per step of the operations that run
inside PyTorch's own ``Optimizer.step#Adam.step`` range on the card (the
union of their intervals), over the stretch traced with the host (the ranges
are drawn from host-side ``record_function`` ranges)."""

from core.trace import clip, union_length

RANGE = "Optimizer.step#Adam.step"


def read(run):
    ranges = [(s, e) for name, s, e in run.host_trace.annotations if name == RANGE]
    if not ranges:
        return None
    ops = [(s, e) for _, s, e in run.host_trace.device_ops]
    us = sum(union_length(clip(ops, lo, hi)) for lo, hi in ranges)
    return us / 1e3 / run.host_traced_steps
