"""The port's spans in the stretch traced with the host, and the device
operations in them.

The port names stretches of its own code with ``torch.profiler.record_function``
ranges while a profiler records (``simpledepthestimation_tpu_torch/utils/tracing.py``).
Only the stretch traced with the host records them: there each span gives a
GPU-side annotation (``Trace.annotations``) from the start of the first device
operation launched in it to the end of the last. The profiler gives each
operation to the innermost span open at its launch, so a span's GPU range
covers what spans nested in it launch between its own operations, not at its
ends. Host-to-device copies (``device_prefetch``'s next batches, on a side
stream) overlap the step and are left out of every sum and count.

Every function takes the ``Run`` a reader gets and returns ``None`` where the
stretch holds no range of the spans asked for: a program without the spans,
or a CPU rehearsal (no device operation, so no GPU range). It reads only the
trace and imports nothing of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from core.trace import clip, merged, union_length

COPY = "Memcpy HtoD"


def _ranges(trace, names: Sequence[str]) -> List[Tuple[float, float]]:
    return [(s, e) for name, s, e in trace.annotations if name in names]


def _step_ops(trace) -> List[Tuple[float, float]]:
    return [(s, e) for name, s, e in trace.device_ops if not name.startswith(COPY)]


def _stretch(run):
    if run.host_trace is None or not run.host_traced_steps:
        return None, 0
    return run.host_trace, run.host_traced_steps


def device_ms(run, names: Sequence[str]) -> Optional[float]:
    """Device ms per step inside the GPU ranges of ``names``: the union of
    the operations' intervals clipped to the union of the ranges."""
    trace, steps = _stretch(run)
    ranges = merged(_ranges(trace, names)) if trace else []
    if not ranges:
        return None
    ops = _step_ops(trace)
    return sum(union_length(clip(ops, lo, hi)) for lo, hi in ranges) / 1e3 / steps


def launches(run, names: Sequence[str]) -> Optional[float]:
    """Device operations per step that start inside the GPU ranges of ``names``."""
    trace, steps = _stretch(run)
    ranges = merged(_ranges(trace, names)) if trace else []
    if not ranges:
        return None
    return sum(any(lo <= s < hi for lo, hi in ranges) for s, _ in _step_ops(trace)) / steps


def between_ms(run, before: Sequence[str], after: str) -> Optional[float]:
    """Device ms per step from the end of a step's ``before`` ranges to the
    start of its ``after`` range: the union of the operations that start in
    between, clipped to it. Each ``after`` range closes a step, which holds
    the ``before`` ranges that start after the previous step's ``after``
    range. The compute stream runs in order, so this is whatever ran in
    between, whichever thread launched it. ``None`` unless both kinds of
    range are there."""
    trace, steps = _stretch(run)
    if not trace:
        return None
    opened, closes = _ranges(trace, before), sorted(_ranges(trace, (after,)))
    if not opened or not closes:
        return None
    ops = _step_ops(trace)
    us, previous = 0.0, float("-inf")
    for close, _ in closes:
        ends = [e for s, e in opened if previous < s < close]
        if ends:
            lo = max(ends)
            us += union_length(clip([(s, e) for s, e in ops if lo <= s < close], lo, close))
        previous = close
    return us / 1e3 / steps
