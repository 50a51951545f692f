"""The device trace of a stretch of steps, reduced to what the metrics read.

Two kinds of stretch. ``record_device`` traces the card alone (the profiler's
CUDA activity: no host operator is recorded, so the host runs the steps at
nearly its untraced pace) between two marker kernels, whose span on the
device's clock is the traced window. ``record_host`` traces host and card
(CPU and CUDA activities) inside one ``record_function`` range that ends after
a synchronise; recording every host operator slows a host-paced step, so its
window is not used for the device's idle share, only for what the host was
doing and for the GPU-side annotation ranges (``Optimizer.step#Adam.step``).
Both keep the device operations (kernels, copies and fills) as intervals on
the profiler's one clock.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "benchmark.traced_window"
Interval = Tuple[str, float, float]  # name, start us, end us


@dataclass
class Trace:
    window: Tuple[float, float]  # us
    device_ops: List[Interval]
    annotations: List[Interval]  # GPU-side user ranges, e.g. Optimizer.step#Adam.step
    host_ops: List[Interval] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return union_length(clip([(s, e) for _, s, e in self.device_ops], *self.window)) / 1e6


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000


def _split(prof) -> Trace:
    window, device_ops, annotations, host_ops = None, [], [], []
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            (annotations if e.is_user_annotation else device_ops).append(item)
        elif e.name == WINDOW and window is None:
            window = item[1:]
        elif not e.is_async:
            host_ops.append(item)
    return Trace(window=window, device_ops=device_ops, annotations=annotations, host_ops=host_ops)


def record_device(steps: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Trace the card alone over ``steps()``: the window runs from the start of
    a marker kernel launched before them to the end of one launched after.
    Without a card (a CPU rehearsal) the steps run untraced."""
    sync()
    if not torch.cuda.is_available():
        steps()
        return Trace(window=(0.0, 0.0), device_ops=[], annotations=[])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARKER_CYCLES)
        steps()
        torch.cuda._sleep(MARKER_CYCLES)
        sync()
    trace = _split(prof)
    marks = sorted((s, e) for name, s, e in trace.device_ops if MARKER in name)
    if len(marks) != 2:
        raise RuntimeError(f"expected the two marker kernels in the device trace, found {len(marks)}")
    trace.window = (marks[0][0], marks[1][1])
    trace.device_ops = [op for op in trace.device_ops if MARKER not in op[0]]
    return trace


def record_host(steps: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Trace host and card over ``steps()`` and ``sync()``; the window is their span."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            steps()
            sync()
    return _split(prof)


def clip(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged(intervals))


def device_us(trace: Trace, match: Callable[[str], bool]) -> Optional[float]:
    """Union of the device time of the operations whose name ``match``es, in
    the window; None where no operation matches."""
    hits = [(s, e) for name, s, e in trace.device_ops if match(name)]
    if not hits:
        return None
    return union_length(clip(hits, *trace.window))


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    busy = merged(clip([(s, e) for _, s, e in trace.device_ops], *trace.window))
    gaps, t = [], trace.window[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.window[1] > t:
        gaps.append((t, trace.window[1]))
    return gaps


RUNTIME_PREFIXES = ("cuda", "cu", "Activity Buffer", WINDOW)


def host_activity(trace: Trace, t: float) -> str:
    """The innermost host operator running at ``t`` (not a CUDA runtime call),
    or ``python`` where none is."""
    best = None
    for name, s, e in trace.host_ops:
        if s <= t <= e and not name.startswith(RUNTIME_PREFIXES):
            if best is None or e - s < best[2] - best[1]:
                best = (name, s, e)
    return "python" if best is None else best[0]


def breakdown(device: Trace, host: Trace, top: int = 10) -> Dict[str, List[List]]:
    """The device operations that took most time (seconds over the device
    trace's window, by name) and the host trace's longest idle gaps, each named
    by what the host was doing."""
    by_name: Dict[str, float] = {}
    for name, s, e in device.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(host), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name[:120], sec] for name, sec in ops],
            "idle_gaps": [[host_activity(host, (s + e) / 2)[:120], (e - s) / 1e6] for s, e in gaps]}
