#!/usr/bin/env python
"""Record a ``torch.profiler`` trace of the flagship train step on the
PyTorch/CUDA port and print its top device operations by self time per step,
each with the innermost function inside ``simpledepthestimation_tpu_torch/``
that leads to it.

The twin of ``trace_step.py`` (which drives the JAX package): 3 warm steps,
then ``N_TRACE_STEPS`` steps under the profiler (CPU and CUDA activities, with
Python stacks); the Chrome trace goes to ``--outdir``. Each row of the table is
one kernel name: its device time per step, its launches per step, the name cut
to 60 characters, and its source: the innermost frame of the port on the
Python stack that launched it, as ``path:line`` as the profiler records it (the
line of the call, or of the function's ``def`` where the profiler names Python
functions by their first line). A kernel launched from the backward takes the
source of the forward operation its autograd node came from.
On the CPU (``--device cpu``) there is no device time: the table ranks the
operators' self CPU time and says so. ``--no-adaptive`` of the JAX tool has no
counterpart (the CUDA warp has no adaptive window) and is refused.

Usage:
  python tools/trace_step_torch.py [--family NAME] [--scales N] [--batch B] [--top N] [--outdir DIR]
"""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from tools.bench_models_torch import CASES, build_step, flagship_batch, flagship_cfg, make_case  # noqa: E402

# Number of steps captured inside the profiler trace; also the divisor that
# turns the trace's total self time into ms/step.
N_TRACE_STEPS = 3
WARM_STEPS = 3
PORT_LINE = re.compile(r"simpledepthestimation_tpu_torch/([\w/]+\.py)\((\d+)\)")
NO_ADAPTIVE = ("--no-adaptive has no counterpart in the port: it narrows the TPU warp's adaptive window, and the "
               "CUDA warp gathers directly, with no window to choose")


def _port_line(names):
    """The first entry of ``names`` ("file(line): function" strings) inside the port, as "path:line"."""
    for entry in names:
        m = PORT_LINE.search(entry)
        if m:
            return f"{m.group(1)}:{m.group(2)}"
    return ""


def _is_runtime(e) -> bool:
    """A CPU event of a call into the CUDA runtime (``cudaLaunchKernel``, ``cuLaunchKernel``, ...)."""
    return e.name.startswith(("cuda", "cu"))


def _is_operator(e) -> bool:
    """A CPU event that is an operator: not a Python function of the stack
    tracer, not a user range (the optimizer's, the profiler's steps) and not a
    call into the CUDA runtime."""
    return not (getattr(e, "is_python_function", False) or getattr(e, "is_user_annotation", False)
                or e.name.startswith(("Optimizer.", "ProfilerStep")) or _is_runtime(e))


def source_lines(events):
    """``source(event) -> "path:line"``: the innermost frame inside the port
    on the Python stack of the operator that ``event`` is (a CPU event) or that
    launched it (a device event), from the operators' recorded stacks or the
    Python function events of the stack tracer, whichever the profiler gives;
    an event of the backward takes the line of the forward operator that made
    its autograd node (same sequence number), wherever the backward ran.

    A kernel names the operator around its launch by ``linked_correlation_id``.
    A kernel launched outside any operator (the port's own kernels, through
    ctypes, outside an autograd ``Function``) has none: its runtime call (same
    correlation id) is placed in time inside the shortest port function then
    running. The runtime's thread ids are not the profiler's, so this is done by
    time alone."""
    cpu = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    ops, runtime = {}, {}
    for e in cpu:
        if _is_runtime(e):
            runtime.setdefault(e.id, e)
        elif not getattr(e, "is_python_function", False):
            ops.setdefault(e.id, e)
    memo = {}

    def own_line(e):
        """The first port line up the chain of enclosing events."""
        chain, line = [], ""
        while e is not None:
            if id(e) in memo:
                line = memo[id(e)]
                break
            chain.append(e)
            line = _port_line(e.stack or ()) or _port_line([e.name])
            if line:
                break
            e = e.cpu_parent
        for c in chain:
            memo[id(c)] = line
        return line

    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and e.sequence_nr not in forward and not _is_runtime(e):
            line = own_line(e)
            if line:
                forward[e.sequence_nr] = line
    running = [(e.time_range.start, e.time_range.end, _port_line([e.name])) for e in cpu
               if getattr(e, "is_python_function", False) and _port_line([e.name])]

    def by_time(t):
        inside = [(end - start, line) for start, end, line in running if start <= t <= end]
        return min(inside)[1] if inside else ""

    def source(event):
        e = event
        if e.device_type != torch.autograd.DeviceType.CPU:
            e = ops.get(getattr(e, "linked_correlation_id", 0))
            if e is None:
                launch = runtime.get(event.id)
                return (own_line(launch) or by_time(launch.time_range.start)) if launch is not None else ""
        x = e
        while x is not None:
            if x.name.startswith("autograd::engine::evaluate_function") and x.sequence_nr in forward:
                return forward[x.sequence_nr]
            x = x.cpu_parent
        return own_line(e)

    return source


def op_table(prof, device_type: str, steps: int = N_TRACE_STEPS, tries: int = 8):
    """Rows ``(ms_per_step, launches_per_step, name, source)`` of every device
    kernel (``device_type`` "cuda": self device time) or every CPU operator
    ("cpu": self CPU time), grouped by name, largest first. The source of a
    name is the one that carries most of the time of its ``tries`` longest
    instances, preferring one inside the port."""
    events = prof.events()
    source = source_lines(events)
    rows = {}
    for e in events:
        if device_type == "cuda":
            if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                    or e.name.startswith(("Optimizer.", "ProfilerStep")):
                continue
            us = e.time_range.elapsed_us()
        else:
            if e.device_type != torch.autograd.DeviceType.CPU or not _is_operator(e):
                continue
            us = e.self_cpu_time_total
        rows.setdefault(e.name, []).append((us, e))
    table = []
    for name, instances in rows.items():
        lines = {}
        for us, e in sorted(instances, key=lambda r: -r[0])[:tries]:
            line = source(e)
            lines[line] = lines.get(line, 0.0) + us
        line = max(lines, key=lambda k: (bool(k), lines[k]))
        total = sum(us for us, _ in instances)
        table.append((total / 1e3 / steps, len(instances) / steps, name, line))
    return sorted(table, key=lambda r: -r[0])


def format_table(table, top: int, device_type: str, steps: int = N_TRACE_STEPS):
    """The printed table: the ``top`` rows and a TOTAL line over every row."""
    what = "device self time" if device_type == "cuda" else "self CPU time (no device: CPU operators)"
    lines = [f"ranked by {what} per step, over {steps} traced steps",
             f"{'ms/step':>9}  {'launches':>8}  {'kernel' if device_type == 'cuda' else 'operator':60} source"]
    for ms, n, name, src in table[:top]:
        lines.append(f"{ms:9.3f}  {n:8.1f}  {name[:60]:60} {src}")
    total = sum(r[0] for r in table)
    lines.append(f"{total:9.3f}  {sum(r[1] for r in table):8.1f}  TOTAL {what} per step")
    return "\n".join(lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--outdir", default="torch_trace")
    p.add_argument("--scales", type=int, default=0)
    p.add_argument("--batch", type=int, default=0)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--family", default="", help="bench_models_torch CASES family (prefix); default the flagship")
    p.add_argument("--no-adaptive", action="store_true", help="refused: no counterpart in the port")
    p.add_argument("--device", default="cuda", help="torch device to run on (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv=None, warm_steps=WARM_STEPS, n_steps=N_TRACE_STEPS):
    """Trace the step and print the table; returns ``{"table": every row,
    "trace": path of the Chrome trace, "device_type": "cuda" or "cpu"}``."""
    from torch.profiler import ProfilerActivity, profile

    from simpledepthestimation_tpu_torch.models.build import resolve_device

    args = parse_args(argv)
    if args.no_adaptive:
        raise SystemExit(f"trace_step_torch: {NO_ADAPTIVE}")
    device = resolve_device(args.device)
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    if args.family:
        case = next((c for c in CASES if c[0].lower().startswith(args.family.lower())), None)
        if case is None:
            raise SystemExit(f"trace_step_torch: no family {args.family!r} in {[c[0] for c in CASES]}")
        name, meta, dn, pose, B, H, W, case_opts = case
        B = args.batch or B
        cfg, batch = make_case(meta, dn, pose, B, H, W, case_opts, device=device)
    else:
        name, B, H, W = "MonoDepth2-R18 (flagship)", args.batch or 16, 192, 640
        cfg = flagship_cfg(dtype)
        if args.scales:
            cfg.LOSS.NUM_SCALES = args.scales
        batch = flagship_batch(B, H, W, device=device)
    print(f"tracing {name} B={B} {H}x{W} on {device.type}", flush=True)
    _, step = build_step(cfg, device)

    for _ in range(warm_steps):
        m = step(batch)
    float(m["total_loss"])

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    # verbose: the Python stacks reach the operators' events (torch 2.11 leaves them out without it)
    with profile(activities=activities, with_stack=True,
                 experimental_config=torch.profiler._ExperimentalConfig(verbose=True)) as prof:
        for _ in range(n_steps):
            m = step(batch)
        float(m["total_loss"])

    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "trace.json.gz")
    prof.export_chrome_trace(path)
    print("chrome trace:", path, flush=True)
    table = op_table(prof, device.type, n_steps)
    print(format_table(table, args.top, device.type, n_steps), flush=True)
    return {"table": table, "trace": path, "device_type": device.type}


if __name__ == "__main__":
    main()
