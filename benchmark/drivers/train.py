"""Training cells: the port's train step in a closed loop, fed as ``do_train`` feeds it.

Set-up: the configuration as the port reads it, a pool of distinct seeded
batches in page-locked host memory, weights made on the device from the seed
and loaded by name into the port's model, which ``parallel.create_train_state``
turns into the train state, and ``parallel.make_train_step(state)``. The
batches reach the step through ``engine.runtime.device_prefetch`` (two ahead,
copied on its side stream). The first three steps go through that feed and
call on the pool's first three batches and are read for the comparison with
the reference (``core.check``); further warm-up steps follow.

The window: steps in a closed loop for ``seconds``, nothing waiting for the
card inside it; a CUDA event after each step on the compute stream; one
synchronise closes it. With ``trace``, a profiled stretch of steps follows the
window, and the per-layer metrics are read from both. Once the program's state
is freed the reference follows the first three steps and the numbers are
compared with their limits.
"""

from __future__ import annotations

import gc
import itertools
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from core import check
from core import trace as tracing
from core.weights import load_into, seeded_weights
from reference import monodepth2 as reference
from traffic import generator as traffic

CHECKED_STEPS = 3
POSE_HEAD = "pose_net.pose_pred"  # the pose net's 1x1 head: 6 outputs a context, (t, r), times 0.01
POSE_OUTPUT_SCALE = 0.01
POSE_KERNEL_SCALE = 0.1


@dataclass
class Run:
    """What the per-layer metrics' readers get (``metrics/<name>.py``)."""

    config: Dict
    mix: Dict
    images_per_s: float
    enqueue_ms: List[float]
    h2d_ms: List[float]
    trace: Optional[tracing.Trace] = None  # the card alone, ``traced_steps`` steps
    traced_steps: int = 0
    host_trace: Optional[tracing.Trace] = None  # host and card, ``host_traced_steps`` steps
    host_traced_steps: int = 0


def port_cfg(config: Dict):
    from simpledepthestimation_tpu_torch.config import get_cfg
    from simpledepthestimation_tpu_torch.config.config import CfgNode

    cfg = get_cfg()
    cfg.merge_from_other(CfgNode(config["cfg"]))
    return cfg


def build_program(cfg, weights: Dict[str, torch.Tensor], device, steps_per_epoch: int):
    """The port's train state with ``weights`` and its train step."""
    import simpledepthestimation_tpu_torch.models  # noqa: F401  (registers the architectures)
    from simpledepthestimation_tpu_torch.models.build import META_ARCH_REGISTRY
    from simpledepthestimation_tpu_torch.parallel import create_train_state, make_train_step

    with torch.device(device):
        model = META_ARCH_REGISTRY.get(cfg.MODEL.META_ARCHITECTURE).from_cfg(cfg)
    load_into(model, weights)
    state = create_train_state(cfg, device=device, steps_per_epoch=steps_per_epoch, model=model, warm_start=False)
    step = make_train_step(state, grad_clip=float(cfg.SOLVER.GRAD_CLIP), remat=bool(cfg.TPU.REMAT))
    return state, step


def pose_head_start(mix: Dict) -> Dict:
    """The pose head started at the mix's camera motion: each context's
    rotation about the vertical axis at its pan (shift / fx, in radians for
    small angles), over the head's output scale, in its bias; its seeded
    kernel scaled down, so that each sample's pose varies a little about that
    start."""
    bias = [0.0] * (6 * mix["contexts"])
    for j, shift in enumerate(traffic.context_shifts(mix)):
        bias[6 * j + 4] = shift / (mix["intrinsics"]["fx"] * mix["width"]) / POSE_OUTPUT_SCALE
    return {"scale": {f"{POSE_HEAD}.weight": POSE_KERNEL_SCALE}, "set": {f"{POSE_HEAD}.bias": bias}}


def start_weights(shapes, seed: int, device, mix: Dict) -> Dict[str, torch.Tensor]:
    """The weights both sides start from: seeded, with the pose head's start."""
    return seeded_weights(shapes, seed, device, pose_head_start(mix))


def reference_shapes(config: Dict):
    with torch.device("meta"):
        return [(n, p.shape) for n, p in reference.build(config["cfg"]).named_parameters()]


def first_moment_norms(state) -> Dict[str, float]:
    """Each parameter's gradient as Adam got it in its first step: the first
    moment over 1 − β1 (zero where the optimizer holds none)."""
    out = {}
    for group in state.optimizer.param_groups:
        beta1 = group["betas"][0]
        names = {id(p): n for n, p in state.model.named_parameters()}
        for p in group["params"]:
            m = state.optimizer.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = torch.zeros((), device=p.device) if m is None else m.norm() / (1 - beta1)
    return dict(zip(out, torch.stack(list(out.values())).tolist()))


class Clock:
    """Per-step end times: CUDA events on the compute stream on the card, the
    host clock elsewhere (a CPU rehearsal)."""

    def __init__(self, cuda: bool):
        self.cuda, self.marks = cuda, []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def checked_steps(state, step, feed, weights: Dict[str, torch.Tensor]) -> Dict:
    """Drive ``step`` through its first steps on the feed's first batches and
    read what the comparison needs: each step's loss, the first gradient's
    norm by parameter, and each parameter's change from ``weights``."""
    losses, first_grads = [], None
    for k in range(CHECKED_STEPS):
        batch, _ = next(feed)
        losses.append(step(batch)["total_loss"])
        if k == 0:
            first_grads = first_moment_norms(state)
    params = dict(state.model.named_parameters())
    change = check.leaf_norms({n: params[n].detach() - weights[n] for n in weights})
    return {"losses": torch.stack(losses).tolist(), "first_grads": first_grads, "change": change}


def reference_readings(config: Dict, mix: Dict, pool, shapes, seed: int, device) -> Dict:
    """The plain reference's readings of the same steps, from the seed's
    weights and the pool's first batches, in float32 with TF32 off."""
    ref = reference.build(config["cfg"]).to(device)
    load_into(ref, start_weights(shapes, seed, device, mix))
    batches = [{k: v.to(device) for k, v in pool[i].items()} for i in range(CHECKED_STEPS)]
    with reference.full_float32():
        out = reference.train(ref, batches, config["cfg"]["SOLVER"])
    return {"losses": out["losses"], "first_grads": check.leaf_norms(out["first_grads"]),
            "change": check.leaf_norms(out["change"])}


def free_device(cuda: bool) -> None:
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def run(config: Dict, mix: Dict, seed: int, seconds: float, trace: bool, device, t0: float,
        limits: Dict[str, float], build: Callable = build_program) -> Dict:
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from simpledepthestimation_tpu_torch.engine.runtime import device_prefetch

    # ---- set-up
    cfg = port_cfg(config)
    B = mix["batch"]
    if mix["pool"] < CHECKED_STEPS:
        raise ValueError("the pool needs a distinct batch for each checked step")
    pool = traffic.make_pool(mix, seed, device)
    shapes = reference_shapes(config)
    weights = start_weights(shapes, seed, device, mix)
    state, step = build(cfg, weights, device, traffic.steps_per_epoch(mix))
    feed = device_prefetch(itertools.cycle(pool), torch.device(device))

    program = checked_steps(state, step, feed, weights)
    del weights
    for _ in range(mix["warmup_steps"]):
        step(next(feed)[0])
    sync()
    setup_s = time.perf_counter() - t0

    # ---- the window
    clock, copies, enqueue, window_losses = Clock(cuda), [], [], []
    clock.mark()
    t_start = time.perf_counter()
    while not window_losses or time.perf_counter() - t_start < seconds:
        batch, copy = next(feed)
        t = time.perf_counter()
        metrics = step(batch)
        enqueue.append(time.perf_counter() - t)
        clock.mark()
        copies.append(copy)
        window_losses.append(metrics["total_loss"])
    sync()
    window_s = time.perf_counter() - t_start
    steps = len(window_losses)
    step_ms = clock.intervals_ms()
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    p95 = statistics.quantiles(step_ms, n=20, method="inclusive")[18] if steps > 1 else step_ms[0]
    e2e = {"train_images_per_s": steps * B / window_s, "train_step_ms_p95": p95, "setup_s": setup_s}
    notes = [f"train_step_ms median {statistics.median(step_ms)} p95 {p95} steps {steps}",
             f"window_s {window_s} images {steps * B} enqueue_ms mean {statistics.fmean(enqueue) * 1e3}"]

    measured = None
    if trace:
        h2d = [c[0].elapsed_time(c[1]) for c in copies if c is not None]
        measured = Run(config=config, mix=mix, images_per_s=e2e["train_images_per_s"],
                       enqueue_ms=[e * 1e3 for e in enqueue], h2d_ms=h2d)
        n, m = mix["trace_steps"], mix["host_trace_steps"]
        measured.trace = tracing.record_device(lambda: [step(next(feed)[0]) for _ in range(n)], sync)
        measured.host_trace = tracing.record_host(lambda: [step(next(feed)[0]) for _ in range(m)], sync)
        measured.traced_steps, measured.host_traced_steps = n, m
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- the program's state freed, the reference follows the checked steps
    del state, step, feed, metrics, batch, window_losses, copies
    free_device(cuda)
    values = check.readings(program, reference_readings(config, mix, pool, shapes, seed, device))
    values["nonfinite_steps"] = failed
    return {
        "attempted": steps, "failed": failed, "end_to_end": e2e, "run": measured, "memory_peak_bytes": peak,
        "check": {k: values[k] for k in limits}, "readings": values,
        "correct": check.judge(values, limits),
        "notes": notes,
    }
