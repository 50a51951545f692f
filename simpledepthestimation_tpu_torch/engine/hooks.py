"""Hook library.

The port's counterpart of ``simpledepthestimation_tpu/engine/hooks.py``, in
its order: ``CallbackHook``, ``IterationTimer`` (step time without the other
hooks' work, after a warm-up), ``PeriodicWriter``, ``LRSchedulerHook`` (logs
the rate of the schedule), ``PeriodicCheckpointerHook``, ``PreciseBN``
(true-average BatchNorm statistics, :func:`..parallel.compute_precise_bn_stats`),
``EvalHook`` (every N epochs and after training), and ``TorchProfiler`` in the
place of ``JaxProfiler``: a ``torch.profiler`` Chrome trace of each selected
iteration.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import Callable

import torch

from ..parallel.train_step import compute_precise_bn_stats
from ..utils import comm
from ..utils.events import write_all
from .train_loop import HookBase

logger = logging.getLogger(__name__)


class CallbackHook(HookBase):
    def __init__(self, *, before_train=None, after_train=None, before_step=None, after_step=None):
        self._before_train = before_train
        self._after_train = after_train
        self._before_step = before_step
        self._after_step = after_step

    def before_train(self):
        if self._before_train:
            self._before_train(self.trainer)

    def after_train(self):
        if self._after_train:
            self._after_train(self.trainer)

    def before_step(self):
        if self._before_step:
            self._before_step(self.trainer)

    def after_step(self):
        if self._after_step:
            self._after_step(self.trainer)


class IterationTimer(HookBase):
    """Per-step wall time without the other hooks' overhead, the first
    ``warmup_iter`` steps left out, and a summary at the end."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()
        self._total_timer_sum = 0.0
        self._step_timer = 0.0

    def before_train(self):
        self._start_time = time.perf_counter()
        self._total_timer_sum = 0.0

    def after_train(self):
        total_time = time.perf_counter() - self._start_time
        num_iter = self.trainer.iter + 1 - self.trainer.start_iter - self._warmup_iter
        if num_iter > 0 and self._total_timer_sum > 0:
            logger.info(
                "Overall training speed: {} iterations in {} ({:.4f} s / it)".format(
                    num_iter,
                    str(datetime.timedelta(seconds=int(self._total_timer_sum))),
                    self._total_timer_sum / num_iter,
                )
            )
        logger.info("Total training time: {}".format(str(datetime.timedelta(seconds=int(total_time)))))

    def before_step(self):
        self._step_timer = time.perf_counter()

    def after_step(self):
        sec = time.perf_counter() - self._step_timer
        iter_done = self.trainer.iter - self.trainer.start_iter + 1
        if iter_done > self._warmup_iter:
            self._total_timer_sum += sec
            self.trainer.storage.put_scalars(time=sec)


class PeriodicWriter(HookBase):
    """Read the pending metrics and write every ``period`` steps and after the
    last (a write round, :func:`..utils.events.write_all`)."""

    def __init__(self, writers, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or (self.trainer.iter == self.trainer.max_iter - 1):
            if hasattr(self.trainer, "drain_all"):
                self.trainer.drain_all()
            write_all(self._writers)

    def after_train(self):
        write_all(self._writers)
        for writer in self._writers:
            writer.close()


class LRSchedulerHook(HookBase):
    """Log the rate of a schedule function of the step (the first group's,
    ``state.scheduler.schedules[0]``)."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def after_step(self):
        lr = float(self._schedule(self.trainer.iter))
        self.trainer.storage.put_scalar("lr", lr, smoothing_hint=False)


class PeriodicCheckpointerHook(HookBase):
    """Epoch-period checkpoints, driven from the iteration count."""

    def __init__(self, periodic_checkpointer, steps_per_epoch: int):
        self._pc = periodic_checkpointer
        self._steps_per_epoch = max(steps_per_epoch, 1)

    def after_step(self):
        it = self.trainer.iter + 1
        if it % self._steps_per_epoch == 0:
            epoch = it // self._steps_per_epoch - 1
            self._pc.step(epoch, self.trainer.state)


class PreciseBN(HookBase):
    """Recompute true-average BatchNorm statistics over ``num_iter`` train
    batches on the evaluation's schedule (and after the last step), so that
    evaluation and the epoch's checkpoint use exact, not running-average,
    statistics. Registered before the checkpointer and ``EvalHook``.

    The batches come from a fresh pass over ``loader`` (the epoch that just
    ended), moved to ``device``. One process only: the JAX package averages
    the statistics over processes, which the port cannot run yet."""

    def __init__(self, period_epochs: int, steps_per_epoch: int, loader, num_iter: int, device: torch.device):
        if comm.get_world_size() > 1:
            raise NotImplementedError("PreciseBN over several processes is not ported yet: ROADMAP.md A17")
        self._period = period_epochs
        self._steps_per_epoch = max(steps_per_epoch, 1)
        self._loader = loader
        self._num_iter = num_iter
        self._device = device
        self._disabled = False

    def _update_stats(self):
        if self._disabled:
            return
        logger.info(f"PreciseBN: recomputing statistics over {self._num_iter} batches")
        source = iter(self._loader)  # one host batch in flight at a time
        try:
            batches = ({k: v.to(self._device) for k, v in b.items() if isinstance(v, torch.Tensor)}
                       for _, b in zip(range(self._num_iter), source))
            n = compute_precise_bn_stats(self.trainer.state, batches)
        finally:
            source.close()
        if n == 0:
            logger.info("PreciseBN: the model has no BatchNorm; hook disabled")
            self._disabled = True

    def after_step(self):
        if self._period <= 0:
            return
        it = self.trainer.iter + 1
        if it == self.trainer.max_iter or it % (self._period * self._steps_per_epoch) == 0:
            self._update_stats()


class EvalHook(HookBase):
    """Run ``eval_fn`` every ``eval_period_epochs`` epochs and after training;
    its results go into the storage at the current iteration."""

    def __init__(self, eval_period_epochs: int, steps_per_epoch: int, eval_fn: Callable):
        self._period = eval_period_epochs
        self._steps_per_epoch = max(steps_per_epoch, 1)
        self._eval_fn = eval_fn

    def _do_eval(self):
        results = self._eval_fn()
        flat = {f"{task}/{k}": float(v) for task, metrics in (results or {}).items()
                if isinstance(metrics, dict) for k, v in metrics.items()}
        if flat:
            self.trainer.storage.put_scalars(**flat, smoothing_hint=False)
        comm.synchronize()

    def after_step(self):
        if self._period <= 0:
            return
        it = self.trainer.iter + 1
        if it % (self._period * self._steps_per_epoch) == 0 and it != self.trainer.max_iter:
            self._do_eval()

    def after_train(self):
        if self._period > 0 and self.trainer.iter == self.trainer.max_iter:
            self._do_eval()


class TorchProfiler(HookBase):
    """A ``torch.profiler`` trace (CPU and, on the card, CUDA activity) of each
    iteration that ``enable_predicate(trainer)`` selects, written as a Chrome
    trace to ``output_dir/profiler-trace-iter{N}/trace.json`` (Perfetto or
    ``chrome://tracing`` reads it). The step's device work is waited for
    before the trace stops."""

    def __init__(self, enable_predicate: Callable[["HookBase"], bool], output_dir: str, device: torch.device):
        self._enable_predicate = enable_predicate
        self._output_dir = output_dir
        self._device = device
        self._profiler = None

    def before_step(self):
        if self._enable_predicate(self.trainer):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()

    def after_step(self):
        if self._profiler is None:
            return
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._profiler.__exit__(None, None, None)
        trace_dir = os.path.join(self._output_dir, f"profiler-trace-iter{self.trainer.iter}")
        os.makedirs(trace_dir, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        self._profiler = None
        logger.info(f"Saved profiler trace for iteration {self.trainer.iter} to {trace_dir}")

    def after_train(self):
        if self._profiler is not None:  # the selected step raised
            self._profiler.__exit__(None, None, None)
            self._profiler = None
