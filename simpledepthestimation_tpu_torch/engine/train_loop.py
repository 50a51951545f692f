"""Hook protocol and trainer loop.

The port's counterpart of ``simpledepthestimation_tpu/engine/train_loop.py``:
``HookBase`` (before/after train and step, with a weak back-pointer to the
trainer), ``TrainerBase`` (the iteration loop inside an ``EventStorage``) and
``SimpleTrainer`` (one train step an iteration). The step returns 0-d device
tensors; they are read back at most ``metric_lag`` steps late, all of one
step in one read, as ``engine.runtime.do_train`` does, so the host does not
wait for the card every step. A non-finite loss raises ``FloatingPointError``
once the steps still pending have been read and written.
"""

from __future__ import annotations

import logging
import math
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from ..utils.events import EventStorage, get_event_storage

logger = logging.getLogger(__name__)


class HookBase:
    """before_train / after_train / before_step / after_step, each a no-op
    until a hook overrides it; ``trainer`` is set by ``register_hooks``."""

    trainer: "TrainerBase" = None

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class TrainerBase:
    def __init__(self):
        self._hooks: List[HookBase] = []
        self.iter: int = 0
        self.start_iter: int = 0
        self.max_iter: int = 0
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks) -> None:
        hooks = [h for h in hooks if h is not None]
        for h in hooks:
            assert isinstance(h, HookBase)
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    def train(self, start_iter: int, max_iter: int) -> None:
        logger.info(f"Starting training from iteration {start_iter}")
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter

        with EventStorage(start_iter) as self.storage:
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    self.before_step()
                    self.run_step()
                    self.after_step()
                self.iter += 1
            except Exception:
                logger.exception("Exception during training:")
                raise
            finally:
                self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        self.storage.iter = self.iter
        for h in self._hooks:
            h.before_step()

    def after_step(self):
        for h in self._hooks:
            h.after_step()

    def run_step(self):
        raise NotImplementedError


class SimpleTrainer(TrainerBase):
    """One train step an iteration.

    ``train_step_fn(batch, it) -> metrics`` updates ``state`` in place and
    returns its metrics as 0-d device tensors (``total_loss`` among them);
    ``data_iter`` yields the batches on the step's device. This loop owns the
    data fetch, the deferred read of the metrics and the finite-loss check."""

    def __init__(
        self,
        train_step_fn: Callable[[Dict[str, torch.Tensor], int], Dict[str, torch.Tensor]],
        data_iter,
        state,
        metric_lag: int = 8,
    ):
        super().__init__()
        self.train_step_fn = train_step_fn
        self._data_iter = iter(data_iter)
        self.state = state
        self._metric_lag = metric_lag
        self._pending: deque = deque()

    def run_step(self):
        start = time.perf_counter()
        batch = next(self._data_iter)
        data_time = time.perf_counter() - start

        metrics = self.train_step_fn(batch, self.iter)
        self._pending.append((self.iter, data_time, metrics))
        if len(self._pending) > self._metric_lag:
            self._drain_one()

    def _drain_one(self):
        it, data_time, metrics = self._pending.popleft()
        values = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))  # one read
        total = values.get("total_loss", 0.0)
        if not math.isfinite(total):
            error = FloatingPointError(f"Loss became infinite or NaN at iteration={it}! metrics={values}")
            try:
                self.drain_all()
            except FloatingPointError:
                pass  # a later step's loss is not finite either; the first one is reported
            raise error
        storage = get_event_storage()
        storage.iter = it
        storage.put_scalar("data_time", data_time)
        for k, v in values.items():
            storage.put_scalar(k, v)
        storage.iter = self.iter

    def drain_all(self):
        while self._pending:
            self._drain_one()

    def after_train(self):
        self.drain_all()
        super().after_train()
